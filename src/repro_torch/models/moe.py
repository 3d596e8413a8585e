"""Token-choice top-k MoE with capacity, dispatched by sort and gather (the
reference's ``models/moe.py``).

The dispatch plan is integer work (a stable cumulative count per expert,
no (tokens x E x C) one-hot matmul), so the expert FLOPs are the only
matmul FLOPs.  Assignments over an expert's capacity are dropped (GShard
semantics: the residual carries the token); the gates of the kept
assignments are renormalized over the chosen experts before the drop, as
in the reference.  The capacity depends on the batch, so a token's drops
do too.

On a mesh (one process a rank, each holding its rows of the batch), two
forms:

* ``moe_apply(mesh=)``, the reference's GSPMD step: the capacity and every
  queue position are those of the global batch.  The ranks all-gather
  their per-expert assignment counts (E integers a rank) over the batch
  axes; a rank's queue positions start after the assignments of the ranks
  before it (the global, batch-major order), and ``C = S·k·cf/E`` counts
  all ``S`` tokens.  Calling the plain function on a rank's rows would drop
  other assignments.
* ``moe_apply_ep``, expert parallelism: one expert a "data" shard, tokens
  routed with all-to-all, capacity per (source shard, expert), the
  expert's ``ff`` split over "model" with a sum over the model group.

Both return the rank's *share* of the aux loss: its sum over the batch
axes is the reference's aux loss, and so is the sum of its gradients.
With ``tp`` (``parallel/tp.py``) each rank holds its ``ff`` slice of the
experts and computes on it: the dispatched tokens enter the slice, the
partial outputs are summed over the model group; the router and the
dispatch run whole on every rank of the group.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import MoESpec
from ..parallel import tp as TPx
from . import layers as L
from .mlp import gelu

__all__ = ["moe_init", "moe_apply", "moe_apply_ep", "batch_axes", "record_drops", "top_k"]

_DROPS: Optional[list] = None


@contextlib.contextmanager
def record_drops():
    """Yields a list that collects, for each MoE call while the context is
    open, this rank's dropped assignments (a 0-d tensor; an activation
    recomputed for the backward calls again)."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _note_drops(kept: torch.Tensor) -> None:
    if _DROPS is not None:
        _DROPS.append((~kept).sum())


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, spec: MoESpec, mlp_kind: str, dtype=torch.float32):
    E = spec.num_experts
    p = {
        "router": L.linear_init(gen, d_model, E, torch.float32, bias=False),
        "up": {"w": L.lecun_init(gen, (E, d_model, d_ff), d_model, dtype)},
        "down": {"w": L.lecun_init(gen, (E, d_ff, d_model), d_ff, dtype)},
    }
    if mlp_kind in ("swiglu", "geglu"):
        p["gate"] = {"w": L.lecun_init(gen, (E, d_model, d_ff), d_model, dtype)}
    return p


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis, ties
    to the lower index (``jax.lax.top_k``'s order; a stable descending
    sort keeps it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, xf: torch.Tensor, spec: MoESpec):
    """(probs (S, E), renormalized gates (S, k), flat expert ids (S*k,),
    each assignment's place in its expert's queue among these tokens)."""
    E, k = spec.num_experts, spec.top_k
    probs = torch.softmax(L.linear(p["router"], xf.float()), dim=-1)  # (S, E)
    gate_vals, expert_ids = top_k(probs, k)  # (S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)  # renorm
    flat_expert = expert_ids.reshape(-1)  # (S*k,) assignment -> expert
    onehot = F.one_hot(flat_expert, E)  # (S*k, E)
    # each assignment's place in its expert's queue, in assignment order (integer work)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1, flat_expert[:, None]).squeeze(-1)
    return probs, gate_vals, flat_expert, pos


def _dispatch(xf, flat_expert, pos, kept, E: int, C: int, k: int):
    """Each expert's (C, D) rows of tokens from its kept assignments (zeros
    where a queue is short) and each assignment's slot (E*C for a drop)."""
    S, D = xf.shape
    slot = torch.where(kept, flat_expert * C + pos, E * C)  # dummy slot E*C
    token_idx = torch.arange(S, device=xf.device).repeat_interleave(k)
    src = torch.full((E * C + 1,), S, dtype=torch.long, device=xf.device)
    src[slot] = token_idx  # the dummy row absorbs the drops
    x_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    return x_pad[src[: E * C]], slot, token_idx


def _combine(y, slot, kept, gate_vals, token_idx, S: int):
    """The tokens' outputs from the experts' (E*C, D) rows: each kept
    assignment's row times its gate, summed a token; drops add nothing."""
    D = y.shape[-1]
    y_flat = torch.cat([y, y.new_zeros((1, D))], dim=0)
    per_assign = y_flat[slot]  # (S*k, D); drops -> zeros
    w_assign = torch.where(kept, gate_vals.reshape(-1), 0.0).to(per_assign.dtype)
    return per_assign.new_zeros((S, D)).index_add(0, token_idx, per_assign * w_assign[:, None])


def _expert_ffn(h_in, up_w, gate_w, down_w, mlp_kind: str, eq_in: str, eq_out: str, tp=None):
    """The experts' FFN of their dispatched tokens; with ``tp`` on this
    rank's ``ff`` slice, the outputs summed over the group."""
    h_in = TPx.enter(h_in, tp)
    act = F.silu if mlp_kind == "swiglu" else gelu
    up = torch.einsum(eq_in, h_in, up_w)
    h = act(torch.einsum(eq_in, h_in, gate_w)) * up if mlp_kind in ("swiglu", "geglu") else act(up)
    return TPx.row_parallel(h, down_w, tp, eq_out)


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes ("pod", "data"), major to minor: the axes a
    batch's rows split over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def moe_apply(p, x: torch.Tensor, spec: MoESpec, mlp_kind: str, *, mesh=None, tp=None):
    """x (B, T, D) -> ((B, T, D), aux loss).  Capacity-dropped assignments
    add nothing.  With ``mesh``, x is this rank's rows of a batch split over
    the mesh's batch axes ("pod", "data"), in their row-major order: the
    capacity, the drops and the aux loss are the global batch's, and the aux
    loss returned is this rank's share of it (see the module docstring).
    With ``tp`` the experts' weights are this rank's ``ff`` slice."""
    B, T, D = x.shape
    E, k = spec.num_experts, spec.top_k
    S = B * T
    xf = x.reshape(S, D)
    probs, gate_vals, flat_expert, pos = _route(p, xf, spec)
    axes = batch_axes(mesh) if mesh is not None else ()
    n = mesh.extent(axes) if axes else 1
    if n == 1:
        C = max(1, int(S * k * spec.capacity_factor / E))
        kept = pos < C
        aux = _aux_loss(probs, flat_expert, E, k)
    else:
        counts = _expert_counts(flat_expert, E)  # (E,) this rank's assignments an expert
        every = [torch.empty_like(counts) for _ in range(n)]
        dist.all_gather(every, counts, group=mesh.group(axes))
        every = torch.stack(every)  # (n, E), in the batch's row-major order
        S_glob = S * n
        C = max(1, int(S_glob * k * spec.capacity_factor / E))
        offset = every[: mesh.index(axes)].sum(0)  # the assignments of the ranks before this one
        kept = pos + offset[flat_expert] < C
        frac_tokens = every.sum(0).float() / (S_glob * k)
        aux = E * torch.sum(frac_tokens * probs.sum(0) / S_glob)
    _note_drops(kept)
    dispatched, slot, token_idx = _dispatch(xf, flat_expert, pos, kept, E, C, k)
    y = _expert_ffn(dispatched.reshape(E, C, D), p["up"]["w"], p.get("gate", {}).get("w"), p["down"]["w"],
                    mlp_kind, "ecd,edf->ecf", "ecf,efd->ecd", tp)  # (E, C, D)
    out = _combine(y.reshape(E * C, D), slot, kept, gate_vals, token_idx, S)
    return out.reshape(B, T, D).to(x.dtype), aux


def _expert_counts(flat_expert: torch.Tensor, E: int) -> torch.Tensor:
    """``bincount(flat_expert, minlength=E)`` (the ids lie in [0, E)) as a
    scatter-add: the same int64 counts in a shape that does not depend on
    the data, so the dry run can trace it."""
    return torch.zeros(E, dtype=torch.int64, device=flat_expert.device).scatter_add_(
        0, flat_expert.long(), torch.ones_like(flat_expert, dtype=torch.int64))


def _aux_loss(probs: torch.Tensor, flat_expert: torch.Tensor, E: int, k: int):
    """Switch-style load-balancing auxiliary loss."""
    S = probs.shape[0]
    frac_tokens = _expert_counts(flat_expert, E).float() / (S * k)
    frac_probs = probs.mean(0)
    return E * torch.sum(frac_tokens * frac_probs)


# ----------------------------------------------------------- EP (all-to-all)
def _exchange(x: torch.Tensor, group, stage: bool) -> torch.Tensor:
    """``all_to_all_single`` with equal splits: chunk j of dim 0 goes to the
    group's rank j, chunk j of the result came from it.  ``stage``: through
    host memory (the gloo transport of CUDA tensors)."""
    src = x.detach().cpu() if stage else x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if stage else out


class _AllToAll(torch.autograd.Function):
    """The exchange with its gradient: the same exchange of the cotangents
    (with equal splits it is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group, stage):
        ctx.group, ctx.stage = group, stage
        return _exchange(x, group, stage)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.stage), None, None


def moe_apply_ep(p, x: torch.Tensor, spec: MoESpec, mlp_kind: str, *, mesh, tp=None):
    """Expert-parallel MoE (the reference's ``moe_apply_ep``): x (B_l, T, D)
    is this rank's rows of a batch split over ("pod", "data"); expert e
    lives on the "data" shard e, and tokens reach it by all-to-all and
    return the same way.  Capacity is per (source shard, expert): C =
    S_loc·k·cf/E; overflow drops, the residual carries the token.

    ``p`` holds this rank's blocks under ``lm_param_specs``: the router
    whole, and of the expert weights its expert alone (E / |data| = 1 on
    the leading dimension: (1, D, ff) / (1, ff, D)), with ``tp`` its
    ``ff`` slice (the experts' ``ff`` split over "model": the tokens enter
    the slice and the partial outputs are summed over the model group).
    Requires E == the "data" extent.  Returns (out, this rank's share of
    the aux loss: the mean over the source shards of each shard's own aux
    loss)."""
    E, k = spec.num_experts, spec.top_k
    if E != mesh.shape["data"]:
        raise ValueError(f"EP requires num_experts ({E}) == |data| ({mesh.shape['data']})")
    if p["up"]["w"].shape[0] != 1:
        raise ValueError(f"EP takes this rank's expert alone; the weights hold {p['up']['w'].shape[0]}")
    B_l, T, D = x.shape
    S = B_l * T
    C = max(1, int(S * k * spec.capacity_factor / E))
    xf = x.reshape(S, D)
    probs, gate_vals, flat_expert, pos = _route(p, xf, spec)
    kept = pos < C
    _note_drops(kept)
    send, slot, token_idx = _dispatch(xf, flat_expert, pos, kept, E, C, k)  # (E*C, D), expert-major
    # gloo moves CUDA tensors through the host, chosen up front by the mesh's backend
    stage = mesh.backend == "gloo" and x.is_cuda
    group = mesh.group("data")
    recv = _AllToAll.apply(send, group, stage)  # (E_src*C, D): my expert's tokens, by source shard
    gate_w = p["gate"]["w"][0] if "gate" in p else None
    y = _expert_ffn(recv, p["up"]["w"][0], gate_w, p["down"]["w"][0], mlp_kind, "cd,df->cf", "cf,fd->cd", tp)
    back = _AllToAll.apply(y, group, stage)  # (E*C, D): expert j's outputs for my tokens
    out = _combine(back, slot, kept, gate_vals, token_idx, S)
    n_src = mesh.extent(batch_axes(mesh))  # the source shards
    return out.reshape(B_l, T, D).to(x.dtype), _aux_loss(probs, flat_expert, E, k) / n_src
