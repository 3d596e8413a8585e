"""Token-choice top-k MoE with capacity, dispatched by sort and gather (the
reference's ``models/moe.py``).

The dispatch plan is integer work (a stable cumulative count per expert,
no (tokens x E x C) one-hot matmul), so the expert FLOPs are the only
matmul FLOPs.  Assignments over an expert's capacity are dropped (GShard
semantics: the residual carries the token); the gates of the kept
assignments are renormalized over the chosen experts before the drop, as
in the reference.  The capacity depends on the batch, so a token's drops
do too.  The expert-parallel variant (``moe_apply_ep``) is ROADMAP item 6d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import MoESpec
from . import layers as L
from .mlp import gelu

__all__ = ["moe_init", "moe_apply", "top_k"]


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


def moe_apply(p, x: torch.Tensor, spec: MoESpec, mlp_kind: str):
    """x (B, T, D) -> ((B, T, D), aux loss).  Capacity-dropped assignments
    add nothing."""
    B, T, D = x.shape
    E, k = spec.num_experts, spec.top_k
    S = B * T
    C = max(1, int(S * k * spec.capacity_factor / E))
    xf = x.reshape(S, D)

    logits = L.linear(p["router"], xf.float())  # (S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)  # (S, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)  # renorm

    # ---- dispatch plan (integer work) ----
    flat_expert = expert_ids.reshape(-1)  # (S*k,) assignment -> expert
    onehot = F.one_hot(flat_expert, E)  # (S*k, E)
    # each assignment's place in its expert's queue, in assignment order
    pos_in_expert = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1, flat_expert[:, None]).squeeze(-1)
    kept = pos_in_expert < C
    slot = torch.where(kept, flat_expert * C + pos_in_expert, E * C)  # dummy slot E*C
    token_idx = torch.arange(S, device=x.device).repeat_interleave(k)
    src = torch.full((E * C + 1,), S, dtype=torch.long, device=x.device)
    src[slot] = token_idx  # the dummy row absorbs the drops
    x_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    dispatched = x_pad[src[: E * C]].reshape(E, C, D)

    # ---- expert compute (batched over E) ----
    act = F.silu if mlp_kind == "swiglu" else gelu
    up = torch.einsum("ecd,edf->ecf", dispatched, p["up"]["w"])
    if mlp_kind in ("swiglu", "geglu"):
        h = act(torch.einsum("ecd,edf->ecf", dispatched, p["gate"]["w"])) * up
    else:
        h = act(up)
    y = torch.einsum("ecf,efd->ecd", h, p["down"]["w"])  # (E, C, D)

    # ---- combine ----
    y_flat = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))], dim=0)
    per_assign = y_flat[slot]  # (S*k, D); drops -> zeros
    w_assign = torch.where(kept, gate_vals.reshape(-1), 0.0).to(per_assign.dtype)
    out = per_assign.new_zeros((S, D)).index_add(0, token_idx, per_assign * w_assign[:, None])
    return out.reshape(B, T, D).to(x.dtype), _aux_loss(probs, flat_expert, E, k)


def _aux_loss(probs: torch.Tensor, flat_expert: torch.Tensor, E: int, k: int):
    """Switch-style load-balancing auxiliary loss."""
    S = probs.shape[0]
    frac_tokens = torch.bincount(flat_expert, minlength=E).float() / (S * k)
    frac_probs = probs.mean(0)
    return E * torch.sum(frac_tokens * frac_probs)
