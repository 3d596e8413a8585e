"""Tensor parallelism over the mesh's "model" axis: the operators that let
each rank compute on its "model" block of a leaf (Megatron-LM's column /
row parallel pattern), as the reference's GSPMD step splits the LM's
matmuls under ``lm_param_specs``.

The residual stream is whole on every rank of the model group.  A region
that computes on a rank's slice of a feature dimension opens with
``enter`` ("f": identity forward, the gradient summed over the group
backward, since each rank's slice gives a partial gradient of the input)
and closes with ``leave`` ("g": the partial outputs of a row-parallel
product summed forward, the gradient passed through, since every rank
computes the same loss from the sum).  ``embed`` and ``cross_entropy`` are
the vocabulary-parallel lookup and loss: each rank holds a slice of the
vocabulary.  With no group, or a group of one rank, every operator is the
plain function and launches no collective.

``lm_parts`` says which parts of an LM split over "model" on a mesh, read
off its spec tree (``sharding.lm_param_specs``), so that a part computes
on the blocks its leaves are stored as.

A row-parallel product (``row_parallel``) in half precision stays in fp32
until the group's sum, which is rounded once: as one device's product
is, and as the reference's compiled GSPMD step sums it (XLA partitions a
bf16 dot into an fp32 dot, an fp32 all-reduce and one convert).  Any
other sum over the group of half-precision values also runs in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["TP", "LMParts", "lm_parts", "enter", "leave", "row_parallel", "sum_shared", "embed", "cross_entropy",
           "local_kv"]

_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class TP:
    """A rank's model group: its process group, extent and index."""

    group: Any
    n: int
    index: int

    @staticmethod
    def of(mesh) -> Optional["TP"]:
        """The mesh's "model" group, or None (no mesh, no such axis, or an
        extent of 1: nothing splits)."""
        if mesh is None or "model" not in mesh.axis_names or mesh.shape["model"] == 1:
            return None
        return TP(mesh.group("model"), mesh.shape["model"], mesh.coords["model"])


@dataclasses.dataclass(frozen=True)
class LMParts:
    """The model group each part of an LM computes its slice over (None:
    the part runs whole on every rank)."""

    attn: Optional[TP] = None  # query heads
    kv: Optional[TP] = None  # kv heads (None with ``attn``: each rank reads the kv heads its query heads map to)
    ffn: Optional[TP] = None  # the MLP's and the experts' ff
    ssm: Optional[TP] = None  # the Mamba mixer's heads and d_inner channels
    vocab: Optional[TP] = None  # the embedding table's and the head's vocabulary


def lm_parts(specs, tp: Optional[TP]) -> LMParts:
    """Which parts of an LM split over ``tp``, from its spec tree
    (``lm_param_specs``): a part splits where its leaves name "model" (the
    first slot holding it: the rules are the same in every slot).  The
    Mamba mixer splits by heads: ``d_inner`` split while ``in_dt``'s heads
    are not leaves no head-aligned slice, and is a ``ValueError``."""
    if tp is None:
        return LMParts()
    on = lambda spec: tp if "model" in spec else None  # noqa: E731
    slots = list(specs["blocks"].values())
    first = lambda part, leaf: next((on(s[part][leaf]["w"]) for s in slots if part in s), None)  # noqa: E731
    ssm = first("mamba", "in_x")
    if ssm is not None and first("mamba", "in_dt") is None:
        raise ValueError("the Mamba mixer splits over 'model' by heads; its d_inner splits while its heads do not")
    return LMParts(attn=first("attn", "wq"), kv=first("attn", "wk"), ffn=first("mlp", "up") or first("moe", "up"),
                   ssm=ssm, vocab=on(specs["embed"]["table"]))


def _summed(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    wide = torch.float32 if x.dtype in _HALF else x.dtype
    out = x.detach().to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype)


class _Enter(torch.autograd.Function):
    """Megatron's "f": identity forward, the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """Megatron's "g": the group's partial values summed forward, the
    gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The input of a region that computes on this rank's slice ("f")."""
    return x if tp is None else _Enter.apply(x, tp.group)


def leave(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The sum of the group's partial outputs ("g")."""
    return x if tp is None else _Leave.apply(x, tp.group)


def row_parallel(x: torch.Tensor, w: torch.Tensor, tp: Optional[TP], eq: Optional[str] = None) -> torch.Tensor:
    """``x @ w`` (``torch.einsum(eq, x, w)`` with ``eq``) of a weight split
    over the group on the contracted dimension, ``x`` holding the matching
    slice, summed over the group ("g").  A half-precision product is
    formed in fp32 and rounded once, after the sum (the module
    docstring)."""
    mm = (lambda a, b: a @ b) if eq is None else (lambda a, b: torch.einsum(eq, a, b))  # noqa: E731
    dt = torch.promote_types(x.dtype, w.dtype)
    if tp is None or dt not in _HALF:
        return leave(mm(x, w), tp)
    return leave(mm(x.float(), w.float()), tp).to(dt)


def sum_shared(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The group's sum of partial values, consumed again on each rank's
    slice (a norm's sum of squares over a split dimension): "g" then "f",
    the sum forward and the gradient's sum backward."""
    return enter(leave(x, tp), tp)


def embed(table: torch.Tensor, ids: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The rows of ``ids`` from this rank's vocabulary slice ``table``
    (V / n, D): ids outside the slice give zeros, and the group's sum has
    every row once.  A clamped index and a ``where``, so the shapes do not
    depend on the ids."""
    if tp is None:
        return table[ids]
    V_l = table.shape[0]
    local = ids - tp.index * V_l
    inside = (local >= 0) & (local < V_l)
    rows = table[local.clamp(0, V_l - 1)]
    return leave(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)), tp)


class _VocabCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over a vocabulary
    split over the group: the max, then the sum of exponentials and the
    label's logit (from the rank that holds it), each over the group; the
    gradient ``softmax - onehot`` on this rank's slice."""

    @staticmethod
    def forward(ctx, logits, labels, group, v0):
        V_l = logits.shape[-1]
        m = _summed(logits.amax(-1), group, dist.ReduceOp.MAX)
        local = labels.long() - v0
        inside = (local >= 0) & (local < V_l)
        idx = local.clamp(0, V_l - 1)
        gold = torch.where(inside, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        both = _summed(torch.stack([torch.exp(logits - m[..., None]).sum(-1), gold]), group)
        lse = m + torch.log(both[0])
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, inside = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None])
        d = d.scatter_add(-1, idx[..., None], -inside[..., None].to(d.dtype))
        return d * g[..., None], None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Per-token cross-entropy ``logsumexp - logits[label]`` of fp32
    ``logits`` (..., V / n), this rank's vocabulary slice."""
    if tp is None:
        return torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _VocabCE.apply(logits, labels, tp.group, tp.index * logits.shape[-1])


def local_kv(t: torch.Tensor, q0: int, n_q: int, rep: int) -> torch.Tensor:
    """The kv heads (dim 2 of ``t``, all of them) that query heads
    ``[q0, q0 + n_q)`` read, query head h reading kv head ``h // rep``, in
    a layout where the local query heads group over them as GQA's do:
    a slice where the local heads take whole groups or lie in one group,
    else one kv head a query head (an index copy)."""
    if n_q % rep == 0 and q0 % rep == 0:
        return t[:, :, q0 // rep : (q0 + n_q) // rep]
    if q0 // rep == (q0 + n_q - 1) // rep:
        return t[:, :, q0 // rep : q0 // rep + 1]
    return t.index_select(2, torch.arange(q0, q0 + n_q, device=t.device) // rep)
