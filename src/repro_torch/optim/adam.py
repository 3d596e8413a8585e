"""AdamW on dicts of tensors (the reference's ``optim/adam.py``).

State mirrors the param tree; moments are fp32 whatever the params' dtype.
The update is functional: it returns new tensors and leaves its inputs as
they are, as the reference does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

__all__ = ["OptState", "adamw_init", "clip_by_global_norm", "adamw_update"]


class OptState(NamedTuple):
    step: int
    m: Any  # tree like params (fp32)
    v: Any


def adamw_init(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return OptState(0, zeros, tree_map(torch.clone, zeros))


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float, gn=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    ``gn``: the norm where the caller has it (a sharded step's, summed
    over its ranks)."""
    gn = _global_norm(grads) if gn is None else gn
    scale = torch.clamp_max(max_norm / (gn + 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(
    params,
    grads,
    state: OptState,
    *,
    lr: float = 2e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float = 0.0,
):
    """Returns (new_params, new_state, metrics)."""
    if max_grad_norm > 0:
        grads, gn = clip_by_global_norm(grads, max_grad_norm)
    else:
        gn = _global_norm(grads)
    step = state.step + 1
    # bias corrections in fp32, as the reference computes them
    t = np.float32(step)
    bc1, bc2 = float(np.float32(1.0) - np.float32(b1) ** t), float(np.float32(1.0) - np.float32(b2) ** t)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m2, v2

    flat = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t: t[i], flat)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2)), {"grad_norm": gn}
