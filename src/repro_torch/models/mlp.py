"""MLP variants: SwiGLU (llama family), GeGLU (gemma), plain GELU
(starcoder, musicgen): the reference's ``models/mlp.py``.  ``jax.nn.gelu``
is the tanh approximation by default, so GELU here is
``F.gelu(approximate="tanh")``.

On a mesh (``tp``, ``parallel/tp.py``) ``up`` / ``gate`` are column
parallel and ``down`` row parallel: a rank holds its ``ff`` slice of each,
its partial output is summed over the model group, and a plain MLP's
``down`` bias is added once, after the sum."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import tp as TPx
from . import layers as L

__all__ = ["mlp_init", "mlp_apply", "gelu"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, d_model, d_ff, kind: str, dtype=torch.float32):
    if kind in ("swiglu", "geglu"):
        return {
            "gate": L.linear_init(gen, d_model, d_ff, dtype, bias=False),
            "up": L.linear_init(gen, d_model, d_ff, dtype, bias=False),
            "down": L.linear_init(gen, d_ff, d_model, dtype, bias=False),
        }
    if kind == "gelu":
        return {
            "up": L.linear_init(gen, d_model, d_ff, dtype),
            "down": L.linear_init(gen, d_ff, d_model, dtype),
        }
    raise ValueError(kind)


def mlp_apply(p, x, kind: str, tp=None):
    """The MLP of x; with ``tp`` (a ``parallel.tp.TP``) on this rank's
    ``ff`` slice of the weights, the outputs summed over the group."""
    x = TPx.enter(x, tp)
    if kind == "swiglu":
        h = F.silu(L.linear(p["gate"], x)) * L.linear(p["up"], x)
    elif kind == "geglu":
        h = gelu(L.linear(p["gate"], x)) * L.linear(p["up"], x)
    elif kind == "gelu":
        h = gelu(L.linear(p["up"], x))
    else:
        raise ValueError(kind)
    y = TPx.row_parallel(h, p["down"]["w"], tp)
    return y + p["down"]["b"] if "b" in p["down"] else y
