"""MLP variants: SwiGLU (llama family), GeGLU (gemma), plain GELU
(starcoder, musicgen): the reference's ``models/mlp.py``.  ``jax.nn.gelu``
is the tanh approximation by default, so GELU here is
``F.gelu(approximate="tanh")``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mlp_apply(p, x, kind: str):
    if kind == "swiglu":
        return L.linear(p["down"], F.silu(L.linear(p["gate"], x)) * L.linear(p["up"], x))
    if kind == "geglu":
        return L.linear(p["down"], gelu(L.linear(p["gate"], x)) * L.linear(p["up"], x))
    if kind == "gelu":
        return L.linear(p["down"], gelu(L.linear(p["up"], x)))
    raise ValueError(kind)
