"""Building-block layers as plain functions over parameter dicts.

Same layouts and keys as the reference's ``models/layers.py``: NHWC
activations, linear weights (d_in, d_out), conv weights (K, K, C_in, C_out),
batchnorm dicts {scale, bias, mean, var}.  Inits draw from a
``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "normal_init", "lecun_init", "linear_init", "linear", "batchnorm_init", "batchnorm",
    "conv2d_init", "conv2d", "leaky_relu", "ACTIVATIONS",
]


# ----------------------------------------------------------------- inits
def normal_init(gen: torch.Generator, shape, scale=0.02, dtype=torch.float32):
    return scale * torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def lecun_init(gen: torch.Generator, shape, fan_in=None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0]
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype) / math.sqrt(max(1, fan_in))


# ---------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32, bias=True):
    p = {"w": lecun_init(gen, (d_in, d_out), d_in, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p, x):
    if "b" in p and x.dim() == 2:
        return torch.addmm(p["b"], x, p["w"])  # one launch for product and bias
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ------------------------------------------------------------- batchnorm
def batchnorm_init(c, device, dtype=torch.float32):
    return {
        "scale": torch.ones((c,), dtype=dtype, device=device),
        "bias": torch.zeros((c,), dtype=dtype, device=device),
        "mean": torch.zeros((c,), dtype=torch.float32, device=device),
        "var": torch.ones((c,), dtype=torch.float32, device=device),
    }


def batchnorm(p, x, *, training: bool = False, momentum=0.9, eps=1e-5):
    """NHWC batch norm.  Returns (y, new_stats): training mode normalises by
    the batch's mean and population variance and moves the running
    statistics by ``momentum``; eval mode uses the running statistics."""
    if training:
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        mu = xf.mean(dim=axes)
        var = xf.var(dim=axes, unbiased=False)
        new = {
            "mean": momentum * p["mean"] + (1 - momentum) * mu,
            "var": momentum * p["var"] + (1 - momentum) * var,
        }
    else:
        mu, var = p["mean"], p["var"]
        new = {"mean": p["mean"], "var": p["var"]}
    y = (x.float() - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new


# ------------------------------------------------------------------ conv
def conv2d_init(gen: torch.Generator, k, c_in, c_out, dtype=torch.float32):
    return {
        "w": lecun_init(gen, (k, k, c_in, c_out), k * k * c_in, dtype),
        "b": torch.zeros((c_out,), dtype=dtype, device=gen.device),
    }


def conv2d(p, x, stride=1):
    """NHWC cross-correlation with "SAME" padding (the low side gets the
    smaller half, as XLA pads), weights (K, K, C_in, C_out)."""
    K = p["w"].shape[0]
    pads = []
    for size in (x.shape[2], x.shape[1]):  # F.pad order: W first, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + K - size, 0)
        pads += [total // 2, total - total // 2]
    xc = F.pad(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, p["w"].permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


# ------------------------------------------------------------ activations
def leaky_relu(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "leaky_relu": leaky_relu,
    "tanh": torch.tanh,
    "none": lambda x: x,
}
