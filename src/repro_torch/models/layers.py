"""Building-block layers as plain functions over parameter dicts.

Same layouts and keys as the reference's ``models/layers.py``: NHWC
activations, linear weights (d_in, d_out), conv weights (K, K, C_in, C_out),
batchnorm dicts {scale, bias, mean, var}, layernorm {scale, bias}, rmsnorm
{scale}, embedding {table (vocab, d)}.  Inits draw from a
``torch.Generator`` on the target device.

Sync-BN: inside ``bn_sync_axis(group)`` training-mode batch statistics are
averaged over the ranks of a ``torch.distributed`` process group, so a step
whose batch is split over those ranks computes the single-device function
(``bn_sync_moments``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = [
    "normal_init", "lecun_init", "linear_init", "linear", "layernorm_init", "layernorm", "rmsnorm_init", "rmsnorm",
    "embedding_init", "embedding", "bn_sync_axis", "bn_sync_moments", "batchnorm_init",
    "batchnorm",
    "conv2d_init", "conv2d", "leaky_relu", "ACTIVATIONS",
]


# ----------------------------------------------------------------- inits
# ``gen`` None draws nothing: the leaves come out on the meta device, with
# their shapes only (``models.lm.lm_param_shapes``).
def _device(gen):
    return torch.device("meta") if gen is None else gen.device


def _randn(gen, shape, dtype):
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)


def normal_init(gen: torch.Generator, shape, scale=0.02, dtype=torch.float32):
    return scale * _randn(gen, shape, dtype)


def lecun_init(gen: torch.Generator, shape, fan_in=None, dtype=torch.float32):
    fan_in = fan_in if fan_in is not None else shape[0]
    return _randn(gen, shape, dtype) / math.sqrt(max(1, fan_in))


# ---------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32, bias=True):
    p = {"w": lecun_init(gen, (d_in, d_out), d_in, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=_device(gen))
    return p


def linear(p, x):
    if "b" in p and x.dim() == 2:
        return torch.addmm(p["b"], x, p["w"])  # one launch for product and bias
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ----------------------------------------------------------------- norms
def layernorm_init(d, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device), "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rmsnorm_init(d, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------ embeddings
def embedding_init(gen: torch.Generator, vocab, d, dtype=torch.float32, scale=0.02):
    return {"table": normal_init(gen, (vocab, d), scale, dtype)}


def embedding(p, ids):
    return p["table"][ids]


# ------------------------------------------------------------- batchnorm
# The sync-BN hook: module-global, as the reference's, because the BN call
# sites sit under apply functions that thread no mesh.
_BN_SYNC_GROUP = None


@contextlib.contextmanager
def bn_sync_axis(group):
    """Within the context, training-mode batch statistics are averaged over
    the process group ``group`` (the batch axes' group of a mesh; None: no
    sync).  Every rank of the group must run the same BN layers in the same
    order, forward and backward."""
    global _BN_SYNC_GROUP
    prev = _BN_SYNC_GROUP
    _BN_SYNC_GROUP = group
    try:
        yield
    finally:
        _BN_SYNC_GROUP = prev


class _MeanAllReduce(torch.autograd.Function):
    """The mean of ``x`` over a process group, differentiable: its backward
    is the same mean all-reduce of the cotangent (the transpose JAX takes
    for ``pmean`` with ``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None, None


def bn_sync_moments(mean, ex2):
    """(mean, E[x^2]) averaged over the active sync group in one fused
    all-reduce; the identity outside a ``bn_sync_axis`` context.  The mean
    of the ranks' means is the global mean for equal shards only."""
    if _BN_SYNC_GROUP is None:
        return mean, ex2
    c = mean.numel()
    both = _MeanAllReduce.apply(torch.cat([mean.reshape(-1), ex2.reshape(-1)]), _BN_SYNC_GROUP,
                                dist.get_world_size(_BN_SYNC_GROUP))
    return both[:c].reshape(mean.shape), both[c:].reshape(ex2.shape)


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
        if _BN_SYNC_GROUP is not None:
            mu, ex2 = bn_sync_moments(xf.mean(dim=axes), (xf * xf).mean(dim=axes))
            var = torch.clamp_min(ex2 - mu * mu, 0.0)
        else:
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
