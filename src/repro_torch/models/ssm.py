"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060], the
reference's ``models/ssm.py``.

Chunked SSD: within a chunk the recurrence is a decay-masked
attention-like contraction; across chunks a loop carries the (heads,
head_dim, d_state) state.  ``ssd_ref`` is the sequential O(T) oracle.

The projections stay split (z, x, B, C, dt and three depthwise convs), as
in the reference.  Decode carries (conv_state, ssm_state) and costs O(1) a
token.

``ssd_chunked`` keeps the reference's formula: ``exp(cum_i - cum_j)`` for
every (i, j) of a chunk, then the j > i entries masked.  Above the
diagonal that exp overflows fp32 for long chunks with strong decay
(Mamba2-780m's 48 heads at chunk 256), and although the forward masks the
infinities away, the gradient of ``dt`` through them is NaN, in both
packages (``tests/test_torch_lm_properties.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import SSMSpec
from . import layers as L

__all__ = ["ssm_init", "set_conv_impl", "ssd_chunked", "ssd_ref", "ssm_apply", "ssm_prefill",
           "SSMCache", "ssm_cache_init", "ssm_decode_step"]


def ssm_init(gen: torch.Generator, d_model: int, spec: SSMSpec, dtype=torch.float32):
    d_inner = spec.expand * d_model
    n_heads = d_inner // spec.head_dim
    N = spec.d_state
    dev = L._device(gen)

    def conv(c):
        return {"w": 0.1 * L._randn(gen, (spec.d_conv, c), dtype), "b": torch.zeros((c,), dtype=dtype, device=dev)}

    return {
        "in_z": L.linear_init(gen, d_model, d_inner, dtype, bias=False),
        "in_x": L.linear_init(gen, d_model, d_inner, dtype, bias=False),
        "in_B": L.linear_init(gen, d_model, N, dtype, bias=False),
        "in_C": L.linear_init(gen, d_model, N, dtype, bias=False),
        "in_dt": L.linear_init(gen, d_model, n_heads, dtype, bias=False),
        "conv_x": conv(d_inner),
        "conv_B": conv(N),
        "conv_C": conv(N),
        "A_log": torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": math.log(math.expm1(0.01)) * torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "norm": L.rmsnorm_init(d_inner, dtype, dev),
        "out_proj": L.linear_init(gen, d_inner, d_model, dtype, bias=False),
    }


# The prefill causal conv: "direct" (a sliding sum, the default) or
# "engine" (the 1D Winograd engine through kernels.ops.winograd_conv1d: the
# d_conv = 4 taps ride F(2, 4), TPU kernel 9 in nlc mode).  The engine path
# widens the depthwise (K, C) taps to diagonal dense (K, C, C) weights, as
# the reference does: it puts the 1D engine on a real consumer, not a flop
# win.  Decode always keeps the O(1) cache step.
_CONV_IMPL = "direct"


def set_conv_impl(impl: str) -> None:
    """Select the prefill causal-conv backend (module-wide): "direct",
    "engine" (kernel 9 on CUDA tensors, its plain version on CPU tensors,
    as every kernel wrapper), or the reference's "engine_interpret", which
    in the port means the plain 1D engine on any device (``backend="ref"``)."""
    global _CONV_IMPL
    if impl not in ("direct", "engine", "engine_interpret"):
        raise ValueError(impl)
    _CONV_IMPL = impl


def _causal_conv(x, conv, init_state=None):
    """Depthwise causal conv1d + SiLU.  x (B, T, C).  Returns (y, tail):
    tail is the last d_conv - 1 rows of the padded input, the decode's conv
    state."""
    w, b = conv["w"], conv["b"]
    K = w.shape[0]
    if init_state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    if _CONV_IMPL == "direct":
        y = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(K))
    else:
        from ..kernels import ops as _kops

        wd = w[:, :, None] * torch.eye(w.shape[1], dtype=w.dtype, device=w.device)
        # a valid conv of the left-padded sequence is the causal conv of x,
        # and honours a decode-prefill init_state tail
        backend = "ref" if _CONV_IMPL == "engine_interpret" else "cuda"
        y = _kops.winograd_conv1d(xp.contiguous(), wd, padding="valid", backend=backend)
    return F.silu(y + b), xp[:, -(K - 1) :, :]


def _operand(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """An einsum operand: fp32, rounded through bf16 first with ``bf16``
    (the reference's bf16 operands with fp32 accumulation)."""
    return t.to(torch.bfloat16).float() if bf16 else t.float()


def ssd_chunked(x, dt, A, Bmat, Cmat, chunk: int, init_state=None, *, bf16_matmul=False):
    """SSD over chunks.

    x (B, T, H, P), dt (B, T, H) >= 0, A (H,) negative, Bmat / Cmat (B, T, N).
    Returns (y (B, T, H, P), final_state (B, H, P, N)).
    ``bf16_matmul``: the heavy einsums on bf16-rounded operands with fp32
    accumulation; the decay and cumsum math stays fp32.
    """
    op = lambda t: _operand(t, bf16_matmul)  # noqa: E731
    Bb, T, H, P = x.shape
    N = Bmat.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of the chunk {chunk}")
    nc = T // chunk
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = Bmat.reshape(Bb, nc, chunk, N)
    Cc = Cmat.reshape(Bb, nc, chunk, N)

    dA = dtc * A[None, None, None, :]  # (B, nc, l, H) log-decay a step
    cum = torch.cumsum(dA, dim=2)  # inclusive over the chunk

    # intra-chunk: Y[i] += sum_{j<=i} C_i . B_j * exp(cum_i - cum_j) * dt_j * x_j
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B, nc, i, j, H)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    gate = torch.where(causal, decay, 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", op(Cc), op(Bc))  # (B, nc, i, j)
    m = cb[..., None] * gate * dtc[:, :, None, :, :]  # (B, nc, i, j, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", op(m), op(xc))

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j  (B, nc, H, P, N)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, l, H)
    s = torch.einsum("bclh,bcln,bclhp->bchpn", op(decay_to_end * dtc), op(Bc), op(xc))
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    h = x.new_zeros((Bb, H, P, N), dtype=torch.float32) if init_state is None else init_state
    h_in = []
    for c in range(nc):  # the state entering each chunk
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None].float() + s[:, c].float()
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    # inter-chunk: Y[i] += exp(cum_i) * C_i . h_in
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", op(Cc), op(h_in), op(torch.exp(cum)))
    y = (y_intra + y_inter).reshape(Bb, T, H, P)
    return y, h


def ssd_ref(x, dt, A, Bmat, Cmat):
    """Sequential O(T) oracle: h_t = exp(dt A) h_{t-1} + dt B_t x_t;
    y_t = C_t . h_t."""
    Bb, T, H, P = x.shape
    N = Bmat.shape[-1]
    h = x.new_zeros((Bb, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A[None, :])  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bmat[:, t], x[:, t])
        h = h * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cmat[:, t], h))
    return torch.stack(ys, dim=1)  # (B, T, H, P)


def _project(p, x, spec: SSMSpec, d_model: int):
    d_inner = spec.expand * d_model
    H = d_inner // spec.head_dim
    z = L.linear(p["in_z"], x)
    xs = L.linear(p["in_x"], x)
    Bm = L.linear(p["in_B"], x)
    Cm = L.linear(p["in_C"], x)
    dt = F.softplus(L.linear(p["in_dt"], x).float() + p["dt_bias"])
    return z, xs, Bm, Cm, dt, d_inner, H


def ssm_apply(p, x, spec: SSMSpec, *, chunk=None, bf16_matmul=False):
    """Full Mamba2 block (training).  x (B, T, D) -> (B, T, D)."""
    y, _ = ssm_prefill(p, x, spec, chunk=chunk, bf16_matmul=bf16_matmul)
    return y


def ssm_prefill(p, x, spec: SSMSpec, *, chunk=None, bf16_matmul=False):
    """Returns (y (B, T, D), SSMCache): the cache continues in decode."""
    Bb, T, D = x.shape
    z, xs, Bm, Cm, dt, d_inner, H = _project(p, x, spec, D)
    xs, tail_x = _causal_conv(xs, p["conv_x"])
    Bm, tail_B = _causal_conv(Bm, p["conv_B"])
    Cm, tail_C = _causal_conv(Cm, p["conv_C"])
    xh = xs.reshape(Bb, T, H, spec.head_dim)
    A = -torch.exp(p["A_log"])
    ck = chunk or min(spec.chunk, T)
    Tp = -(-T // ck) * ck
    if Tp != T:
        # pad with dt = 0 steps: decay exp(0) = 1, update 0, the state unaffected
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, Tp - T))
        dt_p = F.pad(dt, (0, 0, 0, Tp - T))
        Bm_p = F.pad(Bm, (0, 0, 0, Tp - T))
        Cm_p = F.pad(Cm, (0, 0, 0, Tp - T))
    else:
        xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
    cd = torch.bfloat16 if bf16_matmul else torch.float32
    y, h_fin = ssd_chunked(xh_p.to(cd), dt_p, A, Bm_p.to(cd), Cm_p.to(cd), ck, bf16_matmul=bf16_matmul)
    y = y[:, :T]
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bb, T, d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    out = L.linear(p["out_proj"], y)
    return out, SSMCache(conv_x=tail_x, conv_B=tail_B, conv_C=tail_C, state=h_fin)


class SSMCache(NamedTuple):
    conv_x: torch.Tensor  # (B, d_conv-1, d_inner)
    conv_B: torch.Tensor  # (B, d_conv-1, N)
    conv_C: torch.Tensor  # (B, d_conv-1, N)
    state: torch.Tensor  # (B, H, P, N) fp32


def ssm_cache_init(batch, d_model, spec: SSMSpec, dtype=torch.float32, device="cpu") -> SSMCache:
    d_inner = spec.expand * d_model
    H = d_inner // spec.head_dim
    K = spec.d_conv
    kw = dict(dtype=dtype, device=device)
    return SSMCache(
        conv_x=torch.zeros((batch, K - 1, d_inner), **kw),
        conv_B=torch.zeros((batch, K - 1, spec.d_state), **kw),
        conv_C=torch.zeros((batch, K - 1, spec.d_state), **kw),
        state=torch.zeros((batch, H, spec.head_dim, spec.d_state), dtype=torch.float32, device=device),
    )


def _conv_step(x1, conv, state):
    """One-token depthwise conv.  x1 (B, 1, C), state (B, K-1, C)."""
    w, b = conv["w"], conv["b"]
    seq = torch.cat([state.to(x1.dtype), x1], dim=1)  # (B, K, C)
    y = F.silu(torch.einsum("bkc,kc->bc", seq, w) + b)
    return y, seq[:, 1:]


def ssm_decode_step(p, x1, cache: SSMCache, spec: SSMSpec):
    """One-token decode.  x1 (B, 1, D) -> (y (B, 1, D), new cache).  O(1)."""
    Bb, _, D = x1.shape
    z, xs, Bm, Cm, dt, d_inner, H = _project(p, x1, spec, D)
    dt = dt[:, 0]  # (B, H)
    xs, new_cx = _conv_step(xs, p["conv_x"], cache.conv_x)
    Bm, new_cB = _conv_step(Bm, p["conv_B"], cache.conv_B)
    Cm, new_cC = _conv_step(Cm, p["conv_C"], cache.conv_C)
    xh = xs.reshape(Bb, H, spec.head_dim).float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])  # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    state = cache.state * a[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bb, 1, d_inner).to(x1.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    return L.linear(p["out_proj"], y), SSMCache(new_cx, new_cB, new_cC, state)
