"""Packed layouts, the cell layout, and the forward deconv entry points.

Layout half: ``prepack`` runs the G-transform and the zero-skipping pack
once, giving packed (C, N, M) weights; ``cells_from_image`` and
``cells_to_next`` build the fused engine's (B, Gy, Gx, m*m, N) cell layout
from an NHWC image or from the previous layer's emitted cells.

Entry half: ``winograd_deconv2d_cells`` (cells in) runs the
epilogue-fused engine.  ``winograd_deconv2d_packed`` (NHWC in) is the
reference's per-layer entry point: with an epilogue and ``fuse_pre`` it
takes the cells path; otherwise it runs the fused pre-PE engine in scratch
mode (``fuse_pre=True``, through ``FusedPreFn``) or the unfused engine on
the transformed tiles (``fuse_pre=False``, through ``EngineFn``), then the
depth-to-space interleave and any epilogue in plain PyTorch, as the
reference leaves them to XLA.  ``winograd_deconv2d_fused`` packs raw
weights per call.

The strided conv (the discriminator) mirrors both halves at the engine's
conv corner: ``conv_packed_layout`` / ``prepack_conv`` pack the phase
sub-filters' structural nonzeros into (C, N, M), ``conv_cells_from_image``
and ``conv_cells_to_next`` build the phase-major (B, Gy, Gx, S^2*m*m, N)
cells, and ``winograd_conv2d_cells`` / ``winograd_conv2d_packed`` run the
conv engine, through ``ConvEpilogueFn`` where a gradient is wanted;
``winograd_conv2d`` packs raw conv weights per call.

The 1D half (the audio decoder, conv1d) is the rank-1 instantiation of the
same API: ``conv1d_layout`` / ``packed_deconv1d_layout``,
``prepack_conv1d`` / ``prepack_deconv1d`` (``PackedConv1d``),
``conv1d_cells``, and ``winograd_conv1d[_packed]`` /
``winograd_deconv1d[_packed]`` on the 1D engine in nlc mode, through
``Engine1dFn`` where a gradient is wanted.  The 1D engine is linear: the
bias and activation stay outside it, where autograd differentiates them.
``backend="cuda"`` takes the CUDA kernel for CUDA tensors and its plain
version for CPU tensors; where a gradient is wanted it runs through an
autograd Function (``FusedEpilogueFn``, ``FusedPreFn``, ``EngineFn``,
``ConvEpilogueFn``) whose backward is the backward kernels (or their plain
versions).  ``backend="ref"`` takes the plain version on any device and
leaves the gradient to autograd.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.tdc import ConvDims, DeconvDims, conv_plan, decompose_weights_1d, interleave_crop, plan, plan_1d
from ..core.winograd import get_transform
from ..core.winograd_deconv import (
    device_constant, pad_input_for_tiles, transform_conv_weights, transform_input_tiles, transform_weights,
)
from . import engine as _engine
from .ref import epilogue_apply_ref

__all__ = [
    "packed_layout",
    "pack_weights",
    "PackedDeconv",
    "prepack",
    "cells_layout",
    "cells_from_image",
    "chain_aligned",
    "cells_to_next",
    "cells_window_mask",
    "FusedEpilogueFn",
    "FusedPreFn",
    "EngineFn",
    "winograd_deconv2d_cells",
    "winograd_deconv2d_packed",
    "winograd_deconv2d_fused",
    "conv_packed_layout",
    "pack_conv_weights",
    "PackedConv",
    "conv_packed_inv",
    "prepack_conv",
    "unpack_weights",
    "conv_cells_from_image",
    "conv_chain_aligned",
    "conv_cells_to_next",
    "ConvEpilogueFn",
    "winograd_conv2d_cells",
    "winograd_conv2d_packed",
    "winograd_conv2d",
    "conv1d_layout",
    "packed_deconv1d_layout",
    "pack_conv1d_weights",
    "pack_deconv1d_weights",
    "PackedConv1d",
    "prepack_conv1d",
    "prepack_deconv1d",
    "conv1d_cells",
    "conv1d_cells_from_seq",
    "deconv1d_cells_from_seq",
    "Engine1dFn",
    "winograd_conv1d_packed",
    "winograd_conv1d",
    "winograd_deconv1d_packed",
    "winograd_deconv1d",
]


@functools.lru_cache(maxsize=None)
def packed_layout(dims: DeconvDims, m: int = 2, r: int = 3):
    """Static packed layout for (K_D, S): position indices, sub-filter slices
    and the packed inverse-transform rows.

    Returns (pos_idx, sub_slices, inv_packed_np, keep_per_sub).
    """
    sp = plan(dims, m, r)
    tf = get_transform(m, r)
    n = tf.n
    AT = np.asarray(tf.AT)
    pos_idx: list[int] = []
    sub_slices: list[tuple[int, int]] = []
    inv_rows: list[np.ndarray] = []
    keeps: list[list[tuple[int, int]]] = []
    for ry in range(dims.stride):
        for rx in range(dims.stride):
            mask = sp.masks_winograd[ry, rx]
            keep = [(u, v) for u in range(n) for v in range(n) if mask[u, v]]
            lo = len(pos_idx)
            for u, v in keep:
                pos_idx.append(u * n + v)
                inv_rows.append(np.outer(AT[:, u], AT[:, v]).reshape(m * m))
            sub_slices.append((lo, len(pos_idx)))
            keeps.append(keep)
    inv_packed = (
        np.stack(inv_rows).astype(np.float32) if inv_rows else np.zeros((0, m * m), np.float32)
    )
    return tuple(pos_idx), tuple(sub_slices), inv_packed, keeps


@functools.lru_cache(maxsize=None)
def _pack_gather_idx(dims: DeconvDims, m: int, r: int) -> np.ndarray:
    """Packed row -> flat (S*S*n*n) index into the transformed weights."""
    pos_idx, sub_slices, _, _ = packed_layout(dims, m, r)
    n2 = get_transform(m, r).n ** 2
    idx = np.empty(len(pos_idx), np.int64)
    for s, (lo, hi) in enumerate(sub_slices):
        idx[lo:hi] = s * n2 + np.asarray(pos_idx[lo:hi], np.int64)
    return idx


def pack_weights(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """Deconv weights (K_D, K_D, N, M) -> packed Winograd-domain (C, N, M):
    only the C(K_C) structurally nonzero positions are kept."""
    idx = _pack_gather_idx(dims, m, r)
    if idx.size == 0:
        return w.new_zeros((0, *w.shape[2:]))
    ww = transform_weights(w, dims, m, r)  # (S, S, n, n, N, M)
    flat = ww.reshape(-1, *ww.shape[4:])
    return flat[torch.as_tensor(idx, device=w.device)].to(w.dtype).contiguous()


class PackedDeconv(NamedTuple):
    """Pre-packed Winograd-domain deconv weights."""

    ww: torch.Tensor  # (C, N, M) packed transformed weights
    inv: torch.Tensor  # (C, m2) fp32 inverse-transform rows


def packed_inv(dims: DeconvDims, device, m: int = 2, r: int = 3) -> torch.Tensor:
    """The static (C, m2) inverse-transform rows of ``dims`` on ``device``,
    copied there once and cached (no host-to-device copy per request)."""
    return _inv_on(dims, m, r, str(torch.device(device)))


@device_constant(maxsize=64)
def _inv_on(dims: DeconvDims, m: int, r: int, device: str) -> torch.Tensor:
    return torch.as_tensor(packed_layout(dims, m, r)[2], device=device)


def prepack(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> PackedDeconv:
    """One-time G-transform + zero-skipping pack of raw deconv weights."""
    return PackedDeconv(pack_weights(w, dims, m, r), packed_inv(dims, w.device, m, r))


def cells_layout(x_pad: torch.Tensor, ty: int, tx: int, m: int, n: int) -> torch.Tensor:
    """Padded NHWC image -> the fused engine's cell layout (B, Gy, Gx, m*m, N):
    space-to-depth by the tile stride m."""
    B, Hp, Wp, N = x_pad.shape
    q = -(-n // m)
    gy, gx = ty + q - 1, tx + q - 1
    need_h, need_w = gy * m, gx * m
    x_pad = F.pad(x_pad, (0, 0, 0, max(0, need_w - Wp), 0, max(0, need_h - Hp)))[:, :need_h, :need_w, :]
    return x_pad.reshape(B, gy, m, gx, m, N).permute(0, 1, 3, 2, 4, 5).reshape(B, gy, gx, m * m, N)


def cells_from_image(x: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """NHWC input -> the padded cell layout for ``dims``: the deconv left pad
    (kc-1) plus the tile-coverage right pad, then ``cells_layout``."""
    x_pad, (ty, tx) = pad_input_for_tiles(x, dims, m, r)
    return cells_layout(x_pad, ty, tx, m, get_transform(m, r).n).contiguous()


def chain_aligned(dims: DeconvDims, next_dims: DeconvDims, m: int = 2) -> bool:
    """True when this layer's emitted cells line up with the next layer's
    input cells on whole-cell boundaries: the shift d = P - (kc' - 1) is a
    multiple of m.  All stride-2 paper chains have d = 0; ArtGAN's trailing
    K4S2 -> K3S1 hop has d = -1 and takes the NHWC fallback."""
    return (dims.padding - (next_dims.kc - 1)) % m == 0


def cells_to_next(
    emitted: torch.Tensor,  # (B, ty*S, tx*S, m*m, M) from emit_cells
    dims: DeconvDims,
    next_dims: DeconvDims,
    out_hw: tuple[int, int],  # this layer's (H_O, W_O) = the next layer's input
    m: int = 2,
    r: int = 3,
) -> torch.Tensor:
    """Emitted cells -> the next layer's input cell layout, by whole cell
    rows and columns only.  When the shift is 0 and the emitted array
    already covers the next layer's extent (every DCGAN hop: ty*S equals the
    next gy) it passes through untouched; the engine reads only the rows
    and columns it needs, and everything past the crop window is zero."""
    if not chain_aligned(dims, next_dims, m):
        raise ValueError(
            f"cell layouts misaligned: P={dims.padding} vs kc'={next_dims.kc} "
            f"shift not divisible by m={m}"
        )
    tf = get_transform(m, r)
    HO, WO = out_hw
    hj2, wj2 = next_dims.j_extent(HO), next_dims.j_extent(WO)
    ty2, tx2 = -(-hj2 // m), -(-wj2 // m)
    q = -(-tf.n // m)
    gy2, gx2 = ty2 + q - 1, tx2 + q - 1
    d = (dims.padding - (next_dims.kc - 1)) // m
    GyE, GxE = emitted.shape[1], emitted.shape[2]
    if d == 0 and GyE >= gy2 and GxE >= gx2:
        return emitted
    pad_before = max(0, -d)
    arr = F.pad(
        emitted,
        (
            0, 0, 0, 0,
            pad_before, max(0, d + gx2 - GxE),
            pad_before, max(0, d + gy2 - GyE),
        ),
    )
    start = d + pad_before
    return arr[:, start : start + gy2, start : start + gx2].contiguous()


def cells_window_mask(rows: int, cols: int, m: int, padding: int, out_h: int, out_w: int,
                      device=None) -> torch.Tensor:
    """(rows, cols, m*m, 1) fp32 crop-window mask of an emitted cell layout:
    cell (rr, cc) intra (pp, qq) holds pixel (m*rr + pp, m*cc + qq), valid in
    [padding, padding + out_h) x [padding, padding + out_w)."""
    r_io = torch.arange(rows, device=device)[:, None, None, None]
    c_io = torch.arange(cols, device=device)[None, :, None, None]
    a_io = torch.arange(m * m, device=device)[None, None, :, None]
    row_px = m * r_io + a_io // m
    col_px = m * c_io + a_io % m
    return ((row_px >= padding) & (row_px < padding + out_h)
            & (col_px >= padding) & (col_px < padding + out_w)).float()


def _epilogue_cotangent(g_img, y_img, scale, bias, activation: str, M: int):
    """Activation-cotangent prologue: from the output cotangent and the saved
    post-activation output (both fp32 images), the pre-affine cotangent and
    the scale and bias cotangents.  Returns (g_aff, dscale, dbias)."""
    if activation == "relu":
        dact, pre = (y_img > 0).float(), y_img
    elif activation == "leaky_relu":
        dact = torch.where(y_img >= 0, 1.0, _engine.LEAKY_SLOPE)
        pre = torch.where(y_img >= 0, y_img, y_img / _engine.LEAKY_SLOPE)
    elif activation == "tanh":
        dact = 1.0 - y_img * y_img
        pre = torch.atanh(torch.clamp(y_img, -1.0 + 1e-6, 1.0 - 1e-6))
    else:
        dact, pre = None, y_img
    dpre = g_img if dact is None else g_img * dact
    dev = g_img.device
    sc = torch.ones((M,), device=dev) if scale is None else scale.float()
    bi = torch.zeros((M,), device=dev) if bias is None else bias.float()
    dbias = dpre.sum(dim=(0, 1, 2))
    # raw engine output v = (pre - bias) / scale; where act' = 0 its value is
    # irrelevant (dpre = 0).  A zero scale channel loses v entirely: its
    # dscale is 0, not a NaN that would poison the optimizer's global norm
    sc_safe = torch.where(sc == 0, 1.0, sc)
    v = torch.where(sc == 0, 0.0, (pre - bi) / sc_safe)
    dscale = (dpre * v).sum(dim=(0, 1, 2))
    return dpre * sc, dscale, dbias


def _bwd_choices(bwd_x_conf: str | None = None, bwd_w_conf: str | None = None,
                 bwd_w_splits: int | None = None) -> dict:
    """The backward launches' configurations, as a forward call takes them:
    {"x": bwd_x's conf, "w": bwd_w's conf and T split}; None keeps each
    plan's choice."""
    return {"x": dict(conf=bwd_x_conf), "w": dict(conf=bwd_w_conf, splits=bwd_w_splits)}


def _epilogue_fn_backward(ctx, grad, S: int, P: int, bwd_x, bwd_w, geo: dict):
    """The backward both epilogue Functions share.  The output's pixels
    form a (ty*m*S, tx*m*S) image whose crop window starts at offset ``P``
    (S = stride, P = padding at the deconv corner; S = 1, P = 0 at the conv
    corner): cells mode masks the cotangent to that window and uncells it,
    nhwc mode pads the cropped cotangent back at offset P.  Then the
    activation-cotangent prologue, the inverse interleave to the (B, ty,
    tx, S*S*m*m, M) scratch layout, and ``bwd_x`` (dcells) and ``bwd_w``
    (dww) on the configurations ``ctx.bwd`` holds (``_bwd_choices``), each
    only where a gradient is asked for.  Returns the gradients of (cells,
    ww, inv, scale, bias, kw, bwd)."""
    cells, ww, inv, scale, bias, y = ctx.saved_tensors
    kw = ctx.kw
    m, ty, tx, oh, ow = kw["m"], kw["ty"], kw["tx"], kw["out_h"], kw["out_w"]
    B, M, ms = cells.shape[0], ww.shape[2], m * S
    g = grad.float()
    if kw["out_mode"] == "cells":
        def uncell(c):  # emitted cells -> padded-interleave coordinates
            return c.reshape(B, ty * S, tx * S, m, m, M).permute(0, 1, 3, 2, 4, 5).reshape(
                B, ty * ms, tx * ms, M)

        # the forward zeroed everything outside the crop window, so the
        # cotangent there must not flow back
        mask = cells_window_mask(ty * S, tx * S, m, P, oh, ow, device=g.device)
        g_img, y_img = uncell(g * mask), uncell(y)
    else:  # the kernel's nhwc output is already cropped: pad back at offset P
        g_img = g.new_zeros((B, ty * ms, tx * ms, M))
        g_img[:, P : P + oh, P : P + ow] = g
        y_img = g.new_zeros((B, ty * ms, tx * ms, M))
        y_img[:, P : P + oh, P : P + ow] = y
    if kw["activation"] == "none" and scale is None and bias is None:
        g_aff, dscale, dbias = g_img, None, None
    else:
        g_aff, dscale, dbias = _epilogue_cotangent(g_img, y_img, scale, bias, kw["activation"], M)
    # inverse interleave: back to the (B, ty, tx, S2*m2, M) scratch layout
    g_scr = g_aff.reshape(B, ty, m, S, tx, m, S, M).permute(0, 1, 4, 3, 6, 2, 5, 7).reshape(
        B, ty, tx, S * S * m * m, M).contiguous()
    dcells = dww = None
    if ctx.needs_input_grad[0]:
        dcells = bwd_x(g_scr, ww, inv, gy=cells.shape[1], gx=cells.shape[2], **geo, **ctx.bwd["x"])
    if ctx.needs_input_grad[1]:
        dww = bwd_w(cells, g_scr, inv, **geo, **ctx.bwd["w"])
    ds = dscale if scale is not None and ctx.needs_input_grad[3] else None
    db = dbias if bias is not None and ctx.needs_input_grad[4] else None
    return dcells, dww, None, ds, db, None, None


class FusedEpilogueFn(torch.autograd.Function):
    """The epilogue-fused engine with its gradient.  Forward: the engine
    (kernel or plain version, by device), saving the post-activation
    output.  Backward (``_epilogue_fn_backward``): the activation-cotangent
    prologue in plain PyTorch, the inverse interleave to the scratch
    layout, then ``fused_engine_bwd_x`` (dcells) and ``fused_engine_bwd_w``
    (dww), on the configurations ``bwd`` names (``_bwd_choices``).  Returns
    the gradients of (cells, ww, inv, scale, bias)."""

    @staticmethod
    def forward(ctx, cells, ww, inv, scale, bias, kw, bwd=None):
        y = _engine.fused_engine(cells, ww, inv, scale=scale, bias=bias, **kw)
        ctx.kw, ctx.bwd = kw, bwd or _bwd_choices()
        ctx.save_for_backward(cells, ww, inv, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        kw = ctx.kw
        geo = dict(pos_idx=kw["pos_idx"], sub_slices=kw["sub_slices"], m=kw["m"], n=kw["n"], ty=kw["ty"],
                   tx=kw["tx"], stride=kw["stride"])
        return _epilogue_fn_backward(ctx, grad, kw["stride"], kw["padding"], _engine.fused_engine_bwd_x,
                                     _engine.fused_engine_bwd_w, geo)


def winograd_deconv2d_cells(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N) this layer's input cell layout
    packed: PackedDeconv,
    dims: DeconvDims,
    in_hw: tuple[int, int],  # the (H, W) the cells were built from
    *,
    m: int = 2,
    r: int = 3,
    backend: str = "cuda",
    epilogue: str = "none",
    scale: torch.Tensor | None = None,  # (M,) per-channel epilogue scale
    bias: torch.Tensor | None = None,  # (M,) per-channel epilogue bias
    emit_cells: bool = False,
    conf: str | None = None,
    splits: int | None = None,
    bwd_x_conf: str | None = None,
    bwd_w_conf: str | None = None,
    bwd_w_splits: int | None = None,
) -> torch.Tensor:
    """Cell-to-cell chained deconv: run the epilogue-fused engine on the cell
    layout and return the NHWC image (B, H_O, W_O, M) or, with
    ``emit_cells``, the next layer's cells (B, ty*S, tx*S, m*m, M).
    ``conf`` / ``splits`` configure the engine's launch and ``bwd_*`` its
    gradient's (``engine.INSTANTIATIONS``; None: the plans' choices; the
    ``ref`` backend has no configuration and ignores them)."""
    tf = get_transform(m, r)
    H, W = in_hw
    hj, wj = dims.j_extent(H), dims.j_extent(W)
    pos_idx, sub_slices, _, _ = packed_layout(dims, m, r)
    kw = dict(
        pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=tf.n,
        ty=-(-hj // m), tx=-(-wj // m),
        out_mode="cells" if emit_cells else "nhwc", activation=epilogue,
        scale=scale, bias=bias, stride=dims.stride, padding=dims.padding,
        out_h=dims.out_size(H), out_w=dims.out_size(W),
    )
    if backend == "cuda":
        kw.update(conf=conf, splits=splits)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (cells, packed.ww, scale, bias)):
            kw = {k: v for k, v in kw.items() if k not in ("scale", "bias")}
            return FusedEpilogueFn.apply(cells.contiguous(), packed.ww, packed.inv, scale, bias, kw,
                                         _bwd_choices(bwd_x_conf, bwd_w_conf, bwd_w_splits))
        return _engine.fused_engine(cells, packed.ww, packed.inv, **kw)
    if backend == "ref":
        return _engine.fused_engine_plain(cells, packed.ww, packed.inv, **kw)
    raise ValueError(f"backend {backend!r} is not 'cuda' or 'ref'")


class FusedPreFn(torch.autograd.Function):
    """The fused pre-PE engine in scratch mode with its gradient (the
    reference's ``_fused_pre_vjp``).  Forward: ``fused_engine`` with
    ``out_mode="scratch"``, the (B, ty, tx, S*S*m*m, M) tile outputs.
    Backward: the cotangent is already in that scratch layout, so it goes
    straight to ``fused_engine_bwd_x`` (dcells) and ``fused_engine_bwd_w``
    (dww) on the configurations ``bwd`` names (``_bwd_choices``), each only
    where a gradient is asked for.  Returns the gradients of (cells, ww,
    inv)."""

    @staticmethod
    def forward(ctx, cells, ww, inv, kw, bwd=None):
        ctx.kw, ctx.bwd = kw, bwd or _bwd_choices()
        ctx.save_for_backward(cells, ww, inv)
        return _engine.fused_engine(cells, ww, inv, out_mode="scratch", **kw)

    @staticmethod
    def backward(ctx, grad):
        cells, ww, inv = ctx.saved_tensors
        geo = {k: ctx.kw[k] for k in ("pos_idx", "sub_slices", "m", "n", "ty", "tx", "stride")}
        g = grad.float().contiguous()
        dcells = dww = None
        if ctx.needs_input_grad[0]:
            dcells = _engine.fused_engine_bwd_x(g, ww, inv, gy=cells.shape[1], gx=cells.shape[2], **geo,
                                                **ctx.bwd["x"])
        if ctx.needs_input_grad[1]:
            dww = _engine.fused_engine_bwd_w(cells, g, inv, **geo, **ctx.bwd["w"])
        return dcells, dww, None, None, None


class EngineFn(torch.autograd.Function):
    """The unfused engine with its gradient (the reference's
    ``_engine_vjp``).  Forward: ``domain_engine`` on the transformed tiles
    xw (T, n*n, N), the (T, S*S*m*m, M) tile outputs; xw is saved for the
    weight gradient.  Backward: ``domain_engine_bwd_x`` (dxw) and
    ``domain_engine_bwd_w`` (dww) on the configurations ``bwd`` names
    (``_bwd_choices``), each only where a gradient is asked for.  Returns the
    gradients of (xw, ww, inv)."""

    @staticmethod
    def forward(ctx, xw, ww, inv, kw, bwd=None):
        ctx.kw, ctx.bwd = kw, bwd or _bwd_choices()
        ctx.save_for_backward(xw, ww, inv)
        return _engine.domain_engine(xw, ww, inv, **kw)

    @staticmethod
    def backward(ctx, grad):
        xw, ww, inv = ctx.saved_tensors
        g = grad.float().contiguous()
        geo = {k: ctx.kw[k] for k in ("pos_idx", "sub_slices", "m2")}
        dxw = dww = None
        if ctx.needs_input_grad[0]:
            dxw = _engine.domain_engine_bwd_x(g, ww, inv, n2=xw.shape[1], **geo, **ctx.bwd["x"])
        if ctx.needs_input_grad[1]:
            dww = _engine.domain_engine_bwd_w(xw, g, inv, **geo, **ctx.bwd["w"])
        return dxw, dww, None, None, None


def winograd_deconv2d_packed(
    x: torch.Tensor,  # (B, H, W, N) NHWC
    packed: PackedDeconv,
    dims: DeconvDims,
    *,
    m: int = 2,
    r: int = 3,
    backend: str = "cuda",
    fuse_pre: bool = False,
    epilogue: str | None = None,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    emit_cells: bool = False,
    conf: str | None = None,
    splits: int | None = None,
    bwd_x_conf: str | None = None,
    bwd_w_conf: str | None = None,
    bwd_w_splits: int | None = None,
) -> torch.Tensor:
    """Winograd DeConv from packed weights on an NHWC image:
    act(scale * deconv(x) + bias), or deconv(x) with no epilogue.

    With an epilogue (or ``emit_cells``) and ``fuse_pre`` it runs the
    epilogue-fused engine on the cells (``winograd_deconv2d_cells``);
    ``emit_cells`` returns the next layer's cell layout and needs
    ``fuse_pre``.  Otherwise the engine runs per layer: ``fuse_pre=True``
    builds the cells and runs the fused pre-PE engine in scratch mode;
    ``fuse_pre=False`` (the default, as in the reference) transforms the
    input tiles in plain PyTorch and runs the unfused engine on them.  The
    tile outputs then interleave into the image, and an epilogue runs in
    plain PyTorch.  ``conf`` / ``splits`` configure the engine's launch
    (``engine.INSTANTIATIONS["fused_engine"]`` with ``fuse_pre``, else
    ``["domain_engine"]``) and ``bwd_*`` its gradient's; None keeps the
    plans' choices, and the ``ref`` backend ignores them."""
    tf = get_transform(m, r)
    B, H, W, N = x.shape
    M = packed.ww.shape[-1]
    S = dims.stride
    HO, WO = dims.out_size(H), dims.out_size(W)
    hj, wj = dims.j_extent(H), dims.j_extent(W)
    wants_epi = emit_cells or epilogue is not None or scale is not None or bias is not None
    choice = dict(conf=conf, splits=splits)
    bwd = _bwd_choices(bwd_x_conf, bwd_w_conf, bwd_w_splits)
    if wants_epi and fuse_pre:
        return winograd_deconv2d_cells(
            cells_from_image(x, dims, m, r), packed, dims, (H, W),
            m=m, r=r, backend=backend, epilogue=epilogue or "none",
            scale=scale, bias=bias, emit_cells=emit_cells, **choice,
            bwd_x_conf=bwd_x_conf, bwd_w_conf=bwd_w_conf, bwd_w_splits=bwd_w_splits,
        )
    if emit_cells:
        raise ValueError("emit_cells requires fuse_pre")
    if backend not in ("cuda", "ref"):
        raise ValueError(f"backend {backend!r} is not 'cuda' or 'ref'")

    pos_idx, sub_slices, _, _ = packed_layout(dims, m, r)
    x_pad, (ty, tx) = pad_input_for_tiles(x, dims, m, r)
    if fuse_pre:
        cells = cells_layout(x_pad, ty, tx, m, tf.n).contiguous()
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=tf.n, ty=ty, tx=tx, stride=S,
                  padding=dims.padding, out_h=HO, out_w=WO)
        if backend == "ref":
            y = _engine.fused_engine_plain(cells, packed.ww, packed.inv, out_mode="scratch", **kw)
        elif torch.is_grad_enabled() and (cells.requires_grad or packed.ww.requires_grad):
            y = FusedPreFn.apply(cells, packed.ww, packed.inv, {**kw, **choice}, bwd)
        else:
            y = _engine.fused_engine(cells, packed.ww, packed.inv, out_mode="scratch", **kw, **choice)
    else:
        xw = transform_input_tiles(x_pad, (ty, tx), m, r).to(x.dtype).reshape(B * ty * tx, tf.n**2, N)
        xw = xw.contiguous()
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=m * m)
        if backend == "ref":
            y = _engine.domain_engine_plain(xw, packed.ww, packed.inv, **kw)
        elif torch.is_grad_enabled() and (xw.requires_grad or packed.ww.requires_grad):
            y = EngineFn.apply(xw, packed.ww, packed.inv, {**kw, **choice}, bwd)
        else:
            y = _engine.domain_engine(xw, packed.ww, packed.inv, **kw, **choice)

    # (T, S*S*m*m, M) -> (S, S, B, ty*m, tx*m, M) -> interleave
    y = y.reshape(B, ty, tx, S, S, m, m, M).permute(3, 4, 0, 1, 5, 2, 6, 7).reshape(S, S, B, ty * m, tx * m, M)
    out = interleave_crop(y[:, :, :, :hj, :wj, :].to(x.dtype), dims, (HO, WO))
    if wants_epi:  # the unfused and scratch paths: the epilogue in plain PyTorch
        out = epilogue_apply_ref(out, scale, bias, epilogue or "none")
    return out.to(x.dtype)


def winograd_deconv2d_fused(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims, *, m: int = 2, r: int = 3,
                            **kw) -> torch.Tensor:
    """``winograd_deconv2d_packed`` on raw (K_D, K_D, N, M) weights, packed
    on every call (so the gradient reaches ``w`` through the pack); hot
    paths ``prepack`` once."""
    return winograd_deconv2d_packed(x, prepack(w, dims, m, r), dims, m=m, r=r, **kw)


# ---------------------------------------------------------------------------
# Strided conv: the engine's conv corner.  The S^2 input phases play the
# sub-filters' role: packed (C, N, M) weights whose positions index the
# S^2*n^2 phase-major space, one shared inverse transform, one m x m output
# tile.  Same prepack-then-apply API as the deconv side.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def conv_packed_layout(cdims: ConvDims, m: int = 2, r: int = 3):
    """Static packed layout of a strided conv: each kept position's index
    into the S^2*n^2 phase-major Winograd space (also the pack's gather
    index) and its packed inverse-transform row.

    Returns (pos_idx, inv_packed_np, plan)."""
    sp = conv_plan(cdims, m, r)
    tf = get_transform(m, r)
    n = tf.n
    AT = np.asarray(tf.AT)
    S = cdims.stride
    pos_idx: list[int] = []
    inv_rows: list[np.ndarray] = []
    for ry in range(S):
        for rx in range(S):
            s = ry * S + rx
            for u in range(n):
                for v in range(n):
                    if sp.masks_winograd[ry, rx, u, v]:
                        pos_idx.append(s * n * n + u * n + v)
                        inv_rows.append(np.outer(AT[:, u], AT[:, v]).reshape(m * m))
    return tuple(pos_idx), np.stack(inv_rows).astype(np.float32), sp


def pack_conv_weights(w: torch.Tensor, cdims: ConvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """Conv weights (K, K, N, M) -> packed Winograd-domain (C, N, M): only
    the structurally nonzero positions of the G-transformed phase
    sub-filters (C = 36 of 64 for K4S2, 16 for K3S1)."""
    pos_idx, _, _ = conv_packed_layout(cdims, m, r)
    ww = transform_conv_weights(w, cdims, m, r)  # (S, S, n, n, N, M)
    flat = ww.reshape(-1, *ww.shape[4:])
    return flat[torch.as_tensor(pos_idx, device=w.device)].to(w.dtype).contiguous()


class PackedConv(NamedTuple):
    """Pre-packed Winograd-domain conv weights: ``ww`` is the trainable
    leaf, ``inv`` the static packed inverse transform."""

    ww: torch.Tensor  # (C, N, M)
    inv: torch.Tensor  # (C, m2) fp32


def conv_packed_inv(cdims: ConvDims, device, m: int = 2, r: int = 3) -> torch.Tensor:
    """The static (C, m2) inverse-transform rows of ``cdims`` on ``device``,
    copied there once and cached."""
    return _conv_inv_on(cdims, m, r, str(torch.device(device)))


@device_constant(maxsize=64)
def _conv_inv_on(cdims: ConvDims, m: int, r: int, device: str) -> torch.Tensor:
    return torch.as_tensor(conv_packed_layout(cdims, m, r)[1], device=device)


def prepack_conv(w: torch.Tensor, cdims: ConvDims, m: int = 2, r: int = 3) -> PackedConv:
    """One-time G-transform + zero-skipping pack of raw conv weights."""
    return PackedConv(pack_conv_weights(w, cdims, m, r), conv_packed_inv(cdims, w.device, m, r))


@functools.lru_cache(maxsize=None)
def _unpack_matrix(dims, m: int, r: int) -> np.ndarray:
    """(K^2, C) least-squares inverse of the linear pack map w -> packed ww
    (spatial taps only: the map acts on each (N, M) pair alike), in
    float64.  The pack is injective (G has full column rank and every tap
    reaches a kept position), so the pinv recovers raw weights exactly from
    consistently packed ones and projects trained ones by least squares."""
    K = dims.kernel
    pack = pack_conv_weights if isinstance(dims, ConvDims) else pack_weights
    cols = []
    for k in range(K * K):
        basis = torch.zeros((K, K, 1, 1), dtype=torch.float64)
        basis[k // K, k % K, 0, 0] = 1.0
        cols.append(pack(basis, dims, m, r).reshape(-1).numpy())
    return np.linalg.pinv(np.stack(cols, axis=1))


def unpack_weights(ww_packed: torch.Tensor, dims, m: int = 2, r: int = 3) -> torch.Tensor:
    """Packed Winograd-domain (C, N, M) -> raw (K, K, N, M) weights by least
    squares through the G-transform and the pack: the checkpoint-export
    inverse of ``pack_weights`` / ``pack_conv_weights`` (``dims``, a
    ``DeconvDims`` or a ``ConvDims``, picks the family)."""
    K = dims.kernel
    pinv = torch.as_tensor(_unpack_matrix(dims, m, r), dtype=ww_packed.dtype, device=ww_packed.device)
    w = torch.einsum("kc,cnm->knm", pinv, ww_packed)
    return w.reshape(K, K, *ww_packed.shape[1:])


def _conv_tiles(cdims: ConvDims, hw: tuple[int, int], m: int, r: int):
    """(ty, tx, gy, gx, H_O, W_O) of a conv layer on an (H, W) input."""
    q = -(-get_transform(m, r).n // m)
    HO, WO = cdims.out_size(hw[0]), cdims.out_size(hw[1])
    ty, tx = -(-HO // m), -(-WO // m)
    return ty, tx, ty + q - 1, tx + q - 1, HO, WO


def _phase_perm(cdims: ConvDims) -> list[int]:
    """Input phase of each tap residue: cells hold phases in residue order."""
    return [cdims.phase_of(rho) for rho in range(cdims.stride)]


def conv_cells_from_image(x: torch.Tensor, cdims: ConvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """NHWC input -> the conv engine's phase-major cells (B, Gy, Gx,
    S^2*m*m, N): de-interleave the S^2 input phases, order them by tap
    residue (``phase_of``), pad every phase left by L cells and
    space-to-depth each by the tile stride m."""
    B, H, W, N = x.shape
    S, L = cdims.stride, cdims.phase_pad
    _, _, gy, gx, _, _ = _conv_tiles(cdims, (H, W), m, r)
    hp = max(-(-H // S), gy * m - L)
    wp = max(-(-W // S), gx * m - L)
    xp = F.pad(x, (0, 0, 0, S * wp - W, 0, S * hp - H))
    phases = xp.reshape(B, hp, S, wp, S, N).permute(0, 2, 4, 1, 3, 5)  # (B, phi_y, phi_x, hp, wp, N)
    perm = torch.as_tensor(_phase_perm(cdims), device=x.device)
    pairs = phases.index_select(1, perm).index_select(2, perm)
    pairs = F.pad(pairs, (0, 0, L, 0, L, 0))[:, :, :, : gy * m, : gx * m, :]
    cells = pairs.reshape(B, S, S, gy, m, gx, m, N).permute(0, 3, 5, 1, 2, 4, 6, 7)
    return cells.reshape(B, gy, gx, S * S * m * m, N).contiguous()


def conv_chain_aligned(cdims: ConvDims, next_cdims: ConvDims, m: int = 2) -> bool:
    """True when this conv layer's emitted cells become the next conv
    layer's phase-major cells by whole-cell moves: the next stride equals
    the cell stride m, so each output cell is one phase pair of the next
    layer (every discriminator hop).  The reference also chains a
    unit-stride hop on a cell-aligned pad; no port model takes one, so it
    is not carried here."""
    return next_cdims.stride == m


def conv_cells_to_next(
    emitted: torch.Tensor,  # (B, ty, tx, m*m, M) from emit_cells
    cdims: ConvDims,
    next_cdims: ConvDims,
    out_hw: tuple[int, int],  # this layer's (H_O, W_O) = the next layer's input
    m: int = 2,
    r: int = 3,
) -> torch.Tensor:
    """A conv layer's emitted cells -> the next conv layer's phase-major
    cells.  With S' = m, emitted cell row m*g + p - L' intra (phi_y, phi_x)
    is pixel (m*g + p, ...) of the next layer's phase (phi_y, phi_x): pad by
    L' cell rows and columns, then regroup, a static relayout."""
    if not conv_chain_aligned(cdims, next_cdims, m):
        raise ValueError(f"conv cell layouts misaligned: next stride {next_cdims.stride} "
                         f"is not the cell stride m={m}")
    _, _, gy2, gx2, _, _ = _conv_tiles(next_cdims, out_hw, m, r)
    L2 = next_cdims.phase_pad
    B, R, Cc, _, nch = emitted.shape
    arr = F.pad(emitted, (0, 0, 0, 0, L2, max(0, gx2 * m - L2 - Cc), L2, max(0, gy2 * m - L2 - R)))
    arr = arr[:, : gy2 * m, : gx2 * m].reshape(B, gy2, m, gx2, m, m, m, nch)  # (b, g, p, g', q, phi_y, phi_x, c)
    perm = torch.as_tensor(_phase_perm(next_cdims), device=emitted.device)
    arr = arr.index_select(5, perm).index_select(6, perm)  # phases -> residue pairs
    return arr.permute(0, 1, 3, 5, 6, 2, 4, 7).reshape(B, gy2, gx2, m**4, nch).contiguous()


class ConvEpilogueFn(torch.autograd.Function):
    """The conv engine with its gradient.  Forward: the conv kernel (or its
    plain version, by device), saving the post-activation output.
    Backward: ``_epilogue_fn_backward`` with the conv corner's uncell (cells
    mode: re-zero outside [0, out_h) x [0, out_w); nhwc: pad back at offset
    0), then ``conv_fused_engine_bwd_x`` (dcells) and
    ``conv_fused_engine_bwd_w`` (dww) on the configurations ``bwd`` names
    (``_bwd_choices``), each only where a gradient is asked for.  Returns
    the gradients of (cells, ww, inv, scale, bias)."""

    @staticmethod
    def forward(ctx, cells, ww, inv, scale, bias, kw, bwd=None):
        y = _engine.conv_fused_engine(cells, ww, inv, scale=scale, bias=bias, **kw)
        ctx.kw, ctx.bwd = kw, bwd or _bwd_choices()
        ctx.save_for_backward(cells, ww, inv, scale, bias, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        geo = {k: ctx.kw[k] for k in ("pos_idx", "m", "n", "ty", "tx", "s2")}
        return _epilogue_fn_backward(ctx, grad, 1, 0, _engine.conv_fused_engine_bwd_x,
                                     _engine.conv_fused_engine_bwd_w, geo)


def winograd_conv2d_cells(
    cells: torch.Tensor,  # (B, Gy, Gx, S^2*m*m, N) phase-major cell layout
    packed: PackedConv,
    cdims: ConvDims,
    in_hw: tuple[int, int],  # the (H, W) the cells were built from
    *,
    m: int = 2,
    r: int = 3,
    backend: str = "cuda",
    epilogue: str = "none",
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    emit_cells: bool = False,
    conf: str | None = None,
    splits: int | None = None,
    bwd_x_conf: str | None = None,
    bwd_w_conf: str | None = None,
    bwd_w_splits: int | None = None,
) -> torch.Tensor:
    """Cell-to-cell chained Winograd conv: run the conv engine on the
    phase-major cells and return the NHWC image (B, H_O, W_O, M) or, with
    ``emit_cells``, the output image's cells (B, ty, tx, m*m, M) for
    ``conv_cells_to_next``.  ``conf`` / ``splits`` configure the engine's
    launch and ``bwd_*`` its gradient's (``engine.INSTANTIATIONS``; None:
    the plans' choices; the ``ref`` backend ignores them)."""
    ty, tx, _, _, HO, WO = _conv_tiles(cdims, in_hw, m, r)
    pos_idx, _, _ = conv_packed_layout(cdims, m, r)
    kw = dict(pos_idx=pos_idx, m=m, n=get_transform(m, r).n, ty=ty, tx=tx, s2=cdims.stride ** 2,
              out_mode="cells" if emit_cells else "nhwc", activation=epilogue, out_h=HO, out_w=WO)
    if backend == "cuda":
        kw.update(conf=conf, splits=splits)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (cells, packed.ww, scale, bias)):
            return ConvEpilogueFn.apply(cells.contiguous(), packed.ww, packed.inv, scale, bias, kw,
                                        _bwd_choices(bwd_x_conf, bwd_w_conf, bwd_w_splits))
        return _engine.conv_fused_engine(cells, packed.ww, packed.inv, scale=scale, bias=bias, **kw)
    if backend == "ref":
        return _engine.conv_fused_engine_plain(cells, packed.ww, packed.inv, scale=scale, bias=bias, **kw)
    raise ValueError(f"backend {backend!r} is not 'cuda' or 'ref'")


def winograd_conv2d_packed(
    x: torch.Tensor,  # (B, H, W, N) NHWC
    packed: PackedConv,
    cdims: ConvDims,
    *,
    m: int = 2,
    r: int = 3,
    backend: str = "cuda",
    epilogue: str | None = None,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    emit_cells: bool = False,
    **choices,
) -> torch.Tensor:
    """Strided Winograd conv from packed weights on an NHWC image:
    act(scale * conv(x) + bias) through the conv engine; ``emit_cells``
    returns the output's cells for the next chained conv layer.
    ``choices``: the launches' configurations, as
    ``winograd_conv2d_cells`` takes them."""
    return winograd_conv2d_cells(
        conv_cells_from_image(x, cdims, m, r), packed, cdims, (x.shape[1], x.shape[2]),
        m=m, r=r, backend=backend, epilogue=epilogue or "none", scale=scale, bias=bias, emit_cells=emit_cells,
        **choices,
    )


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor, cdims: ConvDims, **kw) -> torch.Tensor:
    """``winograd_conv2d_packed`` on raw (K, K, N, M) conv weights, packed on
    every call; hot paths ``prepack_conv`` once."""
    return winograd_conv2d_packed(x, prepack_conv(w, cdims), cdims, **kw)


# ---------------------------------------------------------------------------
# 1D Winograd (de)conv: the rank-1 instantiations of the engine.  Stride-1
# conv1d is one sub-filter over all n positions; the 1D TDC deconv (the
# audio decoder) packs the S flipped sub-kernels' structural nonzeros and
# interleaves their outputs in the engine's finalize.  The cells are the
# padded sequence space-to-depth by the tile stride m: (B, Gy, m, N).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def conv1d_layout(kernel: int, m: int = 2):
    """Static packed layout of a stride-1 conv1d under F(m, K): every one of
    the n = m + K - 1 positions is kept (a dense 1D kernel has no structural
    zeros), one sub-filter spans them all.

    Returns (pos_idx, sub_slices, inv_packed_np, bt_mat, n)."""
    tf = get_transform(m, kernel)
    inv = np.ascontiguousarray(np.asarray(tf.AT).T).astype(np.float32)  # (n, m)
    return tuple(range(tf.n)), ((0, tf.n),), inv, _engine._bt(m, tf.n), tf.n


@functools.lru_cache(maxsize=None)
def packed_deconv1d_layout(dims: DeconvDims, m: int = 2, r: int = 3):
    """Static packed layout of a 1D TDC deconv: positions into the shared
    n-space, per-residue sub-filter slices, and the packed 1D inverse
    transform rows of the structurally nonzero positions.

    Returns (pos_idx, sub_slices, inv_packed_np, keeps)."""
    sp = plan_1d(dims, m, r)
    tf = get_transform(m, r)
    AT = np.asarray(tf.AT)
    pos_idx: list[int] = []
    sub_slices: list[tuple[int, int]] = []
    inv_rows: list[np.ndarray] = []
    keeps: list[list[int]] = []
    for rho in range(dims.stride):
        keep = [u for u in range(tf.n) if sp.masks_winograd[rho][u]]
        lo = len(pos_idx)
        for u in keep:
            pos_idx.append(u)
            inv_rows.append(AT[:, u])
        sub_slices.append((lo, len(pos_idx)))
        keeps.append(keep)
    inv = np.stack(inv_rows).astype(np.float32) if inv_rows else np.zeros((0, m), np.float32)
    return tuple(pos_idx), tuple(sub_slices), inv, keeps


@device_constant(maxsize=64)
def _g_on(m: int, r: int, device: str) -> torch.Tensor:
    """G of F(m, r) on ``device``, copied there once: a pageable host copy
    per call would wait for the stream to drain."""
    return torch.as_tensor(np.asarray(get_transform(m, r).G), dtype=torch.float32, device=device)


@device_constant(maxsize=64)
def _pack1d_idx_on(dims: DeconvDims, m: int, r: int, device: str) -> torch.Tensor:
    """Packed row -> flat (S*n) index into the transformed sub-kernels, on
    ``device``, copied once."""
    n = get_transform(m, r).n
    keeps = packed_deconv1d_layout(dims, m, r)[3]
    return torch.as_tensor([rho * n + u for rho, keep in enumerate(keeps) for u in keep], device=device)


def pack_conv1d_weights(w: torch.Tensor, kernel: int, m: int = 2) -> torch.Tensor:
    """Conv1d weights (K, N, M) -> packed Winograd-domain (n, N, M) by the 1D
    G-transform (dense: every position is structurally nonzero)."""
    if w.shape[0] != kernel:
        raise ValueError(f"weight tap dim {w.shape[0]} != K={kernel}")
    return torch.einsum("ur,rnm->unm", _g_on(m, kernel, str(w.device)), w.float()).to(w.dtype).contiguous()


def pack_deconv1d_weights(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """Deconv1d weights (K_D, N, M) -> packed Winograd-domain (C, N, M): the
    S flipped sub-kernels, G-transformed, structurally nonzero rows only."""
    idx = _pack1d_idx_on(dims, m, r, str(w.device))
    if not idx.numel():
        return w.new_zeros((0, *w.shape[1:]))
    G = _g_on(m, r, str(w.device))
    wt = torch.einsum("ur,srnm->sunm", G, decompose_weights_1d(w, dims, r).float())  # (S, n, N, M)
    return wt.reshape(-1, *wt.shape[2:])[idx].to(w.dtype).contiguous()


class PackedConv1d(NamedTuple):
    """Pre-packed Winograd-domain 1D (de)conv weights."""

    ww: torch.Tensor  # (C, N, M)
    inv: torch.Tensor  # (C, m) fp32


@device_constant(maxsize=64)
def _inv1d_on(key, device: str) -> torch.Tensor:
    layout = conv1d_layout(*key[1:]) if key[0] == "conv" else packed_deconv1d_layout(*key[1:])
    return torch.as_tensor(layout[2], device=device)


def prepack_conv1d(w: torch.Tensor, kernel: int, m: int = 2) -> PackedConv1d:
    """One-time 1D G-transform of raw stride-1 conv1d weights (K, N, M)."""
    return PackedConv1d(pack_conv1d_weights(w, kernel, m), _inv1d_on(("conv", kernel, m), str(w.device)))


def prepack_deconv1d(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> PackedConv1d:
    """One-time G-transform and zero-skipping pack of raw deconv1d weights."""
    return PackedConv1d(pack_deconv1d_weights(w, dims, m, r), _inv1d_on(("deconv", dims, m, r), str(w.device)))


def conv1d_cells(x_pad: torch.Tensor, ty: int, m: int, n: int) -> torch.Tensor:
    """Padded (B, Lp, N) sequence -> the 1D engine's cell layout (B, Gy, m, N),
    Gy = ty + ceil(n/m) - 1: space-to-depth by the tile stride m."""
    B, Lp, N = x_pad.shape
    need = (ty + -(-n // m) - 1) * m
    x_pad = F.pad(x_pad, (0, 0, 0, max(0, need - Lp)))[:, :need, :]
    return x_pad.reshape(B, need // m, m, N)


def conv1d_cells_from_seq(x: torch.Tensor, kernel: int, m: int = 2, padding: str = "causal"):
    """(B, L, N) sequence -> the cells of a stride-1 conv1d under F(m, K),
    with ``padding``'s left pad and the tile-coverage right pad.  Returns
    (cells, ty, L_O)."""
    n = get_transform(m, kernel).n
    L = x.shape[1]
    pad_lo, pad_hi = _conv1d_pads(kernel, padding)
    LO = L + pad_lo + pad_hi - (kernel - 1)
    ty = -(-LO // m)
    x_pad = F.pad(x, (0, 0, pad_lo, max(0, m * (ty - 1) + n - (L + pad_lo))))
    return conv1d_cells(x_pad, ty, m, n).contiguous(), ty, LO


def deconv1d_cells_from_seq(x: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3):
    """(B, L, N) sequence -> the cells of a 1D TDC deconv under F(m, r): the
    left pad kc - 1 and the tile-coverage right pad.  Returns (cells, ty)."""
    n = get_transform(m, r).n
    L = x.shape[1]
    ty = -(-dims.j_extent(L) // m)
    x_pad = F.pad(x, (0, 0, dims.kc - 1, max(0, m * (ty - 1) + n - (L + dims.kc - 1))))
    return conv1d_cells(x_pad, ty, m, n).contiguous(), ty


class Engine1dFn(torch.autograd.Function):
    """The 1D engine in nlc mode with its gradient (the reference's
    ``_engine1d_vjp``).  Forward: ``winograd_conv1d_fused_engine``, the
    padded interleave (B, ty*m*S, M), no epilogue.  Backward: the inverse
    interleave to the scratch layout (B, ty, S*m, M), then
    ``winograd_conv1d_fused_bwd_x`` (dcells: rank-1 kernel 4, the B-scatter)
    and ``winograd_conv1d_fused_bwd_w`` (dww: the transformed tiles, rank-1
    kernel 5) on the configurations ``bwd`` names (``_bwd_choices``), each
    only where a gradient is asked for.  Returns the gradients of (cells,
    ww, inv)."""

    @staticmethod
    def forward(ctx, cells, ww, inv, kw, bwd=None):
        ctx.kw, ctx.bwd = kw, bwd or _bwd_choices()
        ctx.save_for_backward(cells, ww, inv)
        return _engine.winograd_conv1d_fused_engine(cells, ww, inv, out_mode="nlc", **kw)

    @staticmethod
    def backward(ctx, grad):
        cells, ww, inv = ctx.saved_tensors
        kw = {k: v for k, v in ctx.kw.items() if k not in ("conf", "splits")}
        S, m, ty, bt = kw.pop("stride"), kw["m"], kw["ty"], kw.pop("bt_mat")
        B, M = cells.shape[0], grad.shape[-1]
        # row m*S*j + S*p + rho of the interleave -> scratch row rho*m + p of tile j
        g = grad.float().reshape(B, ty, m, S, M).permute(0, 1, 3, 2, 4).reshape(B, ty, S * m, M).contiguous()
        dcells = dww = None
        if ctx.needs_input_grad[0]:
            dcells = _engine.winograd_conv1d_fused_bwd_x(g, ww, inv, bt, gy=cells.shape[1], **kw, **ctx.bwd["x"])
        if ctx.needs_input_grad[1]:
            dww = _engine.winograd_conv1d_fused_bwd_w(cells, g, inv, bt, **kw, **ctx.bwd["w"])
        return dcells, dww, None, None, None


def _engine1d(cells, packed: PackedConv1d, backend: str, conf=None, splits=None, bwd_x_conf=None, bwd_w_conf=None,
              bwd_w_splits=None, **kw) -> torch.Tensor:
    """The 1D engine in nlc mode on ``backend``: "ref" the plain version
    (autograd differentiates it; no configuration), "cuda" the wrapper on
    ``conf`` / ``splits``, through ``Engine1dFn`` where a gradient is wanted
    (its rank-1 backward launches on ``bwd_*``)."""
    if backend == "ref":
        return _engine.winograd_conv1d_fused_engine_plain(cells, packed.ww, packed.inv, out_mode="nlc", **kw)
    if backend != "cuda":
        raise ValueError(f"backend {backend!r} is not 'cuda' or 'ref'")
    kw.update(conf=conf, splits=splits)
    if torch.is_grad_enabled() and (cells.requires_grad or packed.ww.requires_grad):
        return Engine1dFn.apply(cells, packed.ww, packed.inv, kw, _bwd_choices(bwd_x_conf, bwd_w_conf, bwd_w_splits))
    return _engine.winograd_conv1d_fused_engine(cells, packed.ww, packed.inv, out_mode="nlc", **kw)


def _conv1d_pads(kernel: int, padding: str) -> tuple[int, int]:
    if padding == "causal":
        return kernel - 1, 0
    if padding == "same":
        return (kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2
    if padding == "valid":
        return 0, 0
    raise ValueError(padding)


def winograd_conv1d_packed(
    x: torch.Tensor,  # (B, L, N)
    packed: PackedConv1d,
    kernel: int,
    *,
    m: int = 2,
    padding: str = "causal",  # "causal" | "same" | "valid"
    backend: str = "cuda",
    **choices,
) -> torch.Tensor:
    """Stride-1 Winograd conv1d from packed weights: x (B, L, N) ->
    (B, L_O, M), L_O = L (causal, same) or L - K + 1 (valid).  ``causal``
    left-pads K-1 (output t sees inputs t-K+1 .. t); ``same`` splits the pad
    low-first.  No bias or activation: they belong outside the engine.
    ``choices``: the launches' configurations (conf, splits, bwd_x_conf,
    bwd_w_conf, bwd_w_splits; ``engine.INSTANTIATIONS``)."""
    pos_idx, sub_slices, _, bt_mat, n = conv1d_layout(kernel, m)
    cells, ty, LO = conv1d_cells_from_seq(x, kernel, m, padding)
    y = _engine1d(cells, packed, backend, bt_mat=bt_mat, pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty,
                  stride=1, **choices)
    return y[:, :LO, :].to(x.dtype)


def winograd_conv1d(x: torch.Tensor, w: torch.Tensor, *, m: int = 2, **kw) -> torch.Tensor:
    """``winograd_conv1d_packed`` on raw (K, N, M) conv1d weights
    (cross-correlation taps), packed on every call; hot paths
    ``prepack_conv1d`` once."""
    return winograd_conv1d_packed(x, prepack_conv1d(w, w.shape[0], m), w.shape[0], m=m, **kw)


def winograd_deconv1d_packed(
    x: torch.Tensor,  # (B, L, N)
    packed: PackedConv1d,
    dims: DeconvDims,
    *,
    m: int = 2,
    r: int = 3,
    backend: str = "cuda",
    **choices,
) -> torch.Tensor:
    """1D TDC Winograd deconv from packed weights: x (B, L, N) -> (B, L_O, M),
    L_O = S*(L-1) + K_D - 2P + OP: the S sub-correlations in the engine, the
    stride-S interleave in its finalize, then the crop [P, P + L_O).
    ``choices``: the launches' configurations, as
    ``winograd_conv1d_packed`` takes them."""
    tf = get_transform(m, r)
    pos_idx, sub_slices, _, _ = packed_deconv1d_layout(dims, m, r)
    cells, ty = deconv1d_cells_from_seq(x, dims, m, r)
    LO = dims.out_size(x.shape[1])
    y = _engine1d(cells, packed, backend, bt_mat=_engine._bt(m, tf.n), pos_idx=pos_idx, sub_slices=sub_slices, m=m,
                  n=tf.n, ty=ty, stride=dims.stride, **choices)
    P = dims.padding
    return y[:, P : P + LO, :].to(x.dtype)


def winograd_deconv1d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims, *, m: int = 2, r: int = 3,
                      **kw) -> torch.Tensor:
    """``winograd_deconv1d_packed`` on raw (K_D, N, M) deconv1d weights,
    packed on every call (so the gradient reaches ``w`` through the pack);
    hot paths ``prepack_deconv1d`` once."""
    return winograd_deconv1d_packed(x, prepack_deconv1d(w, dims, m, r), dims, m=m, r=r, **kw)
