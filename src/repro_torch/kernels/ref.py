"""Plain PyTorch versions of the fused engine (the correctness contracts).

Each function mirrors its counterpart in the reference package's
``kernels/ref.py`` argument for argument and runs on any device.  The
fused-engine wrapper takes ``fused_epilogue_engine_ref`` for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.  The
backward oracles (``*_bwd_*_ref``) are the plain versions of the two
backward kernels in the same way.  ``conv_engine_ref`` and the
``conv_engine_bwd_*_ref`` pair are the same contracts at the strided conv's
corner of the engine (S^2 input phases, one sub-filter, stride 1).
"""
from __future__ import annotations

import torch

__all__ = [
    "LEAKY_SLOPE",
    "EPILOGUE_ACTIVATIONS",
    "engine_ref",
    "fused_pre_engine_ref",
    "epilogue_apply_ref",
    "interleave_tiles_ref",
    "fused_epilogue_engine_ref",
    "engine_bwd_x_ref",
    "engine_bwd_w_ref",
    "fused_pre_engine_bwd_x_ref",
    "fused_pre_engine_bwd_w_ref",
    "conv_pre_engine_ref",
    "conv_engine_ref",
    "conv_engine_bwd_x_ref",
    "conv_engine_bwd_w_ref",
]

LEAKY_SLOPE = 0.2  # must match models.layers.leaky_relu

EPILOGUE_ACTIVATIONS = ("none", "relu", "leaky_relu", "tanh")


def engine_ref(
    xw: torch.Tensor,  # (T, n2, N) transformed input tiles
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """com-PE + post-PE on transformed tiles: returns (T, S2*m2, M)."""
    T = xw.shape[0]
    M = ww_packed.shape[-1]
    pos = torch.as_tensor(pos_idx, dtype=torch.long, device=xw.device)
    xg = xw[:, pos, :].float()  # (T, C, N)
    y = torch.einsum("tcn,cnm->ctm", xg, ww_packed.float())  # (C, T, M)
    inv = inv_packed.float()
    outs = []
    for lo, hi in sub_slices:
        if hi == lo:  # structurally empty sub-filter (K_D < S)
            outs.append(xw.new_zeros((T, m2, M), dtype=torch.float32))
            continue
        outs.append(torch.einsum("ctm,ca->tam", y[lo:hi], inv[lo:hi]))
    return torch.cat(outs, dim=1).to(xw.dtype)


def fused_pre_engine_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N) space-to-depth padded input
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    bt_mat,  # (n, n) B^T
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    m2: int,
) -> torch.Tensor:
    """Fused pre-PE engine: cells in, (B, ty, tx, S2*m2, M) out, with the
    B-transform done by plain gathers and an einsum."""
    B, Gy, Gx, _, N = cells.shape
    M = ww_packed.shape[-1]
    dev = cells.device
    img = cells.reshape(B, Gy, Gx, m, m, N).permute(0, 1, 3, 2, 4, 5).reshape(B, Gy * m, Gx * m, N)
    idx_y = (m * torch.arange(ty, device=dev))[:, None] + torch.arange(n, device=dev)[None, :]
    idx_x = (m * torch.arange(tx, device=dev))[:, None] + torch.arange(n, device=dev)[None, :]
    tiles = img[:, idx_y][:, :, :, idx_x]  # (B, ty, n, tx, n, N)
    tiles = tiles.permute(0, 1, 3, 2, 4, 5)  # (B, ty, tx, n, n, N)
    bt = torch.as_tensor(bt_mat, dtype=torch.float32, device=dev)
    xw = torch.einsum("ua,zyxabc,vb->zyxuvc", bt, tiles.float(), bt).to(cells.dtype)
    y = engine_ref(
        xw.reshape(B * ty * tx, n * n, N), ww_packed, inv_packed,
        pos_idx=pos_idx, sub_slices=sub_slices, m2=m2,
    )
    return y.reshape(B, ty, tx, -1, M)


def epilogue_apply_ref(y, scale, bias, activation: str):
    """Per-channel affine over the trailing axis, then the activation, in fp32."""
    y = y.float()
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    if activation == "relu":
        y = torch.clamp_min(y, 0.0)
    elif activation == "leaky_relu":
        y = torch.where(y >= 0, y, LEAKY_SLOPE * y)
    elif activation == "tanh":
        y = torch.tanh(y)
    elif activation != "none":
        raise ValueError(f"unsupported epilogue activation {activation!r}")
    return y


def interleave_tiles_ref(y, ty: int, tx: int, m: int, stride: int):
    """(B, ty, tx, S2*m2, M) -> the padded depth-to-space interleave
    (B, ty*m*S, tx*m*S, M): sub-pixel (ry, rx, p, q) of tile (j, t) lands
    at row m*S*j + S*p + ry, col m*S*t + S*q + rx."""
    B, M = y.shape[0], y.shape[-1]
    S = stride
    y = y.reshape(B, ty, tx, S, S, m, m, M)
    return y.permute(0, 1, 5, 3, 2, 6, 4, 7).reshape(B, ty * m * S, tx * m * S, M)


def fused_epilogue_engine_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N)
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    bt_mat,  # (n, n) B^T
    scale,  # (M,) or None
    bias,  # (M,) or None
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    m2: int,
    out_mode: str,  # "nhwc" | "cells"
    activation: str,
    stride: int,
    padding: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Epilogue-fused engine: the padded interleave (B, ty*m*S, tx*m*S, M)
    ("nhwc") or the next layer's cells (B, ty*S, tx*S, m*m, M) ("cells"),
    with pixels outside [P, P+H_O) x [P, P+W_O) zeroed in cells mode."""
    y = fused_pre_engine_ref(
        cells, ww_packed, inv_packed, bt_mat,
        pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, m2=m2,
    )
    img = epilogue_apply_ref(interleave_tiles_ref(y, ty, tx, m, stride), scale, bias, activation)
    if out_mode == "nhwc":
        return img.to(cells.dtype)
    if out_mode != "cells":
        raise ValueError(out_mode)
    B, R, Cc, M = img.shape
    dev = img.device
    rows = torch.arange(R, device=dev)
    cols = torch.arange(Cc, device=dev)
    rmask = (rows >= padding) & (rows < padding + out_h)
    cmask = (cols >= padding) & (cols < padding + out_w)
    img = torch.where(rmask[None, :, None, None] & cmask[None, None, :, None], img, 0.0)
    out = img.reshape(B, ty * stride, m, tx * stride, m, M).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, ty * stride, tx * stride, m * m, M).to(cells.dtype)


# ------------------------------------------------------------- backward
# Oracles for the backward engines.  Both cotangents of the forward engine
# are packed Winograd-domain contractions:
#   gw[p,t,m]  = sum_a inv[p,a] * g[t, s(p)*m2+a, m]
#   dxw[t,j,n] = sum_{p: pos_p=j} sum_m gw[p,t,m] * ww[p,n,m]
#   dww[p,n,m] = sum_t xw[t,pos_p,n] * gw[p,t,m]


def _gw_ref(g, inv_packed, sub_slices, m2):
    """Inverse-transform-weighted cotangent (C, T, M) fp32."""
    parts = []
    for s, (lo, hi) in enumerate(sub_slices):
        if hi == lo:
            continue
        parts.append(torch.einsum("ca,tam->ctm", inv_packed[lo:hi].float(),
                                  g[:, s * m2 : (s + 1) * m2, :].float()))
    return torch.cat(parts, dim=0)


def engine_bwd_x_ref(
    g: torch.Tensor,  # (T, S2*m2, M)
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
    n2: int,
) -> torch.Tensor:
    """Oracle for the input-tile cotangent: returns (T, n2, N)."""
    T = g.shape[0]
    N = ww_packed.shape[1]
    gw = _gw_ref(g, inv_packed, sub_slices, m2)  # (C, T, M)
    d = torch.einsum("ctm,cnm->tcn", gw, ww_packed.float())  # (T, C, N)
    dxw = g.new_zeros((T, n2, N), dtype=torch.float32)
    pos = torch.as_tensor(pos_idx, dtype=torch.long, device=g.device)
    dxw.index_add_(1, pos, d)  # repeated positions accumulate
    return dxw.to(g.dtype)


def engine_bwd_w_ref(
    xw: torch.Tensor,  # (T, n2, N)
    g: torch.Tensor,  # (T, S2*m2, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m2: int,
) -> torch.Tensor:
    """Oracle for the packed-weight cotangent: returns (C, N, M)."""
    gw = _gw_ref(g, inv_packed, sub_slices, m2)  # (C, T, M)
    pos = torch.as_tensor(pos_idx, dtype=torch.long, device=xw.device)
    xg = xw[:, pos, :].float()  # (T, C, N)
    return torch.einsum("tcn,ctm->cnm", xg, gw).to(g.dtype)


def fused_pre_engine_bwd_x_ref(
    g: torch.Tensor,  # (B, ty, tx, S2*m2, M)
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    m2: int,
) -> torch.Tensor:
    """Oracle for the fused engine's cell-layout input cotangent
    (B, gy, gx, m*m, N): the VJP of the (linear-in-cells) reference forward,
    evaluated at zero primal.  Rows and columns the forward never reads get
    zero."""
    cells0 = g.new_zeros((g.shape[0], gy, gx, m * m, ww_packed.shape[1]))
    _, vjp = torch.func.vjp(
        lambda c: fused_pre_engine_ref(
            c, ww_packed, inv_packed, bt_mat,
            pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, m2=m2,
        ),
        cells0,
    )
    return vjp(g)[0]


def fused_pre_engine_bwd_w_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, m*m, N)
    g: torch.Tensor,  # (B, ty, tx, S2*m2, M)
    inv_packed: torch.Tensor,
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    sub_slices: tuple[tuple[int, int], ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    m2: int,
) -> torch.Tensor:
    """Oracle for the fused engine's packed-weight cotangent (C, N, M): the
    VJP of the (linear-in-weights) reference forward at zero primal."""
    ww0 = g.new_zeros((len(pos_idx), cells.shape[-1], g.shape[-1]))
    _, vjp = torch.func.vjp(
        lambda w: fused_pre_engine_ref(
            cells, w, inv_packed, bt_mat,
            pos_idx=pos_idx, sub_slices=sub_slices, m=m, n=n, ty=ty, tx=tx, m2=m2,
        ),
        ww0,
    )
    return vjp(g)[0]


# ------------------------------------------------------------- conv corner
# The strided conv runs on the same engine with the roles turned: the cells
# hold S^2 de-interleaved input phases (phase-major, (B, Gy, Gx, S^2*m*m, N)),
# the packed positions index the concatenated S^2*n^2 Winograd space, and
# all of them sum through one inverse transform into one m x m output tile.


def conv_pre_engine_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, s2*m*m, N) phase-major cell layout
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    bt_mat,  # (n, n) B^T
    *,
    pos_idx: tuple[int, ...],  # into the s2*n^2 phase-major position space
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
) -> torch.Tensor:
    """The conv engine's products before the epilogue, (B, ty, tx, m*m, M):
    per phase, rebuild the phase image from its cells, gather the
    overlapping tiles and B-transform them; contract the packed positions
    and sum them through the shared inverse transform."""
    B, Gy, Gx, _, N = cells.shape
    M = ww_packed.shape[-1]
    m2 = m * m
    dev = cells.device
    idx_y = (m * torch.arange(ty, device=dev))[:, None] + torch.arange(n, device=dev)[None, :]
    idx_x = (m * torch.arange(tx, device=dev))[:, None] + torch.arange(n, device=dev)[None, :]
    bt = torch.as_tensor(bt_mat, dtype=torch.float32, device=dev)
    xws = []
    for s in range(s2):
        sub = cells[:, :, :, s * m2 : (s + 1) * m2, :]
        img = sub.reshape(B, Gy, Gx, m, m, N).permute(0, 1, 3, 2, 4, 5).reshape(B, Gy * m, Gx * m, N)
        tiles = img[:, idx_y][:, :, :, idx_x].permute(0, 1, 3, 2, 4, 5)  # (B, ty, tx, n, n, N)
        xw = torch.einsum("ua,zyxabc,vb->zyxuvc", bt, tiles.float(), bt)
        xws.append(xw.reshape(B * ty * tx, n * n, N))
    xw_all = torch.cat(xws, dim=1)  # (T, s2*n2, N)
    pos = torch.as_tensor(pos_idx, dtype=torch.long, device=dev)
    xg = xw_all[:, pos, :]  # (T, C, N)
    yc = torch.einsum("tcn,cnm->ctm", xg, ww_packed.float())
    y = torch.einsum("ctm,ca->tam", yc, inv_packed.float())  # (T, m2, M)
    return y.reshape(B, ty, tx, m2, M).to(cells.dtype)


def conv_engine_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, s2*m*m, N)
    ww_packed: torch.Tensor,  # (C, N, M)
    inv_packed: torch.Tensor,  # (C, m2) fp32
    bt_mat,  # (n, n) B^T
    scale,  # (M,) or None
    bias,  # (M,) or None
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
    out_mode: str,  # "nhwc" | "cells"
    activation: str,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """The fused Winograd conv engine with its epilogue: the output-image
    pixels (B, ty*m, tx*m, M) ("nhwc", uncropped) or their cell layout
    (B, ty, tx, m*m, M) with everything outside [0, out_h) x [0, out_w)
    zeroed ("cells")."""
    y = conv_pre_engine_ref(cells, ww_packed, inv_packed, bt_mat, pos_idx=pos_idx, m=m, n=n,
                            ty=ty, tx=tx, s2=s2)
    B, M = y.shape[0], y.shape[-1]
    img = y.reshape(B, ty, tx, m, m, M).permute(0, 1, 3, 2, 4, 5).reshape(B, ty * m, tx * m, M)
    img = epilogue_apply_ref(img, scale, bias, activation)
    if out_mode == "nhwc":
        return img.to(cells.dtype)
    if out_mode != "cells":
        raise ValueError(out_mode)
    dev = img.device
    rows = torch.arange(ty * m, device=dev) < out_h
    cols = torch.arange(tx * m, device=dev) < out_w
    img = torch.where(rows[None, :, None, None] & cols[None, None, :, None], img, 0.0)
    out = img.reshape(B, ty, m, tx, m, M).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(B, ty, tx, m * m, M).to(cells.dtype)


def conv_engine_bwd_x_ref(
    g: torch.Tensor,  # (B, ty, tx, m2, M) cotangent of the products
    ww_packed: torch.Tensor,
    inv_packed: torch.Tensor,
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    gy: int,
    gx: int,
    s2: int,
) -> torch.Tensor:
    """dL/dcells (B, gy, gx, s2*m*m, N) of the conv engine's products: the
    VJP of the (linear-in-cells) ``conv_pre_engine_ref`` at zero primal.
    Rows and columns the forward never reads get zero."""
    cells0 = g.new_zeros((g.shape[0], gy, gx, s2 * m * m, ww_packed.shape[1]))
    _, vjp = torch.func.vjp(
        lambda c: conv_pre_engine_ref(c, ww_packed, inv_packed, bt_mat, pos_idx=pos_idx, m=m, n=n,
                                      ty=ty, tx=tx, s2=s2),
        cells0,
    )
    return vjp(g)[0]


def conv_engine_bwd_w_ref(
    cells: torch.Tensor,  # (B, Gy, Gx, s2*m*m, N)
    g: torch.Tensor,  # (B, ty, tx, m2, M)
    inv_packed: torch.Tensor,
    bt_mat,
    *,
    pos_idx: tuple[int, ...],
    m: int,
    n: int,
    ty: int,
    tx: int,
    s2: int,
) -> torch.Tensor:
    """dL/dww (C, N, M) of the conv engine's products: the VJP of the
    (linear-in-weights) ``conv_pre_engine_ref`` at zero primal."""
    ww0 = g.new_zeros((len(pos_idx), cells.shape[-1], g.shape[-1]))
    _, vjp = torch.func.vjp(
        lambda w: conv_pre_engine_ref(cells, w, inv_packed, bt_mat, pos_idx=pos_idx, m=m, n=n,
                                      ty=ty, tx=tx, s2=s2),
        ww0,
    )
    return vjp(g)[0]
