"""Plain PyTorch versions of the fused engine (the correctness contracts).

Each function mirrors its counterpart in the reference package's
``kernels/ref.py`` argument for argument and runs on any device.  The
fused-engine wrapper takes ``fused_epilogue_engine_ref`` for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
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
