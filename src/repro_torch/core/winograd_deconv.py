"""Winograd DeConv (the paper's Sec. III) in plain PyTorch.

  1. TDC: split deconv weights into S^2 flipped sub-kernels padded to r x r.
  2. G-transform each sub-kernel: W_w = G ghat G^T -> (S, S, n, n, N, M).
  3. ``transform_input_tiles``: n x n input tiles at stride m, B^T Z B.
  4-5. ``winograd_domain_matmuls``: per sub-filter, the channel contraction
     of its structurally nonzero positions and the sparse inverse transform.

The structural zeros of W_w (Cases 1/2/3) follow from (K_D, S) alone;
``kernels.ops.pack_weights`` keeps only the nonzero positions.
``transform_conv_weights`` is the strided conv's mirror: phase sub-kernels,
not flipped, G-transformed the same way.  ``winograd_deconv2d`` is the
whole method on raw weights, the reference's ``ref`` deconv impl.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .tdc import ConvDims, DeconvDims, SubFilterPlan, decompose_conv_weights, decompose_weights, interleave_crop, plan
from .winograd import get_transform

__all__ = [
    "transform_weights", "transform_conv_weights", "pad_input_for_tiles", "transform_input_tiles",
    "winograd_domain_matmuls", "winograd_deconv2d",
]


def transform_weights(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """TDC split + G-transform of raw weights (K_D, K_D, N, M).
    Returns (S, S, n, n, N, M) in fp32 (or wider if ``w`` is)."""
    tf = get_transform(m, r)
    dtype = torch.promote_types(w.dtype, torch.float32)
    subw = decompose_weights(w.to(dtype), dims, r)  # (S, S, r, r, N, M)
    G = torch.as_tensor(tf.G, dtype=dtype, device=w.device)
    return torch.einsum("ua,yxabnm,vb->yxuvnm", G, subw, G)


def transform_conv_weights(w: torch.Tensor, dims: ConvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """Phase split + G-transform of raw conv weights (K, K, N, M).
    Returns (S, S, n, n, N, M) in fp32 (or wider if ``w`` is)."""
    tf = get_transform(m, r)
    dtype = torch.promote_types(w.dtype, torch.float32)
    subw = decompose_conv_weights(w.to(dtype), dims, r)  # (S, S, r, r, N, M)
    G = torch.as_tensor(tf.G, dtype=dtype, device=w.device)
    return torch.einsum("ua,yxabnm,vb->yxuvnm", G, subw, G)


def pad_input_for_tiles(x: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3):
    """NHWC input -> (x_pad, (ty, tx)): the deconv left pad kc-1 and the
    right pad that ty x tx overlapping n x n tiles at stride m cover."""
    n = get_transform(m, r).n
    _, H, W, _ = x.shape
    ty, tx = -(-dims.j_extent(H) // m), -(-dims.j_extent(W) // m)
    kc = dims.kc
    x_pad = F.pad(x, (0, 0, kc - 1, max(0, m * (tx - 1) + n - (W + kc - 1)),
                      kc - 1, max(0, m * (ty - 1) + n - (H + kc - 1))))
    return x_pad, (ty, tx)


def transform_input_tiles(x_pad: torch.Tensor, n_tiles: tuple[int, int], m: int = 2, r: int = 3) -> torch.Tensor:
    """Step 3: the n x n tiles at stride m of a padded NHWC input, B^T Z B.
    Returns (B, Ty, Tx, n, n, N) in fp32 (or wider if ``x_pad`` is)."""
    tf = get_transform(m, r)
    n = tf.n
    _, H, W, _ = x_pad.shape
    ty, tx = n_tiles
    need_h, need_w = m * (ty - 1) + n, m * (tx - 1) + n
    if H < need_h or W < need_w:
        x_pad = F.pad(x_pad, (0, 0, 0, max(0, need_w - W), 0, max(0, need_h - H)))
    dev = str(x_pad.device)
    tiles = x_pad[:, _tile_rows(ty, m, n, dev)][:, :, :, _tile_rows(tx, m, n, dev)].permute(0, 1, 3, 2, 4, 5)
    dtype = torch.promote_types(x_pad.dtype, torch.float32)
    bt = _bt_on(m, r, dtype, dev)
    # B^T Z B as two plain contractions: a three-operand einsum would search
    # for a contraction order on the host at every call
    rows = torch.einsum("ua,zyxabc->zyxubc", bt, tiles.to(dtype))
    return torch.einsum("zyxubc,vb->zyxuvc", rows, bt)


def device_constant(maxsize: int):
    """``functools.lru_cache`` for a function that builds a constant tensor
    on a device, which builds it outside any inference mode: a serving
    caller's ``torch.inference_mode()`` would otherwise cache an inference
    tensor, which autograd refuses to save in a later training step."""
    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def cached(*args):
            with torch.inference_mode(False):
                return fn(*args)
        return cached
    return wrap


@device_constant(maxsize=16)
def _bt_on(m: int, r: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """B^T of F(m, r) on ``device``, copied there once: a copy from host
    memory on every call would wait for the device each time."""
    return torch.as_tensor(get_transform(m, r).BT, dtype=dtype, device=device)


@device_constant(maxsize=64)
def _tile_rows(t: int, m: int, n: int, device: str) -> torch.Tensor:
    """(t, n) input rows of t overlapping n-tiles at stride m, on ``device``,
    built once per geometry."""
    return (m * torch.arange(t, device=device))[:, None] + torch.arange(n, device=device)[None, :]


def winograd_domain_matmuls(
    xw_mat: torch.Tensor,  # (T, n*n, N) transformed input tiles
    ww: torch.Tensor,  # (S, S, n, n, N, M) transformed filters
    sp: SubFilterPlan,
    *,
    m: int = 2,
    dense: bool = False,
    bf16: bool = False,
) -> torch.Tensor:
    """Steps 4-5 for every sub-filter, fp32; returns (S, S, T, m, m, M).
    ``dense=False`` skips the structurally zero positions (the paper);
    ``dense=True`` keeps all n^2 (the conventional Winograd accelerator,
    an ablation baseline).  ``bf16=True`` rounds the channel contraction's
    operands to bf16 and keeps fp32 accumulation and the fp32 inverse
    transform, as the reference's ``preferred_element_type`` does: the
    rounded operands are multiplied in fp32, where the product of two bf16
    values is exact."""
    tf = get_transform(m, sp.r)
    n = tf.n
    S = sp.dims.stride
    AT = np.asarray(tf.AT)
    T, M = xw_mat.shape[0], ww.shape[-1]
    dtype = torch.promote_types(xw_mat.dtype, torch.float32)
    outs = []
    for ry in range(S):
        row = []
        for rx in range(S):
            mask = sp.masks_winograd[ry, rx]
            keep = [(u, v) for u in range(n) for v in range(n) if dense or mask[u, v]]
            if not keep:  # K_D < S can leave a sub-filter with no taps
                row.append(xw_mat.new_zeros((T, m, m, M), dtype=dtype))
                continue
            pos = torch.as_tensor([u * n + v for u, v in keep], device=xw_mat.device)
            xk = xw_mat[:, pos, :].to(dtype)  # (T, |nz|, N)
            wk = ww[ry, rx].reshape(n * n, *ww.shape[4:])[pos].to(dtype)  # (|nz|, N, M)
            if bf16:
                xk, wk = xk.to(torch.bfloat16).to(dtype), wk.to(torch.bfloat16).to(dtype)
            yk = torch.einsum("tpn,pnm->tpm", xk, wk)
            inv = np.stack([np.outer(AT[:, u], AT[:, v]) for u, v in keep])  # (|nz|, m, m)
            row.append(torch.einsum("tpm,pab->tabm", yk, torch.as_tensor(inv, dtype=dtype, device=yk.device)))
        outs.append(torch.stack(row))
    return torch.stack(outs)


def winograd_deconv2d(
    x: torch.Tensor, w: torch.Tensor, dims: DeconvDims, *, m: int = 2, r: int = 3, dense: bool = False,
    bf16: bool = False,
) -> torch.Tensor:
    """Winograd DeConv (the paper's Sec. III): exact deconvolution by TDC +
    F(m x m, r x r) + structural sparsity skipping, in plain PyTorch.
    x (B, H, W, N), w (K_D, K_D, N, M) -> (B, H_O, W_O, M).  ``dense`` and
    ``bf16`` as ``winograd_domain_matmuls``."""
    sp = plan(dims, m, r)
    n = get_transform(m, r).n
    B, H, W, N = x.shape
    M = w.shape[-1]
    hj, wj = dims.j_extent(H), dims.j_extent(W)
    ww = transform_weights(w, dims, m, r)
    x_pad, (ty, tx) = pad_input_for_tiles(x, dims, m, r)
    xw_mat = transform_input_tiles(x_pad, (ty, tx), m, r).reshape(B * ty * tx, n * n, N)
    y = winograd_domain_matmuls(xw_mat, ww, sp, m=m, dense=dense, bf16=bf16)  # (S, S, T, m, m, M)
    S = dims.stride
    y = y.reshape(S, S, B, ty, tx, m, m, M).permute(0, 1, 2, 3, 5, 4, 6, 7).reshape(S, S, B, ty * m, tx * m, M)
    y = y[:, :, :, :hj, :wj, :].to(x.dtype)
    return interleave_crop(y, dims, (dims.out_size(H), dims.out_size(W)))
