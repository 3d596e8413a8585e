"""The scatter-sum deconvolution (the paper's Fig. 1a / 2a): the
ground-truth oracle, written as plain tensor code independent of the
Winograd path.  Small shapes only."""
from __future__ import annotations

import torch

from .tdc import DeconvDims

__all__ = ["standard_deconv2d"]


def standard_deconv2d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """out[b, S*i+ky-P, S*j+kx-P, m] += x[b,i,j,n] w[ky,kx,n,m].
    x: (B, H, W, N) NHWC; w: (K_D, K_D, N, M).  Returns (B, H_O, W_O, M)."""
    B, H, W, _ = x.shape
    K, S, P = dims.kernel, dims.stride, dims.padding
    M = w.shape[-1]
    HO, WO = dims.out_size(H), dims.out_size(W)
    blocks = torch.einsum("bijn,yxnm->bijyxm", x, w)  # (B, H, W, K, K, M)
    # tail room for output_padding past the scatter extent
    full = blocks.new_zeros((B, max(S * (H - 1) + K, P + HO), max(S * (W - 1) + K, P + WO), M))
    for ky in range(K):
        for kx in range(K):
            full[:, ky : ky + S * (H - 1) + 1 : S, kx : kx + S * (W - 1) + 1 : S, :] += blocks[:, :, :, ky, kx, :]
    return full[:, P : P + HO, P : P + WO, :]
