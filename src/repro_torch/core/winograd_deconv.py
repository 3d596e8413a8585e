"""Winograd DeConv weight side (the paper's Sec. III, steps 1-2).

  1. TDC: split deconv weights into S^2 flipped sub-kernels padded to r x r.
  2. G-transform each sub-kernel: W_w = G ghat G^T -> (S, S, n, n, N, M).

The structural zeros of W_w (Cases 1/2/3) follow from (K_D, S) alone;
``kernels.ops.pack_weights`` keeps only the nonzero positions.
``transform_conv_weights`` is the strided conv's mirror: phase sub-kernels,
not flipped, G-transformed the same way.
"""
from __future__ import annotations

import torch

from .tdc import ConvDims, DeconvDims, decompose_conv_weights, decompose_weights
from .winograd import get_transform

__all__ = ["transform_weights", "transform_conv_weights"]


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
