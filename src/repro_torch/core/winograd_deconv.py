"""Winograd DeConv weight side (the paper's Sec. III, steps 1-2).

  1. TDC: split deconv weights into S^2 flipped sub-kernels padded to r x r.
  2. G-transform each sub-kernel: W_w = G ghat G^T -> (S, S, n, n, N, M).

The structural zeros of W_w (Cases 1/2/3) follow from (K_D, S) alone;
``kernels.ops.pack_weights`` keeps only the nonzero positions.
"""
from __future__ import annotations

import torch

from .tdc import DeconvDims, decompose_weights
from .winograd import get_transform

__all__ = ["transform_weights"]


def transform_weights(w: torch.Tensor, dims: DeconvDims, m: int = 2, r: int = 3) -> torch.Tensor:
    """TDC split + G-transform of raw weights (K_D, K_D, N, M).
    Returns (S, S, n, n, N, M) in fp32 (or wider if ``w`` is)."""
    tf = get_transform(m, r)
    dtype = torch.promote_types(w.dtype, torch.float32)
    subw = decompose_weights(w.to(dtype), dims, r)  # (S, S, r, r, N, M)
    G = torch.as_tensor(tf.G, dtype=dtype, device=w.device)
    return torch.einsum("ua,yxabnm,vb->yxuvnm", G, subw, G)
