"""Baseline deconvolutions the paper compares against.

* ``standard_deconv2d``: the scatter-sum definition (Fig. 1a / 2a), the
  ground-truth oracle, independent of the Winograd path.  Small shapes only.
* ``zero_padded_deconv2d``: dilate with zeros, then correlate with the full
  flipped K_D x K_D kernel (Fig. 1b, refs [10-12]); the inserted zeros
  really enter the multiply stream.
* ``lax_deconv2d``: the framework's own transposed convolution
  (``F.conv_transpose2d``), as the reference leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .tdc import DeconvDims

__all__ = ["standard_deconv2d", "zero_padded_deconv2d", "lax_deconv2d"]


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


def zero_padded_deconv2d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """Insert S-1 zeros between pixels, pad by K-1-P (plus OP at the high
    end; a negative pad crops), correlate with the flipped kernel."""
    B, H, W, N = x.shape
    K, S, P, OP = dims.kernel, dims.stride, dims.padding, dims.output_padding
    HO, WO = dims.out_size(H), dims.out_size(W)
    xd = x.new_zeros((B, S * (H - 1) + 1, S * (W - 1) + 1, N))
    xd[:, ::S, ::S, :] = x
    lo, hi = K - 1 - P, K - 1 - P + OP
    xd = F.pad(xd, (0, 0, lo, hi, lo, hi))  # F.pad crops where a pad is negative
    y = F.conv2d(xd.permute(0, 3, 1, 2), w.flip(0, 1).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)[:, :HO, :WO, :]


def lax_deconv2d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """The transposed convolution as the framework computes it: PyTorch's
    convention is this package's (out[S*i + k - P] += x[i] * w[k]), so the
    weights only move to (N, M, K, K) and the image to NCHW.
    ``F.conv_transpose2d`` refuses output_padding >= stride; there the
    reference's own form runs: the S-dilated input, padded (K-1-P,
    K-1-P+OP) (a negative pad crops), correlated with the flipped taps."""
    if dims.output_padding >= dims.stride:
        return zero_padded_deconv2d(x, w, dims)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), stride=dims.stride,
                           padding=dims.padding, output_padding=dims.output_padding)
    return y.permute(0, 2, 3, 1)
