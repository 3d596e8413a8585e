"""TDC: Transforming-Deconv-to-Conv conversion (the paper's Fig. 2b).

Deconvolution semantics (PyTorch ConvTranspose2d convention, per axis):

    out[S*i + k - P] += x[i] * w[k]
    H_O = S * (H_I - 1) + K_D - 2*P + OP

Grouping output positions by residue rho = (o + P) mod S gives, with
j = (o + P) // S, a stride-1 convolution of x with the ragged sub-kernel
g_rho[t] = w[rho + S*t]; the output is the depth-to-space interleave
out[S*j + rho - P] = out_rho[j].  Sub-kernels are stored flipped and padded
to r taps at the high end, so each sub-problem is a plain cross-correlation
and the zero taps sit at positions fixed by (K_D, S) alone: the structural
sparsity the Winograd G-transform inherits (Cases 1/2/3 of Fig. 6).

The strided conv (the discriminator) is the mirror image: with the input
de-interleaved into phases x_phi[j] = x[S*j + phi], phi(rho) = (rho - P)
mod S, the conv is the SUM over tap residues rho of unit-stride
cross-correlations of one phase with the sub-kernel g_rho[t] = w[rho + S*t],
shifted by d_rho = floor((rho - P) / S).  Padding every phase left by
L = ceil(P / S) cells aligns all sub-problems on one r-tap window, and the
taps outside it are structural zeros fixed by (K, S, P) alone.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .winograd import get_transform

__all__ = [
    "DeconvDims", "SubFilterPlan", "plan", "decompose_weights",
    "pad_input_for_subconv", "interleave_crop", "tdc_deconv2d",
    "SubFilterPlan1D", "plan_1d", "decompose_weights_1d", "tdc_deconv1d",
    "ConvDims", "conv_same_dims", "ConvSubFilterPlan", "conv_plan", "decompose_conv_weights",
]


@dataclasses.dataclass(frozen=True)
class DeconvDims:
    """Static geometry of one deconv layer."""

    kernel: int  # K_D (square)
    stride: int  # S
    padding: int  # P (symmetric)
    output_padding: int = 0  # OP

    @property
    def kc(self) -> int:
        """K_Cmax = ceil(K_D / S): the padded sub-kernel width."""
        return -(-self.kernel // self.stride)

    def out_size(self, in_size: int) -> int:
        return self.stride * (in_size - 1) + self.kernel - 2 * self.padding + self.output_padding

    def j_extent(self, in_size: int) -> int:
        """Number of sub-conv output positions needed to cover the output."""
        h_o = self.out_size(in_size)
        return (h_o - 1 + self.padding) // self.stride + 1


@dataclasses.dataclass(frozen=True)
class SubFilterPlan:
    """Structural description of the S^2 sub-filters for (K_D, S, r)."""

    dims: DeconvDims
    r: int  # Winograd filter size the sub-kernels are padded to
    taps_1d: tuple[tuple[int, ...], ...]  # per rho: flipped tap presence (len r)
    nnz_winograd: np.ndarray  # (S, S) nonzero count of each transformed sub-filter
    masks_winograd: np.ndarray  # (S, S, n, n) bool structural nonzero masks
    case: np.ndarray  # (S, S) int: 1, 2, 3 per the paper's Fig. 6 (0 = other)

    @property
    def c_total(self) -> int:
        """The paper's C(K_C): multiplies per m x m output tile across the
        S^2 sub-filters.  C(3) = 49, C(2) = 36 for S = 2."""
        return int(self.nnz_winograd.sum())


def _tap_presence_1d(dims: DeconvDims, rho: int, r: int) -> np.ndarray:
    """Flipped and padded tap-existence vector (length r) for residue rho."""
    kc = dims.kc
    kcr = math.ceil((dims.kernel - rho) / dims.stride)  # ragged tap count
    g = np.zeros(kc)
    g[:kcr] = 1.0
    out = np.zeros(r)
    out[:kc] = g[::-1]
    return out


def plan(dims: DeconvDims, m: int = 2, r: int = 3) -> SubFilterPlan:
    """Structural sparsity plan for (K_D, S) under F(m, r)."""
    if dims.kc > r:
        raise ValueError(
            f"K_C={dims.kc} > r={r}: kernel {dims.kernel} stride {dims.stride} "
            f"not expressible in F({m},{r}); use a larger r."
        )
    tf = get_transform(m, r)
    S, n = dims.stride, tf.n
    masks = np.zeros((S, S, n, n), bool)
    nnz = np.zeros((S, S), int)
    case = np.zeros((S, S), int)
    pres = [_tap_presence_1d(dims, rho, r) for rho in range(S)]
    m1d = [tf.filter_mask1d(p) for p in pres]
    for ry in range(S):
        for rx in range(S):
            masks[ry, rx] = np.outer(m1d[ry], m1d[rx])
            nnz[ry, rx] = int(masks[ry, rx].sum())
            zeros = n * n - nnz[ry, rx]
            if zeros == 0:
                case[ry, rx] = 1
            elif zeros == n:
                case[ry, rx] = 2
            elif zeros == 2 * n - 1:
                case[ry, rx] = 3
    taps = tuple(tuple(int(v) for v in p) for p in pres)
    return SubFilterPlan(dims, r, taps, nnz, masks, case)


def decompose_weights(w: torch.Tensor, dims: DeconvDims, r: int = 3) -> torch.Tensor:
    """Split deconv weights (K_D, K_D, N, M) into S^2 correlation-ready
    sub-kernels, flipped and zero-padded to (S, S, r, r, N, M)."""
    K, S, kc = dims.kernel, dims.stride, dims.kc
    if w.shape[0] != K or w.shape[1] != K:
        raise ValueError(f"weight spatial dims {tuple(w.shape[:2])} != K_D={K}")
    out = w.new_zeros((S, S, r, r, w.shape[2], w.shape[3]))
    for ry in range(S):
        for rx in range(S):
            for ty in range(math.ceil((K - ry) / S)):
                for tx in range(math.ceil((K - rx) / S)):
                    out[ry, rx, kc - 1 - ty, kc - 1 - tx] = w[ry + S * ty, rx + S * tx]
    return out


def pad_input_for_subconv(x: torch.Tensor, dims: DeconvDims, r: int = 3) -> torch.Tensor:
    """Zero-pad NHWC input so that correlation output j is sub-conv position
    j in [0, j_extent): left pad kc-1, right pad so that j_extent + r - 1
    taps are addressable."""
    kc = dims.kc
    hj, wj = dims.j_extent(x.shape[1]), dims.j_extent(x.shape[2])
    pad_r_h = max(0, hj + r - 1 - (x.shape[1] + kc - 1))
    pad_r_w = max(0, wj + r - 1 - (x.shape[2] + kc - 1))
    return F.pad(x, (0, 0, kc - 1, pad_r_w, kc - 1, pad_r_h))


def interleave_crop(sub_out: torch.Tensor, dims: DeconvDims, out_hw: tuple[int, int]) -> torch.Tensor:
    """Depth-to-space: sub_out (S, S, B, H_J, W_J, M) -> (B, H_O, W_O, M),
    out[S*j + rho - P] = out_rho[j], cropped to [0, H_O)."""
    S, P = dims.stride, dims.padding
    _, _, B, HJ, WJ, M = sub_out.shape
    full = sub_out.permute(2, 3, 0, 4, 1, 5).reshape(B, HJ * S, WJ * S, M)
    return full[:, P : P + out_hw[0], P : P + out_hw[1], :]


def tdc_deconv2d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """TDC deconv without Winograd (the paper's [14] baseline): S^2 stride-1
    cross-correlations of the padded NHWC input with the flipped sub-kernels,
    interleaved.  x (B, H, W, N), w (K_D, K_D, N, M) -> (B, H_O, W_O, M)."""
    S = dims.stride
    _, H, W, _ = x.shape
    hj, wj = dims.j_extent(H), dims.j_extent(W)
    subw = decompose_weights(w, dims)  # (S, S, r, r, N, M)
    xp = pad_input_for_subconv(x, dims).permute(0, 3, 1, 2)
    sub_out = torch.stack([
        torch.stack([
            F.conv2d(xp, subw[ry, rx].permute(3, 2, 0, 1))[:, :, :hj, :wj].permute(0, 2, 3, 1)
            for rx in range(S)
        ])
        for ry in range(S)
    ])
    return interleave_crop(sub_out, dims, (dims.out_size(H), dims.out_size(W)))


# ------------------------------------------------------------------ 1D
# The audio deconv stacks: DeconvDims is per-axis geometry already, so the 1D
# decomposition is the rank-1 restriction of the 2D one (S flipped
# sub-kernels instead of S^2, the structural masks straight from the 1D
# tap-presence vectors, depth-to-space along the one sequence axis).


@dataclasses.dataclass(frozen=True)
class SubFilterPlan1D:
    """Structural description of the S sub-filters of a 1D deconv."""

    dims: DeconvDims
    r: int
    taps_1d: tuple[tuple[int, ...], ...]  # per rho: flipped tap presence (len r)
    nnz_winograd: np.ndarray  # (S,) nonzero count of each transformed sub-filter
    masks_winograd: np.ndarray  # (S, n) bool structural nonzero masks

    @property
    def c_total(self) -> int:
        """Multiplies per m-long output tile over the S sub-filters (the 1D
        analogue of the paper's C(K_C)): 6 for K4S2 under F(2,3), of 8."""
        return int(self.nnz_winograd.sum())


def plan_1d(dims: DeconvDims, m: int = 2, r: int = 3) -> SubFilterPlan1D:
    """Structural sparsity plan of a 1D deconv under F(m, r)."""
    if dims.kc > r:
        raise ValueError(
            f"K_C={dims.kc} > r={r}: kernel {dims.kernel} stride {dims.stride} "
            f"not expressible in F({m},{r}); use a larger r."
        )
    tf = get_transform(m, r)
    pres = [_tap_presence_1d(dims, rho, r) for rho in range(dims.stride)]
    masks = np.stack([tf.filter_mask1d(p) for p in pres]).astype(bool)
    taps = tuple(tuple(int(v) for v in p) for p in pres)
    return SubFilterPlan1D(dims, r, taps, masks.sum(axis=1).astype(int), masks)


def decompose_weights_1d(w: torch.Tensor, dims: DeconvDims, r: int = 3) -> torch.Tensor:
    """Split deconv1d weights (K_D, N, M) into S correlation-ready
    sub-kernels, flipped and zero-padded to (S, r, N, M)."""
    K, S, kc = dims.kernel, dims.stride, dims.kc
    if w.shape[0] != K:
        raise ValueError(f"weight tap dim {w.shape[0]} != K_D={K}")
    out = w.new_zeros((S, r, w.shape[1], w.shape[2]))
    for rho in range(S):
        for t in range(math.ceil((K - rho) / S)):
            out[rho, kc - 1 - t] = w[rho + S * t]
    return out


def tdc_deconv1d(x: torch.Tensor, w: torch.Tensor, dims: DeconvDims) -> torch.Tensor:
    """TDC deconv1d without Winograd, the 1D oracle baseline: S stride-1
    cross-correlations of the padded (B, L, N) input with the flipped
    sub-kernels, interleaved and cropped.  w (K_D, N, M) -> (B, L_O, M)."""
    S, kc = dims.stride, dims.kc
    B, L, _ = x.shape
    M = w.shape[-1]
    lj = dims.j_extent(L)
    subw = decompose_weights_1d(w, dims, r=kc)  # (S, kc, N, M)
    xp = F.pad(x, (0, 0, kc - 1, max(0, lj - L))).permute(0, 2, 1)  # (B, N, Lp)
    sub_out = torch.stack([F.conv1d(xp, subw[rho].permute(2, 1, 0))[:, :, :lj] for rho in range(S)])
    full = sub_out.permute(1, 3, 0, 2).reshape(B, lj * S, M)  # out[S*j + rho]
    return full[:, dims.padding : dims.padding + dims.out_size(L), :]


# ------------------------------------------------------------------ conv
@dataclasses.dataclass(frozen=True)
class ConvDims:
    """Static geometry of one strided conv layer (cross-correlation, no
    kernel flip)."""

    kernel: int  # K (square)
    stride: int  # S
    padding: int  # P_lo (top/left pad)
    pad_hi: int = 0  # bottom/right pad (only affects the output extent)

    def out_size(self, in_size: int) -> int:
        return (in_size + self.padding + self.pad_hi - self.kernel) // self.stride + 1

    @property
    def phase_pad(self) -> int:
        """L: the common left pad (in phase-image cells) aligning all phases."""
        return -(-self.padding // self.stride)

    def phase_of(self, rho: int) -> int:
        """The input phase that tap residue rho reads."""
        return (rho - self.padding) % self.stride

    def shift_of(self, rho: int) -> int:
        """d_rho: the constant sub-conv shift of tap residue rho."""
        return (rho - self.padding - self.phase_of(rho)) // self.stride


def conv_same_dims(kernel: int, stride: int, in_size: int) -> ConvDims:
    """ConvDims of "SAME" padding for this input extent (the discriminator's
    convention): H_O = ceil(H / S), the low side taking the smaller half."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + kernel - in_size, 0)
    return ConvDims(kernel, stride, total // 2, total - total // 2)


@dataclasses.dataclass(frozen=True)
class ConvSubFilterPlan:
    """Structural description of the S^2 phase sub-filters for (K, S, P, r)."""

    dims: ConvDims
    r: int
    taps_1d: tuple[tuple[int, ...], ...]  # per rho: tap presence (len r)
    nnz_winograd: np.ndarray  # (S, S) nonzero count of each transformed sub-filter
    masks_winograd: np.ndarray  # (S, S, n, n) bool structural nonzero masks

    @property
    def c_total(self) -> int:
        """Multiplies per m x m output tile over the S^2 phase sub-filters:
        36 for K4S2 (of 64 dense), 16 for K3S1."""
        return int(self.nnz_winograd.sum())


def _conv_tap_presence_1d(dims: ConvDims, rho: int, r: int) -> np.ndarray:
    """Tap-existence vector (length r) of residue rho's aligned sub-kernel."""
    kcr = math.ceil((dims.kernel - rho) / dims.stride)
    lo = dims.shift_of(rho) + dims.phase_pad
    if lo + kcr > r:
        raise ValueError(
            f"conv sub-kernel [{lo}, {lo + kcr}) exceeds r={r}: kernel {dims.kernel} stride "
            f"{dims.stride} pad {dims.padding} not expressible in F(m,{r}); use a larger r."
        )
    out = np.zeros(r)
    out[lo : lo + kcr] = 1.0
    return out


def conv_plan(dims: ConvDims, m: int = 2, r: int = 3) -> ConvSubFilterPlan:
    """Structural sparsity plan for a stride-S conv under F(m, r): the
    deconv plan's |G|-mask rule applied to the phase sub-kernels' taps."""
    tf = get_transform(m, r)
    S = dims.stride
    pres = [_conv_tap_presence_1d(dims, rho, r) for rho in range(S)]
    m1d = [tf.filter_mask1d(p) for p in pres]
    masks = np.zeros((S, S, tf.n, tf.n), bool)
    nnz = np.zeros((S, S), int)
    for ry in range(S):
        for rx in range(S):
            masks[ry, rx] = np.outer(m1d[ry], m1d[rx])
            nnz[ry, rx] = int(masks[ry, rx].sum())
    taps = tuple(tuple(int(v) for v in p) for p in pres)
    return ConvSubFilterPlan(dims, r, taps, nnz, masks)


def decompose_conv_weights(w: torch.Tensor, dims: ConvDims, r: int = 3) -> torch.Tensor:
    """Split conv weights (K, K, N, M) into the S^2 aligned unit-stride
    sub-kernels, zero-padded to (S, S, r, r, N, M).  No flip: the sub-convs
    are cross-correlations."""
    K, S, L = dims.kernel, dims.stride, dims.phase_pad
    if w.shape[0] != K or w.shape[1] != K:
        raise ValueError(f"weight spatial dims {tuple(w.shape[:2])} != K={K}")
    out = w.new_zeros((S, S, r, r, w.shape[2], w.shape[3]))
    for ry in range(S):
        uy0 = dims.shift_of(ry) + L
        for rx in range(S):
            ux0 = dims.shift_of(rx) + L
            for ty in range(math.ceil((K - ry) / S)):
                for tx in range(math.ceil((K - rx) / S)):
                    out[ry, rx, uy0 + ty, ux0 + tx] = w[ry + S * ty, rx + S * tx]
    return out
