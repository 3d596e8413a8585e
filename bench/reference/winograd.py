"""Winograd F(2x2, 3x3) in plain PyTorch: the frozen transform matrices,
the structural-zero patterns of the paper's deconv (TDC) and strided-conv
sub-filters, their packed layouts, and the Winograd-domain layers on packed
(C, N, M) weights.

The port trains its GAN layers on packed Winograd-domain weights: AdamW
moves the packed leaves themselves, so after one step they are no longer
the G-transform of any raw kernel and no plain convolution computes what
the port computes.  This module is the plain statement of that function:
the n x n input tiles at stride m, B^T Z B, the product with each
sub-filter's transformed weights, A^T (.) A, and the interleave (deconv) or
the sum over phases (conv).  Structural zeros are kept as zeros of a dense
(S, S, n, n, N, M) filter, so the only skipping is the packing itself.

It imports nothing of the program: the matrices are the paper's eq. (3),
and every index is worked out here from (K, S, P).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

M_TILE, R_TAPS = 2, 3
N_TILE = M_TILE + R_TAPS - 1

BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], dtype=np.float64)
G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], dtype=np.float64)
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Deconv:
    """A transposed convolution: out[S*i + k - P] += x[i] * w[k] per axis."""

    kernel: int
    stride: int
    padding: int
    output_padding: int = 0

    @property
    def kc(self) -> int:
        return -(-self.kernel // self.stride)

    def out_size(self, h: int) -> int:
        return self.stride * (h - 1) + self.kernel - 2 * self.padding + self.output_padding

    def j_extent(self, h: int) -> int:
        return (self.out_size(h) - 1 + self.padding) // self.stride + 1


@dataclasses.dataclass(frozen=True)
class Conv:
    """A strided cross-correlation with "SAME" padding (low side the smaller
    half): ``padding`` on the low side, ``pad_hi`` on the high side."""

    kernel: int
    stride: int
    padding: int
    pad_hi: int

    @classmethod
    def same(cls, kernel: int, stride: int, h: int) -> "Conv":
        out = -(-h // stride)
        total = max((out - 1) * stride + kernel - h, 0)
        return cls(kernel, stride, total // 2, total - total // 2)

    def out_size(self, h: int) -> int:
        return (h + self.padding + self.pad_hi - self.kernel) // self.stride + 1

    @property
    def phase_pad(self) -> int:
        return -(-self.padding // self.stride)

    def phase_of(self, rho: int) -> int:
        return (rho - self.padding) % self.stride

    def shift_of(self, rho: int) -> int:
        return (rho - self.padding - self.phase_of(rho)) // self.stride


# ------------------------------------------------------------ structure
def _taps(geo, rho: int) -> np.ndarray:
    """Which of the r taps of residue rho's sub-kernel exist."""
    kcr = math.ceil((geo.kernel - rho) / geo.stride)
    out = np.zeros(R_TAPS)
    if isinstance(geo, Deconv):  # flipped, padded at the high end
        out[geo.kc - kcr : geo.kc] = 1.0
    else:  # aligned on the common phase pad
        lo = geo.shift_of(rho) + geo.phase_pad
        if lo < 0 or lo + kcr > R_TAPS:
            raise ValueError(f"{geo} does not fit F({M_TILE},{R_TAPS})")
        out[lo : lo + kcr] = 1.0
    return out


@functools.lru_cache(maxsize=None)
def masks(geo) -> np.ndarray:
    """(S, S, n, n) bool: the structurally nonzero positions of each
    transformed sub-filter (|G| on tap existence, so no cancellation of
    values is ever taken for a zero)."""
    m1 = [(np.abs(G) @ _taps(geo, rho)) > 0 for rho in range(geo.stride)]
    return np.stack([np.stack([np.outer(a, b) for b in m1]) for a in m1])


@functools.lru_cache(maxsize=None)
def layout(geo):
    """(flat, groups, inv): each packed position's index into the flat
    (S*S*n*n) transformed filter, in sub-filter then row-major order; the
    (lo, hi) packed rows of each sub-filter; and each row's inverse
    transform A[:, u] A[:, v]^T flattened, (C, m*m)."""
    mk = masks(geo)
    S, n = geo.stride, N_TILE
    flat, groups, inv = [], [], []
    for ry in range(S):
        for rx in range(S):
            lo = len(flat)
            for u in range(n):
                for v in range(n):
                    if mk[ry, rx, u, v]:
                        flat.append((ry * S + rx) * n * n + u * n + v)
                        inv.append(np.outer(AT[:, u], AT[:, v]).reshape(-1))
            groups.append((lo, len(flat)))
    return tuple(flat), tuple(groups), np.stack(inv)


def sub_kernels(w: torch.Tensor, geo) -> torch.Tensor:
    """Raw weights (K, K, N, M) -> the S^2 sub-kernels (S, S, r, r, N, M):
    flipped for a deconv, aligned on the phase pad for a conv."""
    K, S = geo.kernel, geo.stride
    out = w.new_zeros((S, S, R_TAPS, R_TAPS, *w.shape[2:]))
    for ry in range(S):
        for rx in range(S):
            for ty in range(math.ceil((K - ry) / S)):
                for tx in range(math.ceil((K - rx) / S)):
                    if isinstance(geo, Deconv):
                        u, v = geo.kc - 1 - ty, geo.kc - 1 - tx
                    else:
                        u, v = geo.shift_of(ry) + geo.phase_pad + ty, geo.shift_of(rx) + geo.phase_pad + tx
                    out[ry, rx, u, v] = w[ry + S * ty, rx + S * tx]
    return out


def pack(w: torch.Tensor, geo) -> torch.Tensor:
    """Raw (K, K, N, M) -> packed Winograd-domain (C, N, M): G g G^T of each
    sub-kernel at its structurally nonzero positions, computed in float64."""
    g = torch.as_tensor(G, dtype=torch.float64, device=w.device)
    u = torch.einsum("ua,yxabnm,vb->yxuvnm", g, sub_kernels(w.double(), geo), g)
    flat = torch.as_tensor(layout(geo)[0], device=w.device)
    return u.reshape(-1, *w.shape[2:])[flat].to(w.dtype).contiguous()


def _dense(ww: torch.Tensor, geo) -> torch.Tensor:
    """Packed (C, N, M) -> the dense (S*S, n*n, N, M) filter, zero off the
    kept positions (differentiable in ``ww``)."""
    S, n = geo.stride, N_TILE
    flat = torch.as_tensor(layout(geo)[0], device=ww.device)
    dense = ww.new_zeros((S * S * n * n, *ww.shape[1:])).index_add(0, flat, ww)
    return dense.reshape(S * S, n * n, *ww.shape[1:])


# ---------------------------------------------------------- precision
def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read fp32 operands in TF32 mode;
    the result is an fp32 tensor.  Differentiable as the identity."""
    i = t.detach().float().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


def product_operands(tf32: bool):
    """The operand map of every product of the reference: the identity in
    fp32, TF32 rounding for the control."""
    return round_tf32 if tf32 else (lambda t: t)


# ------------------------------------------------------------ layers
def _tiles(xp: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """(B, H, W, N) padded image -> its (B, ty, tx, n, n, N) tiles at stride m."""
    t = xp.unfold(1, N_TILE, M_TILE).unfold(2, N_TILE, M_TILE)  # (B, ty', tx', N, n, n)
    return t[:, :ty, :tx].permute(0, 1, 2, 4, 5, 3)


def _pad_to(x: torch.Tensor, top: int, left: int, h: int, w: int) -> torch.Tensor:
    """x placed at (top, left) of an (h, w) zero canvas (crops past it)."""
    B, H, W, N = x.shape
    return F.pad(x, (0, 0, left, max(0, w - W - left), top, max(0, h - H - top)))[:, :h, :w]


def _input_transform(tiles: torch.Tensor) -> torch.Tensor:
    bt = torch.as_tensor(BT, dtype=tiles.dtype, device=tiles.device)
    rows = torch.einsum("ua,zyxabc->zyxubc", bt, tiles)
    return torch.einsum("zyxubc,vb->zyxuvc", rows, bt)


def _inverse(yw: torch.Tensor) -> torch.Tensor:
    """(..., n, n, M) -> (..., m, m, M): A^T Y A (exact: A holds 0 and +-1)."""
    at = torch.as_tensor(AT, dtype=yw.dtype, device=yw.device)
    return torch.einsum("pu,...uvm,qv->...pqm", at, yw, at)


def deconv(x: torch.Tensor, ww: torch.Tensor, geo: Deconv, *, tf32: bool = False) -> torch.Tensor:
    """Winograd DeConv on packed weights: x (B, H, W, N) NHWC, ww (C, N, M)
    -> (B, H_O, W_O, M).  Each of the S^2 sub-filters is an F(2x2, 3x3)
    correlation of the left-padded input; the outputs interleave
    depth-to-space, out[S*j + rho - P] = out_rho[j], and crop to H_O."""
    op = product_operands(tf32)
    B, H, W, N = x.shape
    S, P = geo.stride, geo.padding
    ho, wo = geo.out_size(H), geo.out_size(W)
    hj, wj = geo.j_extent(H), geo.j_extent(W)
    ty, tx = -(-hj // M_TILE), -(-wj // M_TILE)
    xp = _pad_to(x, geo.kc - 1, geo.kc - 1, M_TILE * (ty - 1) + N_TILE, M_TILE * (tx - 1) + N_TILE)
    v = _input_transform(_tiles(xp, ty, tx)).reshape(B, ty, tx, N_TILE * N_TILE, N)
    u = _dense(ww, geo)  # (S*S, n*n, N, M)
    yw = torch.einsum("byxpn,spnm->sbyxpm", op(v), op(u))
    y = _inverse(yw.reshape(S * S, B, ty, tx, N_TILE, N_TILE, -1))  # (S*S, B, ty, tx, m, m, M)
    y = y.reshape(S, S, B, ty, tx, M_TILE, M_TILE, -1).permute(2, 3, 5, 0, 4, 6, 1, 7)
    y = y.reshape(B, ty * M_TILE, S, tx * M_TILE, S, -1)[:, :hj, :, :wj]
    return y.reshape(B, hj * S, wj * S, -1)[:, P : P + ho, P : P + wo]


def conv(x: torch.Tensor, ww: torch.Tensor, geo: Conv, *, tf32: bool = False) -> torch.Tensor:
    """The strided "SAME" conv on packed weights: x (B, H, W, N), ww (C, N, M)
    -> (B, H_O, W_O, M).  Tap residue rho reads input phase
    x_phi[j] = x[S*j + phi(rho)], padded left by L cells; every output tile
    is A^T (sum over the S^2 sub-filters of U_s . B^T Z_s B) A."""
    op = product_operands(tf32)
    B, H, W, N = x.shape
    S, L = geo.stride, geo.phase_pad
    ho, wo = geo.out_size(H), geo.out_size(W)
    ty, tx = -(-ho // M_TILE), -(-wo // M_TILE)
    hp, wp = -(-H // S), -(-W // S)
    xs = _pad_to(x, 0, 0, hp * S, wp * S).reshape(B, hp, S, wp, S, N)
    u = _dense(ww, geo)
    acc = 0
    for ry in range(S):
        for rx in range(S):
            ph = xs[:, :, geo.phase_of(ry), :, geo.phase_of(rx)]
            ph = _pad_to(ph, L, L, M_TILE * (ty - 1) + N_TILE, M_TILE * (tx - 1) + N_TILE)
            v = _input_transform(_tiles(ph, ty, tx)).reshape(B, ty, tx, N_TILE * N_TILE, N)
            acc = acc + torch.einsum("byxpn,pnm->byxpm", op(v), op(u[ry * S + rx]))
    y = _inverse(acc.reshape(B, ty, tx, N_TILE, N_TILE, -1))  # (B, ty, tx, m, m, M)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, ty * M_TILE, tx * M_TILE, -1)
    return y[:, :ho, :wo]
