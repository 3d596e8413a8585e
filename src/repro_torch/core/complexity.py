"""Analytic multiply counts and the paper's DSE model (eqs. 5-9), as the
reference's, on the port's ``core.tdc`` plans.

All counts are multiplications (the FPGA DSP currency the paper
optimizes); the transforms' adds and constant multiplies are reported
apart.  Pure Python: no tensor is touched.
"""
from __future__ import annotations

import dataclasses
import math

from .tdc import DeconvDims, plan

__all__ = ["LayerShape", "mults_zero_padded", "mults_tdc", "mults_winograd", "transform_ops", "dse_model",
           "bytes_moved"]


@dataclasses.dataclass(frozen=True)
class LayerShape:
    """One deconv layer instance: (B, H_I, W_I, N) -> (B, H_O, W_O, M)."""

    h_in: int
    w_in: int
    n_in: int
    m_out: int
    dims: DeconvDims
    batch: int = 1

    @property
    def h_out(self) -> int:
        return self.dims.out_size(self.h_in)

    @property
    def w_out(self) -> int:
        return self.dims.out_size(self.w_in)


def mults_zero_padded(l: LayerShape) -> int:
    """Fig. 1b: convolve the dilated+padded map with the full K_D^2 kernel.
    Every output tap multiplies, including inserted zeros."""
    return l.batch * l.h_out * l.w_out * l.m_out * l.n_in * l.dims.kernel**2


def mults_tdc(l: LayerShape) -> int:
    """Fig. 1c / ref [14]: S^2 ragged sub-convs; only real taps multiply."""
    d = l.dims
    total_taps = 0
    for ry in range(d.stride):
        for rx in range(d.stride):
            kcy = math.ceil((d.kernel - ry) / d.stride)
            kcx = math.ceil((d.kernel - rx) / d.stride)
            total_taps += kcy * kcx
    hj, wj = d.j_extent(l.h_in), d.j_extent(l.w_in)
    # per sub-conv output position, its own tap count; approximate all rho
    # share the same j-extent (exact for the sizes in the paper's GANs)
    return l.batch * hj * wj * l.m_out * l.n_in * total_taps // 1


def mults_winograd(l: LayerShape, m: int = 2, r: int = 3, dense: bool = False) -> int:
    """This paper: C(K_C) multiplies per m x m output tile across the S^2
    sub-filters (C(3)=49, C(2)=36); dense=True gives the no-skip ablation
    (S^2 * n^2 = 64 for S=2)."""
    d = l.dims
    sp = plan(d, m, r)
    n = m + r - 1
    c = (d.stride**2) * n * n if dense else sp.c_total
    hj, wj = d.j_extent(l.h_in), d.j_extent(l.w_in)
    tiles = math.ceil(hj / m) * math.ceil(wj / m)
    return l.batch * tiles * l.m_out * l.n_in * c


def transform_ops(l: LayerShape, m: int = 2, r: int = 3) -> dict:
    """Add/constant-mul counts of the B/A transforms (amortized over N, M)."""
    d = l.dims
    n = m + r - 1
    hj, wj = d.j_extent(l.h_in), d.j_extent(l.w_in)
    tiles = math.ceil(hj / m) * math.ceil(wj / m)
    # B^T Z B: 2 * n * (adds per 1D transform ~= n*(n-1)) per tile per channel
    b_adds = l.batch * tiles * l.n_in * 2 * n * n * (n - 1)
    sp = plan(d, m, r)
    a_adds = l.batch * tiles * l.m_out * int(sp.nnz_winograd.sum()) * m * m
    return {"b_transform_adds": b_adds, "a_transform_adds": a_adds}


# ---------------------------------------------------------------- DSE model
def dse_model(
    l: LayerShape,
    *,
    t_m: int = 4,
    t_n: int = 128,
    freq_hz: float = 100e6,
    bandwidth: float = 4e9,
    m: int = 2,
    r: int = 3,
) -> dict:
    """Paper eqs. (5)-(9) with the paper's FPGA constants by default.

    Returns T_C, T_D, T_I, bandwidth requirement and the computational roof
    (ops/s).
    """
    d = l.dims
    S, M, N = d.stride, l.m_out, l.n_in
    n = m + r - 1
    c_kc = plan(d, m, r).c_total  # C(K_C): 36 or 49
    w_i, h_i = l.w_in, l.h_in
    t_c = (
        math.ceil(S * S * M / t_m)
        * math.ceil(N / t_n)
        * math.ceil(w_i / m)
        * (c_kc / (m * m))
        / freq_hz
    )  # eq. (5)
    t_d = (m * S * w_i * S * S * M * n * n / 8) / bandwidth  # eq. (6) (bytes ~ n^2 coded words)
    bw_req = (m * m / c_kc) * math.ceil(t_m * t_n / N) * m * S * n * n * freq_hz  # eq. (7)
    t_i = (S * S * M * N * r * r + n * w_i * N) / (bandwidth / (n * n))  # eq. (8)
    ops = 2 * S * S * M * N * h_i * w_i * r * r
    roof = ops / (math.ceil(h_i / m) * t_c + t_i)  # eq. (9)
    return {
        "T_C_s": t_c,
        "T_D_s": t_d,
        "T_I_s": t_i,
        "bandwidth_req_Bps": bw_req,
        "computational_roof_ops": roof,
        "C_KC": c_kc,
    }


def bytes_moved(l: LayerShape, method: str, dtype_bytes: int = 4) -> int:
    """Off-chip traffic model for the energy comparison (Fig. 9): input map +
    weights + output map, with the zero-padded method also writing/reading the
    dilated map (its defining overhead)."""
    d = l.dims
    x_bytes = l.batch * l.h_in * l.w_in * l.n_in * dtype_bytes
    y_bytes = l.batch * l.h_out * l.w_out * l.m_out * dtype_bytes
    w_bytes = d.kernel**2 * l.n_in * l.m_out * dtype_bytes
    if method == "zero_padded":
        dil = l.batch * (d.stride * (l.h_in - 1) + d.kernel) ** 2 * l.n_in * dtype_bytes
        return x_bytes + dil + w_bytes + y_bytes
    if method == "tdc":
        return x_bytes + w_bytes + y_bytes
    if method == "winograd":
        n = 4
        w_wino = d.stride**2 * n * n * l.n_in * l.m_out * dtype_bytes  # transformed weights (Table II BRAM delta)
        return x_bytes + w_wino + y_bytes
    raise ValueError(method)
