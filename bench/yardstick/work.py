"""The least time of each hand-written engine launch, from layer shapes.

A frozen copy of the port's per-kernel counts (``kernels/costs.py`` at the
benchmark's first version) for the 2D fused engine at the deconv corner
(TPU kernels 3, 6, 7: ``fused_engine``, ``fused_engine_bwd_x``,
``fused_engine_bwd_w``) and at the conv corner (``conv_fused_engine*``),
driven from a configuration's layer shapes with the packed layouts of
``reference.winograd``.  A later change to the program cannot move it.

``products``: 2·T·C·N·M multiply-adds given to the kernel; ``ops``: those
plus the B-transforms, the inverse-transform folds (or bwd_x's overlap sum)
and the epilogue, each at its least number of operations; ``bytes``: each
input read once and each output written once, fp32.  ``least_ms`` is the
largest of the bytes at HBM bandwidth, the products at the fp32-accurate
tensor-core rate (dense TF32 / 3: 3xTF32 issues three TF32 products for
each) and the other operations at the fp32 rate: the bound holds whatever
instantiation ran, so a plan that puts a shape on the CUDA cores cannot
lower it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..reference import gan as R
from ..reference import winograd as W

F32 = 4

# (fp32 FLOP/s outside the tensor cores, HBM bytes/s, fp32-accurate products on the
# tensor cores) of one H100 by NVIDIA's data sheet, dense, at the full power limit
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 378e12 / 3),
    "NVL": (60.0e12, 3.9e12, 417.5e12 / 3),
    "SXM": (66.9e12, 3.35e12, 495e12 / 3),
}


def peaks_for(device_name: str) -> tuple[float, float, float]:
    """The peaks of the H100 part ``device_name`` names (SXM unless it says
    PCIe or NVL)."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return PEAKS["SXM"]


class Work(NamedTuple):
    products: int
    ops: int
    bytes: int


def fold_adds(inv, groups, backward: bool = False) -> int:
    """Least adds per tile and output channel of the inverse transform: per
    group of packed rows sharing an output tile, the smaller of the direct
    sum through ``inv`` and A^T Y A on the 4x4 sum (24 adds); backward (gw
    from g) the smaller of the direct rows and A g A^T (12 adds)."""
    nz = np.asarray(inv) != 0
    total = 0
    for lo, hi in groups:
        terms = nz[lo:hi].sum(axis=1 if backward else 0)
        total += min(int(np.maximum(terms - 1, 0).sum()), 12 if backward else 24)
    return total


def overlap_adds(B: int, phases: int, N: int, ty: int, tx: int) -> int:
    return B * phases * 4 * N * max(0, 4 * ty * tx - (ty + 1) * (tx + 1))


def _fwd(T, N, M, inv, groups, phases, cells, out, vectors) -> Work:
    C = len(inv)
    products = 2 * T * C * N * M
    ops = products + 32 * T * phases * N + T * M * fold_adds(inv, groups) + 3 * out
    return Work(products, ops, F32 * (cells + C * N * M + inv.size + out + M * vectors))


def _bwd(T, N, M, inv, groups, phases, reads, writes) -> Work:
    C = len(inv)
    products = 2 * T * C * N * M
    ops = products + 32 * T * phases * N + T * M * fold_adds(inv, groups, True)
    return Work(products, ops, F32 * (reads + inv.size + writes))


def work(launch: dict) -> Work:
    """The work of one launch as ``launches`` describes it."""
    k, geo = launch["kernel"], launch["geo"]
    _, groups, inv = W.layout(geo)
    B, ty, tx, N, M = (launch[key] for key in ("B", "ty", "tx", "N", "M"))
    T, C = B * ty * tx, len(inv)
    if k.startswith("conv_"):
        groups, s2 = [(0, C)], geo.stride ** 2
    else:
        s2 = 1
    if k in ("fused_engine", "conv_fused_engine"):
        return _fwd(T, N, M, inv, groups, s2, launch["cells"], launch["out"], launch["vectors"])
    if k in ("fused_engine_bwd_x", "conv_fused_engine_bwd_x"):
        g = T * (len(groups) if s2 == 1 else 1) * 4 * M
        w = _bwd(T, N, M, inv, groups, s2, g + C * N * M, B * launch["gy"] * launch["gx"] * s2 * 4 * N)
        return w._replace(ops=w.ops + overlap_adds(B, s2, N, ty, tx))
    if k in ("fused_engine_bwd_w", "conv_fused_engine_bwd_w"):
        g = T * (len(groups) if s2 == 1 else 1) * 4 * M
        return _bwd(T, N, M, inv, groups, s2, launch["cells"] + g, C * N * M)
    raise ValueError(f"no count for kernel {k!r}")


def least_ms(w: Work, peaks) -> float:
    flops_peak, bytes_peak, tc_peak = peaks
    return 1e3 * max(w.bytes / bytes_peak, w.products / tc_peak, (w.ops - w.products) / flops_peak)


def launches(cfg: dict, batch: int, *, training: bool) -> list[dict]:
    """Every engine launch site of a generator and discriminator of ``cfg``
    at ``batch``: one dict per (layer, kernel) with the shape keywords the
    counts take, in the port's chained layouts (cells of (B, gy, gx, S^2*4,
    N); a deconv layer emits the next layer's cells where their layouts line
    up, else NHWC pixels).  Training mode: batchnorm layers take no
    epilogue vectors, the discriminator its bias; eval mode folds BN into a
    scale and a bias."""
    out = []
    deconvs, geos = cfg["deconvs"], R.deconv_geos(cfg)
    h = cfg["seed_hw"]
    for i, (d, geo) in enumerate(zip(deconvs, geos)):
        hj = geo.j_extent(h)
        ty = -(-hj // W.M_TILE)
        gy = ty + 1
        ho = geo.out_size(h)
        nxt = geos[i + 1] if i + 1 < len(geos) else None
        aligned = nxt is not None and (geo.padding - (nxt.kc - 1)) % W.M_TILE == 0
        N, M = d["c_in"], d["c_out"]
        cells = batch * gy * gy * 4 * N
        o = batch * (ty * geo.stride) ** 2 * 4 * M if aligned else batch * ho * ho * M
        vectors = 2 if (d["norm"] == "batch" and not training) else 0
        base = dict(layer=f"deconv{i}", geo=geo, B=batch, ty=ty, tx=ty, N=N, M=M)
        out.append(dict(base, kernel="fused_engine", cells=cells, out=o, vectors=vectors))
        out.append(dict(base, kernel="fused_engine_bwd_x", gy=gy, gx=gy))
        out.append(dict(base, kernel="fused_engine_bwd_w", cells=cells))
        h = ho
    h, chans = cfg["img_hw"], [cfg["img_ch"], *cfg["disc_channels"]]
    for j, geo in enumerate(R.conv_geos(cfg)):
        ho = geo.out_size(h)
        ty = -(-ho // W.M_TILE)
        gy = ty + 1
        N, M = chans[j], chans[j + 1]
        cells = batch * gy * gy * 4 * 4 * N
        last = j + 1 == len(chans) - 1
        o = batch * ho * ho * M if last else batch * ty * ty * 4 * M
        vectors = 2 if (j > 0 and not training) else 1
        base = dict(layer=f"conv{j}", geo=geo, B=batch, ty=ty, tx=ty, N=N, M=M)
        out.append(dict(base, kernel="conv_fused_engine", cells=cells, out=o, vectors=vectors))
        out.append(dict(base, kernel="conv_fused_engine_bwd_x", gy=gy, gx=gy))
        out.append(dict(base, kernel="conv_fused_engine_bwd_w", cells=cells))
        h = ho
    return out


def match(launch_kernel: str, shape: dict, sites: list[dict]):
    """The launch site of ``sites`` that a logged launch of ``launch_kernel``
    with shape keywords ``shape`` (B, ty, tx, N, M) is, or None."""
    for s in sites:
        if s["kernel"] == launch_kernel and all(s[k] == shape.get(k) for k in ("B", "ty", "tx", "N", "M")):
            return s
    return None
