"""The work of each hand-written kernel, counted from its launch.

One function per wrapper of ``kernels/engine.py`` returns a ``Work``:

* ``products``: the multiply-adds the kernel is given, x2 (``2·T·C·N·M``
  for T tiles, C packed positions, N input and M output channels);
* ``ops``: ``products`` plus the transforms, folds, overlap sums and the
  epilogue, each counted at its least number of adds and multiplies;
* ``bytes``: each input read once and each output written once (fp32).

``of_launch`` counts one ``engine.Launch``: the wrapper fills its ``work``
keywords (element counts, the packed ``inv`` and the sub-filter slices)
only while ``engine.launch_log`` is a list, so a launch with the log off
pays nothing.  ``chip_smoke.py``'s kernel rows and ``launch/op_costs.py``
take their counts from here.

The counts need the packed ``inv``'s nonzero pattern (``fold_adds`` /
``fold_ops_1d``); a CUDA ``inv`` is read to the host where a count is
asked for, never at the launch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Work", "fold_adds", "overlap_adds", "transform_ops_1d", "fold_ops_1d", "fused_engine",
           "fused_engine_bwd_x", "fused_engine_bwd_w", "conv_fused_engine", "conv_fused_engine_bwd_x",
           "conv_fused_engine_bwd_w", "domain_engine", "domain_engine_bwd_x", "domain_engine_bwd_w",
           "winograd_conv1d_fused_engine", "of_launch"]

F32 = 4  # every kernel's operands are fp32


class Work(NamedTuple):
    products: int
    ops: int
    bytes: int


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _numel(a) -> int:
    return int(np.prod(tuple(a.shape)))


def fold_adds(inv, groups, backward: bool = False) -> int:
    """Least adds per tile and output channel that the inverse transform
    needs, F(2,3): ``inv`` (C, 4) holds 0 or +-1, so each term is one add.
    Forward, per group of packed positions that share an output tile (a
    sub-filter; at the conv corner all C): the smaller of the direct sum
    through ``inv`` and A^T Y A on the 4x4 sum (24 adds; positions that
    share a Winograd position sum in the contraction's own chain).
    Backward, gw from g: the smaller of the direct rows and A g A^T (12
    adds, then fanned out)."""
    nz = _host(inv) != 0
    total = 0
    for lo, hi in groups:
        terms = nz[lo:hi].sum(axis=1 if backward else 0)
        total += min(int(np.maximum(terms - 1, 0).sum()), 12 if backward else 24)
    return total


def overlap_adds(B: int, phases: int, N: int, ty: int, tx: int) -> int:
    """Adds of bwd_x's overlap sum: a cell's m x m values of each phase and
    channel gather one piece from each of the (up to 2 x 2) tiles whose
    4 x 4 windows cover it; ty*tx tiles give 4*ty*tx pieces to
    (ty+1)*(tx+1) cells."""
    return B * phases * 4 * N * max(0, 4 * ty * tx - (ty + 1) * (tx + 1))


def transform_ops_1d(mat) -> int:
    """Least operations of applying ``mat`` (rows of a 1D transform) to one
    vector: per row, an add for each nonzero after the first and a multiply
    for each nonzero that is not +-1."""
    mat = _host(mat)
    nz = mat != 0
    return int(np.maximum(nz.sum(axis=1) - 1, 0).sum() + (nz & (np.abs(mat) != 1)).sum())


def fold_ops_1d(inv, groups, backward: bool = False) -> int:
    """Least operations of the rank-1 inverse transform per tile and output
    channel: forward, each sub-filter's m outputs from its packed products
    (``transform_ops_1d`` of inv[lo:hi]^T); backward, gw of every packed
    position from its sub-filter's m cotangents (of inv's rows)."""
    inv = _host(inv)
    return sum(transform_ops_1d(inv[lo:hi] if backward else inv[lo:hi].T) for lo, hi in groups if hi > lo)


# ------------------------------------------------ the 2D fused engines
# Both corners: the B-transform of each tile's 4 x 4 window (32 adds per
# tile, phase and input channel) or its transpose, the contraction, the
# inverse transform (forward: fold_adds per group of positions that share an
# output tile) or gw from g (backward), the epilogue (3 per output value:
# scale, bias, activation) or bwd_x's overlap sum.
def _fused_fwd(T, N, M, inv, groups, phases, cells, out, vectors, epilogue) -> Work:
    C = len(inv)
    products = 2 * T * C * N * M
    ops = products + 32 * T * phases * N + T * M * fold_adds(inv, groups) + (3 * out if epilogue else 0)
    return Work(products, ops, F32 * (cells + C * N * M + _numel(inv) + out + M * vectors))


def _fused_bwd(T, N, M, inv, groups, phases, reads, writes) -> Work:
    C = len(inv)
    products = 2 * T * C * N * M
    ops = products + 32 * T * phases * N + T * M * fold_adds(inv, groups, True)
    return Work(products, ops, F32 * (reads + _numel(inv) + writes))


def fused_engine(*, B, ty, tx, N, M, inv, sub_slices, cells, out, vectors=0, epilogue=True) -> Work:
    """TPU kernels 2 (``epilogue=False``: scratch mode) and 3 at the deconv
    corner: ``cells`` and ``out`` are element counts, ``vectors`` the
    epilogue's (M,) scale and bias given."""
    return _fused_fwd(B * ty * tx, N, M, inv, sub_slices, 1, cells, out, vectors, epilogue)


def fused_engine_bwd_x(*, B, ty, tx, gy, gx, N, M, inv, sub_slices) -> Work:
    """TPU kernel 6 at the deconv corner: reads g (T, S*S*4, M) and the
    packed weights, writes dcells (B, gy, gx, 4, N)."""
    T, C = B * ty * tx, len(inv)
    w = _fused_bwd(T, N, M, inv, sub_slices, 1, T * len(sub_slices) * 4 * M + C * N * M, B * gy * gx * 4 * N)
    return w._replace(ops=w.ops + overlap_adds(B, 1, N, ty, tx))


def fused_engine_bwd_w(*, B, ty, tx, N, M, inv, sub_slices, cells) -> Work:
    """TPU kernel 7 at the deconv corner: reads the cells (``cells``
    elements) and g, writes dww (C, N, M)."""
    T, C = B * ty * tx, len(inv)
    return _fused_bwd(T, N, M, inv, sub_slices, 1, cells + T * len(sub_slices) * 4 * M, C * N * M)


def conv_fused_engine(*, B, ty, tx, N, M, inv, s2, cells, out, vectors=0) -> Work:
    """TPU kernel 3 at the conv corner (``s2`` phases; one output tile per
    tile, so the fold runs over all C positions)."""
    return _fused_fwd(B * ty * tx, N, M, inv, [(0, len(inv))], s2, cells, out, vectors, True)


def conv_fused_engine_bwd_x(*, B, ty, tx, gy, gx, N, M, inv, s2) -> Work:
    """TPU kernel 6 at the conv corner: reads g (B, ty, tx, 4, M) and the
    packed weights, writes dcells (B, gy, gx, s2*4, N)."""
    T, C = B * ty * tx, len(inv)
    w = _fused_bwd(T, N, M, inv, [(0, C)], s2, T * 4 * M + C * N * M, B * gy * gx * s2 * 4 * N)
    return w._replace(ops=w.ops + overlap_adds(B, s2, N, ty, tx))


def conv_fused_engine_bwd_w(*, B, ty, tx, N, M, inv, s2, cells) -> Work:
    """TPU kernel 7 at the conv corner."""
    T, C = B * ty * tx, len(inv)
    return _fused_bwd(T, N, M, inv, [(0, C)], s2, cells + T * 4 * M, C * N * M)


# ------------------------------------------- the unfused (domain) engine
# On transformed tiles: no B-transform; the fold (forward) or gw from g
# (backward), fold_adds in 2D (m2 = 4) and fold_ops_1d at rank 1 (m2 = 2).
def _fold(inv, sub_slices, m2: int, backward: bool) -> int:
    return fold_adds(inv, sub_slices, backward) if m2 == 4 else fold_ops_1d(inv, sub_slices, backward)


def domain_engine(*, T, n2, N, M, m2, inv, sub_slices) -> Work:
    """TPU kernel 1: reads xw (T, n2, N), writes (T, S*S*m2, M)."""
    C = len(inv)
    products = 2 * T * C * N * M
    return Work(products, products + T * M * _fold(inv, sub_slices, m2, False),
                F32 * (T * n2 * N + C * N * M + T * len(sub_slices) * m2 * M + _numel(inv)))


def domain_engine_bwd_x(*, T, n2, N, M, m2, inv, sub_slices) -> Work:
    """TPU kernel 4 (2D, or rank 1 at m2 = 2): reads g (T, S*S*m2, M) and
    the packed weights, writes dxw (T, n2, N)."""
    C = len(inv)
    products = 2 * T * C * N * M
    return Work(products, products + T * M * _fold(inv, sub_slices, m2, True),
                F32 * (T * len(sub_slices) * m2 * M + C * N * M + T * n2 * N + _numel(inv)))


def domain_engine_bwd_w(*, T, n2, N, M, m2, inv, sub_slices) -> Work:
    """TPU kernel 5 (2D, or rank 1 at m2 = 2): reads xw and g, writes dww."""
    C = len(inv)
    products = 2 * T * C * N * M
    return Work(products, products + T * M * _fold(inv, sub_slices, m2, True),
                F32 * (T * n2 * N + T * len(sub_slices) * m2 * M + C * N * M + _numel(inv)))


# ------------------------------------------------------ the 1D engine
def winograd_conv1d_fused_engine(*, B, ty, N, M, phases, inv, sub_slices, bt, cells, out, vectors=0,
                                 activation="none", epilogue=True) -> Work:
    """TPU kernels 8 (``epilogue=False``: scratch mode) and 9 (nlc): the
    B-transform of each tile (``transform_ops_1d`` of B^T a phase and
    input channel), the contraction, the fold (``fold_ops_1d``) and the
    epilogue (a scale, a bias and the activation per output value, each
    where given)."""
    T, C = B * ty, len(inv)
    products = 2 * T * C * N * M
    epi = out * (vectors + (activation != "none")) if epilogue else 0
    ops = products + T * phases * N * transform_ops_1d(bt) + T * M * fold_ops_1d(inv, sub_slices) + epi
    return Work(products, ops, F32 * (cells + C * N * M + _numel(inv) + out + M * vectors))


_BY_KERNEL = {
    "fused_engine": fused_engine,
    "fused_engine_bwd_x": fused_engine_bwd_x,
    "fused_engine_bwd_w": fused_engine_bwd_w,
    "conv_fused_engine": conv_fused_engine,
    "conv_fused_engine_bwd_x": conv_fused_engine_bwd_x,
    "conv_fused_engine_bwd_w": conv_fused_engine_bwd_w,
    "domain_engine": domain_engine,
    "domain_engine_bwd_x": domain_engine_bwd_x,
    "domain_engine_bwd_w": domain_engine_bwd_w,
    "winograd_conv1d_fused_engine": winograd_conv1d_fused_engine,
}


def of_launch(launch) -> Work:
    """The work of one ``engine.Launch`` (its ``work`` keywords)."""
    if launch.work is None:
        raise ValueError(f"the launch of {launch.kernel} carries no work keywords")
    return _BY_KERNEL[launch.kernel](**launch.work)
