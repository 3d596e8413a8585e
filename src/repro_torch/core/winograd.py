"""Winograd minimal-filtering transform construction.

Implements F(m, r): m outputs of an r-tap correlation via n = m + r - 1
multiplies.  The paper (eq. 3) uses the uniform F(2x2, 3x3) everywhere; we
hard-code those exact matrices and additionally provide a general Cook-Toom
construction (used for the beyond-paper F(4x4, 3x3) option).

Convention: Winograd computes *cross-correlation*
    y[j] = sum_t f[t] * z[j + t],   j in [0, m)
which matches eq. (1) of the paper.  Filters that represent a true
convolution must be flipped before the G-transform (handled in tdc.py).
"""
from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

__all__ = ["WinogradTransform", "f23", "f43", "get_transform"]


class WinogradTransform:
    """Holds (A, B, G) for F(m, r); Y = A^T [(G f) . (B^T z)] in 1D and
    Y = A^T [(G f G^T) . (B^T Z B)] A in 2D (paper eq. 4)."""

    def __init__(self, m: int, r: int, AT: np.ndarray, BT: np.ndarray, G: np.ndarray):
        self.m, self.r = m, r
        self.n = m + r - 1
        self.AT = np.asarray(AT, dtype=np.float64)
        self.BT = np.asarray(BT, dtype=np.float64)
        self.G = np.asarray(G, dtype=np.float64)
        assert self.AT.shape == (m, self.n)
        assert self.BT.shape == (self.n, self.n)
        assert self.G.shape == (self.n, r)

    # -- 1D reference helpers (numpy; used by tests and mask construction) --
    def correlate1d(self, z: np.ndarray, f: np.ndarray) -> np.ndarray:
        """y[j] = sum_t f[t] z[j+t] for one n-tile via the Winograd identity."""
        return self.AT @ ((self.G @ f) * (self.BT @ z))

    def filter_mask1d(self, present: np.ndarray) -> np.ndarray:
        """Structural nonzero mask of (G f) given tap-existence vector.

        Uses |G| so algebraic cancellation of real weight values can never be
        mistaken for structural sparsity: position u of the transformed filter
        is structurally zero iff every tap feeding it is absent.
        """
        return (np.abs(self.G) @ np.asarray(present, dtype=np.float64)) > 0


def f23() -> WinogradTransform:
    """F(2, 3) with the exact matrices of paper eq. (3)."""
    BT = np.array(
        [
            [1, 0, -1, 0],
            [0, 1, 1, 0],
            [0, -1, 1, 0],
            [0, 1, 0, -1],
        ],
        dtype=np.float64,
    )
    G = np.array(
        [
            [1, 0, 0],
            [0.5, 0.5, 0.5],
            [0.5, -0.5, 0.5],
            [0, 0, 1],
        ],
        dtype=np.float64,
    )
    AT = np.array(
        [
            [1, 1, 1, 0],
            [0, 1, -1, -1],
        ],
        dtype=np.float64,
    )
    return WinogradTransform(2, 3, AT, BT, G)


def _cook_toom(m: int, r: int, points: list[Fraction]) -> WinogradTransform:
    """General Cook-Toom construction over exact rationals.

    Standard construction: with n-1 finite interpolation points plus the
    point at infinity,
      G  (n x r): rows g_i = [1, p_i, p_i^2, ...] (last row = e_{r-1}),
      AT (m x n): columns a_j = [1, p_j, ..., p_j^{m-1}] (last col = e_{m-1}),
      B^T = (A_full^{-1})-style: B^T solves exactness; we derive it by
      requiring A^T [(G f) . (B^T z)] == correlation for symbolic f, z.
    """
    n = m + r - 1
    assert len(points) == n - 1

    # Vandermonde pieces (exact rationals).
    V = [[p**i for i in range(n)] for p in points]  # (n-1) x n

    G = np.zeros((n, r), dtype=object)
    for i, p in enumerate(points):
        for j in range(r):
            G[i, j] = p**j
    G[n - 1, :] = [Fraction(0)] * (r - 1) + [Fraction(1)]

    AT = np.zeros((m, n), dtype=object)
    for i in range(m):
        for j, p in enumerate(points):
            AT[i, j] = p**i
    for i in range(m):
        AT[i, n - 1] = Fraction(1) if i == m - 1 else Fraction(0)

    # B^T from the full n x n Vandermonde on [points, inf].
    Vn = np.zeros((n, n), dtype=object)
    for i, p in enumerate(points):
        for j in range(n):
            Vn[i, j] = p**j
    Vn[n - 1, :] = [Fraction(0)] * (n - 1) + [Fraction(1)]
    BT = _exact_inv(Vn).T  # B^T = (Vn^{-1})^T

    # Scale rows of G / compensate in BT is unnecessary for correctness here;
    # verify exactness symbolically below (random rational probe).
    tf = WinogradTransform(
        m,
        r,
        np.array([[float(x) for x in row] for row in AT]),
        np.array([[float(x) for x in row] for row in BT]),
        np.array([[float(x) for x in row] for row in G]),
    )
    rng = np.random.default_rng(0)
    z = rng.standard_normal(n)
    f = rng.standard_normal(r)
    want = np.array([sum(f[t] * z[j + t] for t in range(r)) for j in range(m)])
    got = tf.correlate1d(z, f)
    assert np.allclose(got, want, atol=1e-9), "Cook-Toom construction failed"
    return tf


def _exact_inv(M: np.ndarray) -> np.ndarray:
    """Exact Gauss-Jordan inverse over Fraction entries."""
    n = M.shape[0]
    A = [[Fraction(M[i, j]) for j in range(n)] for i in range(n)]
    I = [[Fraction(1) if i == j else Fraction(0) for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if A[r][col] != 0)
        A[col], A[piv] = A[piv], A[col]
        I[col], I[piv] = I[piv], I[col]
        inv = Fraction(1) / A[col][col]
        A[col] = [x * inv for x in A[col]]
        I[col] = [x * inv for x in I[col]]
        for r in range(n):
            if r != col and A[r][col] != 0:
                fac = A[r][col]
                A[r] = [a - fac * b for a, b in zip(A[r], A[col])]
                I[r] = [a - fac * b for a, b in zip(I[r], I[col])]
    out = np.zeros((n, n), dtype=object)
    for i in range(n):
        for j in range(n):
            out[i, j] = I[i][j]
    return out


@functools.lru_cache(maxsize=None)
def f43() -> WinogradTransform:
    """F(4, 3) via Cook-Toom with points {0, 1, -1, 2, -2} (beyond-paper)."""
    pts = [Fraction(p) for p in (0, 1, -1, 2, -2)]
    return _cook_toom(4, 3, pts)


@functools.lru_cache(maxsize=None)
def get_transform(m: int, r: int) -> WinogradTransform:
    if (m, r) == (2, 3):
        return f23()
    if (m, r) == (4, 3):
        return f43()
    # Generic fallback.
    pts = [Fraction(p) for p in (0, 1, -1, 2, -2, 3, -3)][: m + r - 2]
    return _cook_toom(m, r, pts)
