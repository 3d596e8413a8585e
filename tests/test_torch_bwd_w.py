"""Kernels 5 and 7, the weight gradients, at the edges of their tensor-core
route: the plain versions that ``chip_smoke.py`` holds the CUDA kernels to
(``fused_engine_bwd_w_plain``, ``domain_engine_bwd_w_plain`` in 2D and at
rank 1) against the JAX package's oracles at the smoke's ragged shape (K5S2,
batch 7, 11 x 11 input, 100 -> 36 channels: N and M multiples of 4 but not
of the 256 x 128 block tile, T = 252 tiles, not a multiple of the 8- or
16-tile chunk), so the card's yardstick is itself held to the reference
there; and every wrapper that stages 16-byte copies checks its operands'
alignment."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.winograd import get_transform as jget_transform
from repro.kernels import ref as jref
from repro_torch.core import DeconvDims
from repro_torch.kernels import engine as E
from repro_torch.kernels import ops as tops

K5S2, B, H, N, M = (5, 2, 2, 1), 7, 11, 100, 36  # chip_smoke.RAGGED_SHAPE
t = torch.from_numpy


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max() + 1e-5)


def _bt():
    return tuple(tuple(float(v) for v in row) for row in jget_transform(2, 3).BT)


def _layout(m2):
    if m2 == 4:
        pos, subs, inv, _ = tops.packed_layout(DeconvDims(*K5S2))
    else:  # the audio decoder's K4S2 deconv1d
        pos, subs, inv, _ = tops.packed_deconv1d_layout(DeconvDims(4, 2, 1, 0))
    return tuple(pos), tuple(subs), np.asarray(inv, np.float32)


def test_fused_bwd_w_plain_matches_jax_at_the_ragged_shape():
    dims = DeconvDims(*K5S2)
    pos, subs, inv = _layout(4)
    ty = tx = -(-dims.j_extent(H) // 2)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((B, H, H, N)).astype(np.float32)
    cells = tops.cells_from_image(t(x), dims).numpy()
    g = rng.standard_normal((B, ty, tx, 16, M)).astype(np.float32)
    geo = dict(pos_idx=pos, sub_slices=subs, m=2, n=4, ty=ty, tx=tx)
    want = jref.fused_pre_engine_bwd_w_ref(jnp.asarray(cells), jnp.asarray(g), jnp.asarray(inv), _bt(), m2=4, **geo)
    got = E.fused_engine_bwd_w_plain(t(cells), t(g), t(inv), stride=2, **geo)
    assert got.shape == (len(pos), N, M)
    _close(got.numpy(), want)


@pytest.mark.parametrize("m2", [4, 2], ids=["2d", "rank1"])
def test_domain_bwd_w_plain_matches_jax_at_the_ragged_shape(m2):
    pos, subs, inv = _layout(m2)
    T, n2 = 252, 16 if m2 == 4 else 4
    rng = np.random.default_rng(18)
    xw = rng.standard_normal((T, n2, N)).astype(np.float32)
    g = rng.standard_normal((T, len(subs) * m2, M)).astype(np.float32)
    kw = dict(pos_idx=pos, sub_slices=subs, m2=m2)
    want = jref.engine_bwd_w_ref(jnp.asarray(xw), jnp.asarray(g), jnp.asarray(inv), **kw)
    got = E.domain_engine_bwd_w_plain(t(xw), t(g), t(inv), **kw)
    assert got.shape == (len(pos), N, M)
    _close(got.numpy(), want)


def test_every_wrapper_checks_the_operands_its_kernel_copies_in_16_bytes():
    """Each CUDA wrapper calls the alignment check under its own name with
    every operand the table lists for it (the smoke shows the refusal on
    the card)."""
    src = (Path(E.__file__)).read_text()
    calls = {m.group(1): set(re.findall(r"(\w+)=", m.group(2)))
             for m in re.finditer(r'_check_aligned\("(\w+)", N, M, ([^)]*)\)', src)}
    assert calls == {w: set(ops_) for w, ops_ in E._SIXTEEN_BYTE_COPIES.items()}
