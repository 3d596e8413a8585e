"""Port parity, core and layout half: the same numpy inputs through the JAX
reference (``repro``) and the PyTorch port (``repro_torch``), on the CPU.

Transforms, structural plans and layouts must agree exactly; transformed and
packed weights within fp32 rounding (atol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import standard_deconv2d as jax_standard_deconv2d
from repro.core import tdc as jtdc
from repro.core import winograd as jwino
from repro.core.winograd_deconv import transform_weights as jax_transform_weights
from repro.kernels import ops as jops
from repro_torch.core import DeconvDims, get_transform, plan, standard_deconv2d, transform_weights
from repro_torch.core.tdc import decompose_weights
from repro_torch.kernels import ops as tops

GEOMS = {
    "k5s2": (5, 2, 2, 1),
    "k4s2": (4, 2, 1, 0),
    "k3s1": (3, 1, 1, 0),
    "k2s3": (2, 3, 0, 0),
}
C_TOTAL = {"k5s2": 49, "k4s2": 36, "k3s1": 16, "k2s3": 36}


def _dims(name):
    return DeconvDims(*GEOMS[name]), jtdc.DeconvDims(*GEOMS[name])


@pytest.mark.parametrize("mr", [(2, 3), (4, 3)])
def test_transform_matrices_match(mr):
    a, b = get_transform(*mr), jwino.get_transform(*mr)
    for key in ("BT", "G", "AT"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_plan_matches_and_counts(geom):
    td, jd = _dims(geom)
    tp, jp = plan(td), jtdc.plan(jd)
    np.testing.assert_array_equal(tp.masks_winograd, jp.masks_winograd)
    np.testing.assert_array_equal(tp.nnz_winograd, jp.nnz_winograd)
    np.testing.assert_array_equal(tp.case, jp.case)
    assert tp.taps_1d == jp.taps_1d
    assert tp.c_total == jp.c_total == C_TOTAL[geom]
    assert (td.kc, td.out_size(7), td.j_extent(7)) == (jd.kc, jd.out_size(7), jd.j_extent(7))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_weights_decompose_transform_pack(geom):
    td, jd = _dims(geom)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((td.kernel, td.kernel, 3, 5)).astype(np.float32)
    wt = torch.from_numpy(w)
    np.testing.assert_array_equal(decompose_weights(wt, td).numpy(),
                                  np.asarray(jtdc.decompose_weights(jnp.asarray(w), jd)))
    np.testing.assert_allclose(transform_weights(wt, td).numpy(),
                               np.asarray(jax_transform_weights(jnp.asarray(w), jd)), atol=1e-6)
    tl, jl = tops.packed_layout(td), jops.packed_layout(jd)
    assert tl[0] == jl[0] and tl[1] == jl[1]
    got, want = tops.prepack(wt, td), jops.prepack(jnp.asarray(w), jd)
    np.testing.assert_allclose(got.ww.numpy(), np.asarray(want.ww), atol=1e-6)
    np.testing.assert_array_equal(got.inv.numpy(), np.asarray(want.inv))
    np.testing.assert_allclose(tops.pack_weights(wt, td).numpy(), np.asarray(want.ww), atol=1e-6)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("hw", [(4, 5), (7, 3)])
def test_cells_from_image_exact(geom, hw):
    td, jd = _dims(geom)
    x = np.random.default_rng(4).standard_normal((2, *hw, 3)).astype(np.float32)
    np.testing.assert_array_equal(tops.cells_from_image(torch.from_numpy(x), td).numpy(),
                                  np.asarray(jops.cells_from_image(jnp.asarray(x), jd)))


@pytest.mark.parametrize(
    "dims,nxt,out_hw,emitted_hw",
    [
        pytest.param((5, 2, 2, 1), (5, 2, 2, 1), (8, 8), (6, 6), id="k5s2-passthrough"),
        pytest.param((4, 2, 1, 0), (4, 2, 1, 0), (8, 6), (4, 3), id="k4s2-short-pads"),
        pytest.param((5, 2, 4, 1), (5, 2, 2, 1), (6, 6), (7, 7), id="shift-1-slices"),
        pytest.param((5, 2, 2, 1), (5, 2, 2, 1), (8, 8), (9, 7), id="k5s2-extra-rows"),
    ],
)
def test_cells_to_next_exact(dims, nxt, out_hw, emitted_hw):
    e = np.random.default_rng(5).standard_normal((2, *emitted_hw, 4, 3)).astype(np.float32)
    got = tops.cells_to_next(torch.from_numpy(e), DeconvDims(*dims), DeconvDims(*nxt), out_hw)
    want = jops.cells_to_next(jnp.asarray(e), jtdc.DeconvDims(*dims), jtdc.DeconvDims(*nxt), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chain_aligned_matches():
    names = list(GEOMS)
    for a in names:
        for b in names:
            ta, ja = _dims(a)
            tb, jb = _dims(b)
            assert tops.chain_aligned(ta, tb) == jops.chain_aligned(ja, jb), (a, b)


def test_chain_aligned_misaligned_raises():
    td, _ = _dims("k4s2")
    nxt, _ = _dims("k3s1")
    with pytest.raises(ValueError):
        tops.cells_to_next(torch.zeros(1, 4, 4, 4, 2), td, nxt, (8, 8))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_standard_deconv2d_matches(geom):
    td, jd = _dims(geom)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
    w = rng.standard_normal((td.kernel, td.kernel, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(standard_deconv2d(torch.from_numpy(x), torch.from_numpy(w), td).numpy(),
                               np.asarray(jax_standard_deconv2d(jnp.asarray(x), jnp.asarray(w), jd)),
                               atol=1e-5, rtol=1e-5)
