"""Port parity of the per-layer path's plain-PyTorch core: the input-tile
transform (the pre-PE, which the reference runs in XLA outside any Pallas
kernel), the interleave, and the whole-layer deconvolutions (TDC without
Winograd, plain Winograd DeConv dense and sparse, the zero-padded baseline,
the framework's transposed convolution), against the JAX package on the same
numpy inputs.  Tolerance atol 1e-5 (fp32, values of order 1 to 10: atol
scaled by the array's largest magnitude for the whole layers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import tdc as jtdc
from repro.core import winograd_deconv as jwd
from repro_torch.core import (
    DeconvDims, interleave_crop, lax_deconv2d, pad_input_for_subconv, plan, tdc_deconv2d, transform_input_tiles,
    transform_weights, winograd_deconv2d, winograd_domain_matmuls, zero_padded_deconv2d,
)
from repro_torch.core.winograd_deconv import pad_input_for_tiles

GEOMS = {"k5s2": (5, 2, 2, 1), "k4s2": (4, 2, 1, 0), "k3s1": (3, 1, 1, 0), "k2s3": (2, 3, 0, 0)}
t = torch.from_numpy


def _close(got, want, rel=True):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (max(1.0, np.abs(want).max()) if rel else 1.0))


def _case(geom, B=2, H=5, W=6, N=3, M=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, N)).astype(np.float32)
    w = rng.standard_normal((GEOMS[geom][0],) * 2 + (N, M)).astype(np.float32)
    return x, w, DeconvDims(*GEOMS[geom]), jtdc.DeconvDims(*GEOMS[geom])


@pytest.mark.parametrize("geom", list(GEOMS))
def test_transform_input_tiles_matches_jax(geom):
    x, _, td, jd = _case(geom)
    x_pad, (ty, tx) = pad_input_for_tiles(t(x), td)
    got = transform_input_tiles(x_pad, (ty, tx))
    _close(got.numpy(), jwd.transform_input_tiles(jnp.asarray(x_pad.numpy()), (ty, tx)))
    # an input smaller than the tiles cover is padded on the high side
    small = x_pad[:, :-1, :-1]
    _close(transform_input_tiles(small, (ty, tx)).numpy(), jwd.transform_input_tiles(jnp.asarray(small.numpy()),
                                                                                     (ty, tx)))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_pad_and_interleave_match_jax(geom):
    x, _, td, jd = _case(geom, seed=1)
    _close(pad_input_for_subconv(t(x), td).numpy(), jtdc.pad_input_for_subconv(jnp.asarray(x), jd), rel=False)
    S, HJ, WJ = td.stride, td.j_extent(5), td.j_extent(6)
    sub = np.random.default_rng(2).standard_normal((S, S, 2, HJ, WJ, 4)).astype(np.float32)
    out_hw = (td.out_size(5), td.out_size(6))
    _close(interleave_crop(t(sub), td, out_hw).numpy(), jtdc.interleave_crop(jnp.asarray(sub), jd, out_hw), rel=False)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_winograd_domain_matmuls_match_jax(geom, dense):
    x, w, td, jd = _case(geom, seed=3)
    x_pad, (ty, tx) = pad_input_for_tiles(t(x), td)
    xw = transform_input_tiles(x_pad, (ty, tx)).reshape(-1, 16, 3)
    got = winograd_domain_matmuls(xw, transform_weights(t(w), td), plan(td), dense=dense)
    want = jwd.winograd_domain_matmuls(jnp.asarray(xw.numpy()), jwd.transform_weights(jnp.asarray(w), jd),
                                       jtdc.plan(jd), dense=dense)
    _close(got.numpy(), want)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("impl", ["tdc", "winograd", "winograd_dense", "zero_padded", "lax"])
def test_whole_layer_deconvs_match_jax(impl, geom):
    x, w, td, jd = _case(geom, seed=4)
    ours = {"tdc": tdc_deconv2d, "winograd": winograd_deconv2d, "zero_padded": zero_padded_deconv2d,
            "lax": lax_deconv2d, "winograd_dense": lambda a, b, d: winograd_deconv2d(a, b, d, dense=True)}[impl]
    theirs = {"tdc": jtdc.tdc_deconv2d, "winograd": jwd.winograd_deconv2d, "zero_padded": jb.zero_padded_deconv2d,
              "lax": jb.lax_deconv2d, "winograd_dense": lambda a, b, d: jwd.winograd_deconv2d(a, b, d, dense=True)}[impl]
    got = ours(t(x), t(w), td)
    _close(got.numpy(), theirs(jnp.asarray(x), jnp.asarray(w), jd))
    # and every one of them is the scatter-sum deconvolution
    _close(got.numpy(), jb.standard_deconv2d(jnp.asarray(x), jnp.asarray(w), jd))
