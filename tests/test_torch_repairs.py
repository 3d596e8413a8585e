"""Port parity where the port once parted from the reference.

* ``lax_deconv2d`` / ``lax_deconv1d`` at every output_padding, those at or
  past the stride included (``F.conv_transpose*d`` refuses them; the
  reference's dilated form does not): against ``repro.core.baselines`` and
  ``repro.models.gan`` at atol 1e-5, and ``audio_decoder_apply(impl="lax")``
  on such a stack against the reference's at atol 1e-4 (the audio tests').
* ``GanServeEngine`` bucket counts when a generate raises: a direct
  ``generate`` counts its bucket before it runs, a dispatch only after
  success, in both packages alike.
* The small constant tensors the port caches per device (B^T, tile rows,
  packed inverse transforms, G, gather indices): one first built under a
  server's ``torch.inference_mode()`` is an ordinary tensor, so a later
  training step in the same process can save it for backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import gan_zoo as jzoo
from repro.core import baselines as jbaselines
from repro.core.tdc import DeconvDims as JDims
from repro.models import gan as jgan
from repro.serve.engine import GanServeEngine as JaxEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import audio_decoder_params_from_numpy, generator_params_from_numpy
from repro_torch.core import baselines
from repro_torch.core import winograd_deconv as W
from repro_torch.core.tdc import DeconvDims, conv_same_dims
from repro_torch.kernels import ops as tops
from repro_torch.models import gan as G
from repro_torch.serve import GanServeEngine

# (K, S, P, OP): two with output_padding >= stride, DCGAN's K5S2 OP1, the zoo's K4S2 OP0
GEOMETRIES = [(3, 1, 1, 1), (4, 2, 1, 2), (5, 2, 2, 1), (4, 2, 1, 0)]


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "k{}s{}p{}op{}".format(*g))
def test_lax_deconv2d_matches_reference(geo):
    rng = np.random.default_rng(sum(geo))
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    w = rng.standard_normal((geo[0], geo[0], 3, 4)).astype(np.float32)
    want = np.asarray(jbaselines.lax_deconv2d(jnp.asarray(x), jnp.asarray(w), JDims(*geo)))
    got = baselines.lax_deconv2d(torch.from_numpy(x), torch.from_numpy(w), DeconvDims(*geo)).numpy()
    assert got.shape == want.shape == (2, DeconvDims(*geo).out_size(5), DeconvDims(*geo).out_size(6), 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "k{}s{}p{}op{}".format(*g))
def test_lax_deconv1d_matches_reference(geo):
    rng = np.random.default_rng(10 + sum(geo))
    x = rng.standard_normal((2, 7, 3)).astype(np.float32)
    w = rng.standard_normal((geo[0], 3, 4)).astype(np.float32)
    want = np.asarray(jgan.lax_deconv1d(jnp.asarray(x), jnp.asarray(w), JDims(*geo)))
    got = G.lax_deconv1d(torch.from_numpy(x), torch.from_numpy(w), DeconvDims(*geo)).numpy()
    assert got.shape == want.shape == (2, DeconvDims(*geo).out_size(7), 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_lax_audio_decoder_with_output_padding_past_the_stride():
    layers = [(3, 4, (3, 1, 1, 1), "relu"), (4, 2, (4, 2, 1, 2), "tanh")]
    jspecs = tuple(jbase.Deconv1dSpec(a, b, JDims(*g), act) for a, b, g, act in layers)
    specs = tuple(tbase.Deconv1dSpec(a, b, DeconvDims(*g), act) for a, b, g, act in layers)
    p = jax.tree_util.tree_map(np.asarray, jgan.audio_decoder_init(jax.random.PRNGKey(3), jspecs))
    rng = np.random.default_rng(3)
    for leaf in p.values():
        leaf["b"] = (0.1 * rng.standard_normal(leaf["b"].shape)).astype(np.float32)
    x = rng.standard_normal((2, 9, 3)).astype(np.float32)
    jp = {k: {kk: jnp.asarray(v) for kk, v in leaf.items()} for k, leaf in p.items()}
    want = np.asarray(jgan.audio_decoder_apply(jp, jspecs, jnp.asarray(x), impl="lax"))
    got = G.audio_decoder_apply(audio_decoder_params_from_numpy(p, specs, device="cpu"), specs,
                                torch.from_numpy(x), impl="lax").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _raise(*args, **kwargs):
    raise RuntimeError("generate failed")


def test_bucket_counts_when_a_generate_raises(monkeypatch):
    jcfg, tcfg = jzoo.tiny_dcgan("ref"), tzoo.tiny_dcgan("ref")
    p = jax.tree.map(np.asarray, jgan.generator_init(jax.random.PRNGKey(0), jcfg))
    jeng = JaxEngine(jax.tree.map(jnp.asarray, p), jcfg, batch=4)
    teng = GanServeEngine(generator_params_from_numpy(p, tcfg, device="cpu"), tcfg, batch=4, device="cpu")
    monkeypatch.setattr(jeng.archs[jeng.default_arch], "_generate", _raise)
    monkeypatch.setattr(teng.archs[teng.default_arch], "generate", _raise)
    z = np.zeros((3, 100), np.float32)

    # a direct generate counts its bucket before it runs
    with pytest.raises(RuntimeError):
        jeng.generate(jnp.asarray(z))
    with pytest.raises(RuntimeError):
        teng.generate(torch.from_numpy(z))
    assert teng.bucket_counts == jeng.bucket_counts == {4: 1}

    # a dispatch counts only after success
    jfut, tfut = jeng.submit(jnp.asarray(z[:2])), teng.submit(torch.from_numpy(z[:2]))
    with pytest.raises(Exception):
        jfut.result()
    with pytest.raises(RuntimeError):
        tfut.result()
    assert teng.bucket_counts == jeng.bucket_counts == {4: 1}
    assert teng.dispatch_log == jeng.dispatch_log == [(0,)]
    assert teng.served == jeng.served == 0


CONSTANTS = {
    "bt": (W._bt_on, (2, 3, torch.float32, "cpu")),
    "tile_rows": (W._tile_rows, (3, 2, 4, "cpu")),
    "inv": (tops._inv_on, (DeconvDims(5, 2, 2, 1), 2, 3, "cpu")),
    "conv_inv": (tops._conv_inv_on, (conv_same_dims(4, 2, 8), 2, 3, "cpu")),
    "g": (tops._g_on, (2, 3, "cpu")),
    "pack1d_idx": (tops._pack1d_idx_on, (DeconvDims(4, 2, 1, 0), 2, 3, "cpu")),
    "inv1d": (tops._inv1d_on, (("conv", 4, 2), "cpu")),
}


@pytest.mark.parametrize("name", list(CONSTANTS))
def test_device_constants_built_in_inference_mode_are_ordinary_tensors(name):
    fn, args = CONSTANTS[name]
    fn.cache_clear()
    with torch.inference_mode():
        first = fn(*args)
    assert not first.is_inference()
    assert fn(*args) is first  # built once


def test_training_gradient_after_an_inference_mode_transform():
    """The per-layer path's B^T Z B, first run by a server in inference mode,
    then differentiated by a training step (autograd saves the cached
    B^T and tile rows)."""
    W._bt_on.cache_clear()
    W._tile_rows.cache_clear()
    x = torch.randn((2, 6, 6, 3), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        want = W.transform_input_tiles(x, (2, 2))
    xg = x.clone().requires_grad_(True)
    got = W.transform_input_tiles(xg, (2, 2))
    got.square().sum().backward()
    assert torch.equal(got.detach(), want) and xg.grad is not None and bool(torch.isfinite(xg.grad).all())
