"""Port parity of the audio decoder (the reference's ``audio_decoder_init`` /
``audio_decoder_apply`` over ``configs.musicgen_medium.audio_decoder``): the
same numpy weights and latents through both packages.

* Every port impl (``lax``, ``tdc``, ``ref``, ``cuda``, and the reference's
  ``pallas`` read as ``cuda``) against JAX ``lax`` and ``ref``: atol 1e-4,
  the reference's own for this stack.
* Gradients of ``sum(y^2)`` in every weight and bias, through the 1D
  engine's ``Engine1dFn`` (``cuda`` on CPU tensors: the wrappers' plain
  versions) and through ``ref``, against JAX's: atol 2e-4, the reference's.
* ``audio_decoder_params_from_numpy`` round-trips and checks shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.musicgen_medium import audio_decoder as jaudio_decoder
from repro.models import gan as jgan
from repro_torch.configs import audio_decoder
from repro_torch.convert import audio_decoder_params_from_numpy
from repro_torch.kernels import engine as E
from repro_torch.models import gan as G

WIDTH, B, L = 4, 2, 11


@pytest.fixture(scope="module")
def case():
    """Numpy weights (the reference's init, non-zero biases) and a latent."""
    jspecs = jaudio_decoder(width=WIDTH)
    p = jax.tree_util.tree_map(np.asarray, jgan.audio_decoder_init(jax.random.PRNGKey(0), jspecs))
    rng = np.random.default_rng(0)
    for leaf in p.values():
        leaf["b"] = (0.1 * rng.standard_normal(leaf["b"].shape)).astype(np.float32)
    x = rng.standard_normal((B, L, jspecs[0].c_in)).astype(np.float32)
    return jspecs, p, x


def _jax_tree(p):
    return {k: {kk: jnp.asarray(v) for kk, v in leaf.items()} for k, leaf in p.items()}


def test_specs_match_the_reference():
    for a, b in zip(audio_decoder(WIDTH), jaudio_decoder(WIDTH)):
        assert (a.c_in, a.c_out, a.act) == (b.c_in, b.c_out, b.act)
        assert (a.dims.kernel, a.dims.stride, a.dims.padding, a.dims.output_padding) == \
            (b.dims.kernel, b.dims.stride, b.dims.padding, b.dims.output_padding)
    assert [s.c_in for s in audio_decoder()] == [256, 128, 64]


@pytest.mark.parametrize("impl", ["lax", "tdc", "ref", "cuda", "pallas"])
def test_forward_matches_jax(case, impl):
    jspecs, p, x = case
    specs = audio_decoder(WIDTH)
    jp = _jax_tree(p)
    got = G.audio_decoder_apply(audio_decoder_params_from_numpy(p, specs, device="cpu"), specs,
                                torch.from_numpy(x), impl=impl).numpy()
    assert got.shape == (B, L * 2 ** len(specs), specs[-1].c_out)
    for jimpl in ("lax", "ref"):
        want = np.asarray(jgan.audio_decoder_apply(jp, jspecs, jnp.asarray(x), impl=jimpl))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got).max() <= 1.0  # tanh waveform


@pytest.mark.parametrize("impl", ["cuda", "ref"])
def test_grads_match_jax(case, impl):
    jspecs, p, x = case
    specs = audio_decoder(WIDTH)
    g_want = jax.grad(lambda q: jnp.sum(jgan.audio_decoder_apply(q, jspecs, jnp.asarray(x), impl="lax") ** 2))(
        _jax_tree(p))
    tp = audio_decoder_params_from_numpy(p, specs, device="cpu")
    leaves = [v.requires_grad_(True) for leaf in tp.values() for v in leaf.values()]
    counts = [(f, a) for f in (E.winograd_conv1d_fused_engine, E.domain_engine_bwd_x, E.domain_engine_bwd_w)
              for a in ("launches", "rank1_launches", "scratch_launches") if hasattr(f, a)]
    before = [getattr(f, a) for f, a in counts]
    y = G.audio_decoder_apply(tp, specs, torch.from_numpy(x), impl=impl)
    grads = torch.autograd.grad((y**2).sum(), leaves)
    assert [getattr(f, a) for f, a in counts] == before  # CPU tensors: no kernel launched
    got = dict(zip([(k, kk) for k, leaf in tp.items() for kk in leaf], grads))
    for k, leaf in g_want.items():
        for kk, want in leaf.items():
            np.testing.assert_allclose(got[(k, kk)].numpy(), np.asarray(want), rtol=0, atol=2e-4)


def test_params_from_numpy_round_trip_and_checks(case):
    _, p, _ = case
    specs = audio_decoder(WIDTH)
    tp = audio_decoder_params_from_numpy(p, specs, device="cpu")
    assert set(tp) == set(p)
    for k, leaf in p.items():
        for kk, v in leaf.items():
            assert tp[k][kk].dtype == torch.float32
            np.testing.assert_array_equal(tp[k][kk].numpy(), v)
    with pytest.raises(ValueError, match="do not match"):
        audio_decoder_params_from_numpy(p, audio_decoder(WIDTH * 2), device="cpu")
    with pytest.raises(ValueError, match="param keys"):
        audio_decoder_params_from_numpy({k: p[k] for k in list(p)[:2]}, specs, device="cpu")
    # the port's own init: the reference's shapes, zero biases, from a seed or a generator
    a = G.audio_decoder_init(specs, seed=3, device="cpu")
    b = G.audio_decoder_init(specs, seed=torch.Generator().manual_seed(3), device="cpu")
    for k in a:
        assert a[k]["w"].shape == tp[k]["w"].shape and torch.equal(a[k]["w"], b[k]["w"])
        assert not a[k]["b"].any()
    with pytest.raises(ValueError, match="audio impl"):
        G.audio_decoder_apply(a, specs, torch.zeros((1, 3, specs[0].c_in)), impl="zero_padded")
