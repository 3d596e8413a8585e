"""Port parity of the eval-mode generator: JAX ``generator_apply`` with
``deconv_impl="chained_ref"`` against the port's ``generator_apply``, from
one JAX-initialised param tree (with non-trivial BN running statistics)
carried across by ``convert.generator_params_from_numpy``.  Tolerance
atol 1e-5, rtol 1e-4.

tiny_dcgan covers the K5S2 chain; a narrowed ArtGAN covers K4S2, the K3S1
last layer and the misaligned-hop NHWC fallback; a narrowed DiscoGAN covers
the image-to-image encoder."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import generator_params_from_numpy
from repro_torch.models import gan as TG

TOL = dict(atol=1e-5, rtol=1e-4)


def _narrow(zoo, arch):
    """The same narrowed config, built from either package's zoo."""
    if arch == "dcgan":
        return zoo.tiny_dcgan()
    if arch == "artgan":
        widths = [(16, 16), (16, 8), (8, 8), (8, 8), (8, 3)]
        return dataclasses.replace(
            zoo.ARTGAN, stem_ch=16,
            deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b) for d, (a, b) in zip(zoo.ARTGAN.deconvs, widths)),
        )
    enc = [(3, 8), (8, 8), (8, 8), (8, 8), (8, 8)]
    dec = [(8, 8), (8, 8), (8, 8), (8, 3)]
    return dataclasses.replace(
        zoo.DISCOGAN,
        encoder=tuple(dataclasses.replace(e, c_in=a, c_out=b) for e, (a, b) in zip(zoo.DISCOGAN.encoder, enc)),
        deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b) for d, (a, b) in zip(zoo.DISCOGAN.deconvs, dec)),
    )


def _jax_params(cfg, seed=0):
    """JAX-initialised params as numpy, BN running stats randomised."""
    p = jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 10)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
            v["scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return p


def _inputs(cfg, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.z_dim:
        return rng.standard_normal((batch, cfg.z_dim)).astype(np.float32)
    return rng.standard_normal((batch, cfg.img_hw, cfg.img_hw, 3)).astype(np.float32)


@pytest.mark.parametrize("arch", ["dcgan", "artgan", "discogan"])
def test_generator_matches_jax_chained_ref(arch):
    jcfg = dataclasses.replace(_narrow(jzoo, arch), deconv_impl="chained_ref")
    tcfg = dataclasses.replace(_narrow(tzoo, arch), deconv_impl="chained_ref")
    p = _jax_params(jcfg)
    inp = _inputs(jcfg)
    want, _ = JG.generator_apply(jax.tree.map(jax.numpy.asarray, p), jcfg, jax.numpy.asarray(inp),
                                 training=False)
    tp = generator_params_from_numpy(p, tcfg, device="cpu")
    got, stats = TG.generator_apply(tp, tcfg, torch.from_numpy(inp))
    assert got.shape == (inp.shape[0], 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the cuda impl on CPU tensors takes the plain version: equal, bit for bit,
    # as is a call with the batchnorm folded beforehand (as a server does)
    got_cuda, _ = TG.generator_apply(tp, dataclasses.replace(tcfg, deconv_impl="cuda_chained"),
                                     torch.from_numpy(inp), folded=TG.fold_eval_bn(tp, tcfg))
    assert torch.equal(got_cuda, got)
    assert all(k.endswith("_bn") for k in stats)


def test_raw_weights_prepack_to_the_same_generator():
    """Raw {"w"} params from JAX, packed by the port, serve the same images
    as JAX's own prepack."""
    jcfg = jzoo.tiny_dcgan("ref")
    p_raw = _jax_params(jcfg, seed=3)
    inp = _inputs(jcfg, seed=4)
    want, _ = JG.generator_apply(jax.tree.map(jax.numpy.asarray, p_raw), jcfg, jax.numpy.asarray(inp),
                                 training=False)
    tcfg = tzoo.tiny_dcgan("ref")
    tp = TG.prepack_generator(generator_params_from_numpy(p_raw, tcfg, device="cpu"), tcfg)
    got, _ = TG.generator_apply(tp, dataclasses.replace(tcfg, deconv_impl=TG.serve_impl(tcfg.deconv_impl)),
                                torch.from_numpy(inp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_impl_and_training_mode():
    for name in ("ref", "prepacked_ref", "pallas", "pallas_chained", "pallas_fused_pre_prepacked"):
        assert TG.serve_impl(name) == "cuda_chained"
    assert TG.serve_impl("chained_ref") == "chained_ref"
    cfg = tzoo.tiny_dcgan("cuda_chained")
    p = TG.generator_init(cfg, seed=0, device="cpu")
    assert "ww" in p["deconv0"]
    # training mode runs: batch statistics, moved running statistics
    img, stats = TG.generator_apply(p, cfg, torch.randn(2, cfg.z_dim), training=True)
    assert img.shape == (2, 64, 64, 3) and torch.isfinite(img).all()
    assert set(stats) == {"stem_bn", "deconv0_bn", "deconv1_bn", "deconv2_bn"}
    assert not torch.equal(stats["deconv0_bn"]["mean"], p["deconv0_bn"]["mean"])
    with pytest.raises(ValueError):
        TG.generator_apply(p, tzoo.tiny_dcgan("ref"), torch.zeros(1, cfg.z_dim))


def test_convert_rejects_mismatched_tree():
    cfg = tzoo.tiny_dcgan()
    p = _jax_params(jzoo.tiny_dcgan("ref"))
    del p["deconv3"]
    with pytest.raises(ValueError):
        generator_params_from_numpy(p, cfg, device="cpu")
