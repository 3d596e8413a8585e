"""Port parity of the per-layer generator and discriminator: the port's
``generator_apply`` and ``discriminator_apply`` for every per-layer impl,
on CPU tensors (the ``cuda*`` impls take the kernels' plain versions),
against the JAX package's impl that computes the same function on the CPU:

* raw-weight impls ``cuda``, ``cuda_fused_pre`` and ``ref`` against JAX
  ``ref`` (the port's ``cuda*`` are the reference's ``pallas*``, whose Pallas
  kernels the JAX package runs on the CPU only in interpret mode);
* packed impls ``cuda_prepacked``, ``cuda_fused_pre_prepacked`` and
  ``prepacked_ref`` against JAX ``prepacked_ref``;
* the baselines ``tdc`` and ``lax`` against JAX ``tdc`` and ``lax``.

Eval mode (non-trivial BN running statistics) and training mode (batch
statistics; the moved running statistics too), for tiny DCGAN (K5S2), a
narrowed ArtGAN (K4S2 and its trailing K3S1 layer) and a narrowed DiscoGAN
(the image-to-image encoder).  Packed and raw counterparts agree with each
other.  Tolerance atol 1e-5, rtol 1e-4 (images, logits, statistics)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import discriminator_params_from_numpy, generator_params_from_numpy
from repro_torch.models import gan as TG

TOL = dict(atol=1e-5, rtol=1e-4)
JAX_OF = {"cuda": "ref", "cuda_fused_pre": "ref", "ref": "ref", "tdc": "tdc", "lax": "lax",
          "cuda_prepacked": "prepacked_ref", "cuda_fused_pre_prepacked": "prepacked_ref",
          "prepacked_ref": "prepacked_ref"}
_JAX_CACHE: dict = {}


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


def _params(arch, packed):
    """JAX-initialised raw params with random BN statistics (numpy), or
    their JAX prepack."""
    cfg = dataclasses.replace(_narrow(jzoo, arch), deconv_impl="ref")
    p = jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(10)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
            v["scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    if packed:
        p = jax.tree.map(np.asarray, JG.prepack_generator(jax.tree.map(jnp.asarray, p), cfg))
    return p


def _input(cfg, batch=2):
    rng = np.random.default_rng(1)
    if cfg.z_dim:
        return rng.standard_normal((batch, cfg.z_dim)).astype(np.float32)
    return rng.standard_normal((batch, cfg.img_hw, cfg.img_hw, 3)).astype(np.float32)


def _jax(arch, jimpl, training):
    """The JAX generator's image and statistics, once per (arch, impl, mode)."""
    key = (arch, jimpl, training)
    if key not in _JAX_CACHE:
        cfg = dataclasses.replace(_narrow(jzoo, arch), deconv_impl=jimpl)
        p = _params(arch, jimpl == "prepacked_ref")
        img, stats = JG.generator_apply(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(_input(cfg)), training=training)
        _JAX_CACHE[key] = (np.asarray(img), jax.tree.map(np.asarray, stats))
    return _JAX_CACHE[key]


def _port(arch, impl, training):
    cfg = dataclasses.replace(_narrow(tzoo, arch), deconv_impl=impl)
    p = generator_params_from_numpy(_params(arch, TG.uses_prepacked(impl)), cfg, device="cpu")
    return TG.generator_apply(p, cfg, torch.from_numpy(_input(cfg)), training=training)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("impl", list(JAX_OF))
@pytest.mark.parametrize("arch", ["dcgan", "artgan", "discogan"])
def test_per_layer_generator_matches_jax(arch, impl, training):
    want, want_stats = _jax(arch, JAX_OF[impl], training)
    got, stats = _port(arch, impl, training)
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert set(stats) == set(want_stats)
    for k in stats:
        for kk in ("mean", "var"):
            np.testing.assert_allclose(stats[k][kk].numpy(), want_stats[k][kk], err_msg=f"{k}.{kk}", **TOL)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("raw,packed", [("cuda", "cuda_prepacked"), ("cuda_fused_pre", "cuda_fused_pre_prepacked"),
                                        ("ref", "prepacked_ref")])
def test_packed_and_raw_counterparts_agree(raw, packed, training):
    """A raw-weight impl and its prepacked equivalent (weights packed by the
    port's own ``prepack_generator``) serve the same images."""
    assert TG.PREPACKED_EQUIV[raw] == packed
    cfg = tzoo.tiny_dcgan(raw)
    p_raw = TG.generator_init(cfg, seed=3, device="cpu")
    p_packed = TG.prepack_generator(p_raw, cfg)
    z = torch.from_numpy(_input(cfg))
    a, _ = TG.generator_apply(p_raw, cfg, z, training=training)
    b, _ = TG.generator_apply(p_packed, dataclasses.replace(cfg, deconv_impl=packed), z, training=training)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_impl_tables_and_param_layouts():
    assert all(TG.uses_prepacked(i) for i in ("cuda_prepacked", "cuda_fused_pre_prepacked", "prepacked_ref",
                                              "cuda_chained", "chained_ref"))
    assert not any(TG.uses_prepacked(i) for i in ("cuda", "cuda_fused_pre", "ref", "tdc", "zero_padded", "lax"))
    assert TG.CHAINED_EQUIV == {"cuda_prepacked": "cuda_chained", "cuda_fused_pre_prepacked": "cuda_chained"}
    assert TG.CONV_PREPACKED_EQUIV == {"ref": "prepacked_ref", "cuda": "cuda_prepacked"}
    assert TG.CONV_CHAINED_EQUIV == {"cuda_prepacked": "cuda_chained"}
    assert TG.uses_prepacked_conv("cuda_prepacked") and not TG.uses_prepacked_conv("cuda")
    assert "ww" in TG.generator_init(tzoo.tiny_dcgan("cuda_prepacked"), device="cpu")["deconv0"]
    assert "w" in TG.generator_init(tzoo.tiny_dcgan("cuda"), device="cpu")["deconv0"]
    packed = TG.generator_init(tzoo.tiny_dcgan("cuda_prepacked"), device="cpu")
    with pytest.raises(ValueError, match="raw"):  # a raw-weight impl on packed params
        TG.generator_apply(packed, tzoo.tiny_dcgan("tdc"), torch.zeros(1, 100))
    with pytest.raises(ValueError, match="not one of"):
        TG.generator_apply(packed, tzoo.tiny_dcgan("pallas"), torch.zeros(1, 100))


# ------------------------------------------------------------ discriminator
D_JAX_OF = {"cuda": "ref", "ref": "ref", "cuda_prepacked": "prepacked_ref", "prepacked_ref": "prepacked_ref"}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("impl", list(D_JAX_OF))
def test_per_layer_discriminator_matches_jax(impl, training):
    jcfg = jzoo.tiny_dcgan("ref", D_JAX_OF[impl])
    dp = jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(4)
    for k, v in dp.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
        elif k.startswith("conv"):
            v["b"] = (0.1 * rng.standard_normal(v["b"].shape)).astype(np.float32)
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want, want_stats = JG.discriminator_apply(jax.tree.map(jnp.asarray, dp), jcfg, jnp.asarray(img), training=training)
    tcfg = tzoo.tiny_dcgan("ref", impl)
    got, stats = TG.discriminator_apply(discriminator_params_from_numpy(dp, tcfg, device="cpu"), tcfg,
                                        torch.from_numpy(img), training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(stats) == set(want_stats)
    for k in stats:
        for kk in ("mean", "var"):
            np.testing.assert_allclose(stats[k][kk].numpy(), np.asarray(want_stats[k][kk]), err_msg=f"{k}.{kk}",
                                       **TOL)
