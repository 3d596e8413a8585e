"""Port parity of the training-mode pieces, from one numpy param tree and
numpy inputs fed to both packages:

* training-mode ``generator_apply`` (the port's ``cuda_chained`` on CPU
  tensors, which runs the autograd Function over the backward kernels'
  plain versions) against JAX ``chained_ref``: image, moved BN statistics
  and the gradients of a sum-of-squares loss, for tiny DCGAN and a narrowed
  ArtGAN (whose K4S2 -> K3S1 hop takes the NHWC fallback);
* training-mode ``batchnorm`` and ``discriminator_apply`` (``conv_impl="lax"``);
* ``adamw_update`` on the same numpy gradients.

Tolerances: forward values atol 1e-5 / rtol 1e-4; gradients within 1e-3 of
each leaf's largest magnitude (fp32 sums in other orders through a
batch-statistics backward), and no tighter than 1e-6 of the largest
gradient of the whole tree: a conv bias right before a batch-statistics
batchnorm has an exact gradient of zero, which fp32 gives as noise of that
size in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.models import layers as JL
from repro.optim import adam as JA
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import discriminator_params_from_numpy, generator_params_from_numpy
from repro_torch.models import gan as TG
from repro_torch.models import layers as TL
from repro_torch.optim import adam as TA
from repro_torch.tree import tree_leaves

TOL = dict(atol=1e-5, rtol=1e-4)


def _grads_close(got, want):
    """Per-leaf gradient check over two lists of leaves (see the module's
    tolerances)."""
    want = [np.asarray(w) for w in want]
    floor = 1e-6 * max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=max(1e-3 * np.abs(w).max(), floor))


def _narrow(zoo, arch):
    if arch == "dcgan":
        return zoo.tiny_dcgan()
    widths = [(16, 16), (16, 8), (8, 8), (8, 8), (8, 3)]
    return dataclasses.replace(
        zoo.ARTGAN, stem_ch=16, disc_channels=(8, 8, 8, 8),
        deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b) for d, (a, b) in zip(zoo.ARTGAN.deconvs, widths)),
    )


def _randomise_bn(p, seed):
    rng = np.random.default_rng(seed)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
            v["scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return p


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("arch", ["dcgan", "artgan"])
def test_training_generator_matches_jax_chained_ref(arch):
    jcfg = dataclasses.replace(_narrow(jzoo, arch), deconv_impl="chained_ref")
    tcfg = dataclasses.replace(_narrow(tzoo, arch), deconv_impl="cuda_chained")
    p = _randomise_bn(jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(0), jcfg)), 1)
    z = np.random.default_rng(2).standard_normal((3, jcfg.z_dim)).astype(np.float32)

    def jloss(gp):
        img, stats = JG.generator_apply(gp, jcfg, jnp.asarray(z), training=True)
        return jnp.sum(img * img), (img, stats)

    (_, (jimg, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_to_jax(p))
    tp = generator_params_from_numpy(p, tcfg, device="cpu")
    leaves = {k: {kk: v.requires_grad_() for kk, v in d.items() if kk not in ("mean", "var")} for k, d in tp.items()}
    img, stats = TG.generator_apply(tp, tcfg, torch.from_numpy(z), training=True)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), **TOL)
    assert set(stats) == set(jstats)
    for k in stats:
        for kk in ("mean", "var"):
            np.testing.assert_allclose(stats[k][kk].detach().numpy(), np.asarray(jstats[k][kk]), atol=1e-4, rtol=1e-4)
    names = [(k, kk) for k, d in leaves.items() for kk in d]
    grads = torch.autograd.grad(img.square().sum(), [leaves[k][kk] for k, kk in names])
    _grads_close([g.numpy() for g in grads], [jgrads[k][kk] for k, kk in names])


def test_training_batchnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = (2.0 + 3.0 * rng.standard_normal((4, 5, 6, 7))).astype(np.float32)
    p = _randomise_bn({"bn": {k: np.asarray(v) for k, v in JL.batchnorm_init(7).items()}}, 3)["bn"]
    want, wstats = JL.batchnorm(_to_jax(p), jnp.asarray(x), training=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, gstats = TL.batchnorm(tp, torch.from_numpy(x), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(gstats[k].numpy(), np.asarray(wstats[k]), **TOL)
    # eval mode takes the running statistics and returns them unchanged
    got_e, es = TL.batchnorm(tp, torch.from_numpy(x), training=False)
    want_e, _ = JL.batchnorm(_to_jax(p), jnp.asarray(x), training=False)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    assert es["mean"] is tp["mean"]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_discriminator_matches_jax(training):
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "lax"), tzoo.tiny_dcgan("cuda_chained", "lax")
    p = _randomise_bn(jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(5), jcfg)), 6)
    img = np.tanh(np.random.default_rng(7).standard_normal((3, 64, 64, 3))).astype(np.float32)

    def jf(dp, x):
        logit, stats = JG.discriminator_apply(dp, jcfg, x, training=training)
        return jnp.sum(logit), (logit, stats)

    (_, (jlogit, jstats)), (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        _to_jax(p), jnp.asarray(img))
    tp = discriminator_params_from_numpy(p, tcfg, device="cpu")
    ti = torch.from_numpy(img).requires_grad_()
    leaves = [v.requires_grad_() for d in tp.values() for kk, v in d.items() if kk not in ("mean", "var")]
    logit, stats = TG.discriminator_apply(tp, tcfg, ti, training=training)
    np.testing.assert_allclose(logit.detach().numpy(), np.asarray(jlogit), **TOL)
    for k in stats:
        for kk in ("mean", "var"):
            np.testing.assert_allclose(stats[k][kk].detach().numpy(), np.asarray(jstats[k][kk]), **TOL)
    grads = torch.autograd.grad(logit.sum(), leaves + [ti])
    want = [jgp[k][kk] for k, d in tp.items() for kk in d if kk not in ("mean", "var")] + [jgx]
    _grads_close([g.numpy() for g in grads], want)


def test_discriminator_shapes_and_other_impls():
    cfg = tzoo.tiny_dcgan("cuda_chained", "lax")
    p = TG.discriminator_init(cfg, seed=0, device="cpu")
    assert set(p) == {"conv0", "conv1", "conv2", "conv3", "conv1_bn", "conv2_bn", "conv3_bn", "head"}
    assert tuple(p["head"]["w"].shape) == (4 * 4 * 8, 1)
    logit, _ = TG.discriminator_apply(p, cfg, torch.zeros(2, 64, 64, 3))
    assert tuple(logit.shape) == (2, 1)
    # the reference's impl names are not the port's: an unknown impl raises
    with pytest.raises(ValueError, match="not one of"):
        TG.discriminator_apply(p, dataclasses.replace(cfg, conv_impl="pallas_chained"), torch.zeros(1, 64, 64, 3))
    bad = {k: {kk: v.numpy() for kk, v in d.items()} for k, d in p.items()}
    bad["conv1"]["w"] = bad["conv1"]["w"][:, :, :4]
    with pytest.raises(ValueError):
        discriminator_params_from_numpy(bad, cfg, device="cpu")


def test_cells_to_image_matches_jax():
    c = np.random.default_rng(4).standard_normal((2, 5, 6, 4, 3)).astype(np.float32)
    for out_hw, pad in (((10, 12), 0), ((7, 9), 2)):
        np.testing.assert_array_equal(TG._cells_to_image(torch.from_numpy(c), out_hw, pad).numpy(),
                                      np.asarray(JG._cells_to_image(jnp.asarray(c), out_hw, pad)))


def test_merge_bn_stats_matches_jax():
    p = {"a": {"w": np.ones(2, np.float32)}, "a_bn": {"scale": np.ones(2, np.float32), "mean": np.zeros(2, np.float32)}}
    s = {"a_bn": {"mean": np.full(2, 3.0, np.float32)}}
    want = JG.merge_bn_stats(p, s)
    got = TG.merge_bn_stats(p, s)
    assert jax.tree.map(lambda a, b: bool(np.array_equal(a, b)), want, got) == {
        "a": {"w": True}, "a_bn": {"scale": True, "mean": True}}


@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5], ids=["plain", "clipped"])
def test_adamw_update_matches_jax(max_grad_norm):
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)}, "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(lr=2e-4, b1=0.5, weight_decay=0.01, max_grad_norm=max_grad_norm)
    jp, jst = _to_jax(params), JA.adamw_init(_to_jax(params))
    tp = {"a": {"w": torch.from_numpy(params["a"]["w"])}, "b": torch.from_numpy(params["b"])}
    tst = TA.adamw_init(tp)
    for step in range(3):
        grads = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)}, "b": rng.standard_normal(5).astype(np.float32)}
        jp, jst, jm = JA.adamw_update(jp, _to_jax(grads), jst, **kw)
        tp, tst, tm = TA.adamw_update(tp, {"a": {"w": torch.from_numpy(grads["a"]["w"])},
                                           "b": torch.from_numpy(grads["b"])}, tst, **kw)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert tst.step == int(jst.step) == step + 1
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tree_leaves(tst.v), jax.tree.leaves(jst.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
