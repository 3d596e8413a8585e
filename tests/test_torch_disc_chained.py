"""Port parity of the chained Winograd-conv discriminator, from one numpy
param tree and numpy images fed to both packages:

* the port's ``chained_ref`` and ``cuda_chained`` (on CPU tensors: the
  autograd Function over the conv kernels' plain versions) against JAX
  ``chained_ref`` on the same packed params, and against JAX ``lax`` on the
  same raw params (packed by ``prepack_discriminator`` inside the port's
  graph, so the gradients reach the raw weights), in training and eval mode:
  logits, BN statistics and per-leaf gradients;
* ``prepack_discriminator``, ``discriminator_init`` and the converter;
* a tripwire: ``cuda_chained`` training calls each conv wrapper once per
  layer per pass and never ``F.conv2d``.

Tolerances: logits atol 1e-5 / rtol 1e-4; BN statistics atol 1e-4;
gradients within 1e-3 of each leaf's largest magnitude, except a conv bias
right before a batch-statistics batchnorm (conv1-3 in training mode),
whose exact gradient is zero and which both packages give as fp32 noise:
it is held to 1e-5 of the tree's largest gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import discriminator_params_from_numpy
from repro_torch.kernels import engine as E
from repro_torch.models import gan as TG
from repro_torch.tree import tree_map

TOL = dict(atol=1e-5, rtol=1e-4)
B = 3


def _randomise_bn(p, seed):
    rng = np.random.default_rng(seed)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
            v["scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        elif "b" in v and k.startswith("conv"):
            v["b"] = (0.1 * rng.standard_normal(v["b"].shape)).astype(np.float32)
    return p


def _images(seed=7):
    return np.tanh(np.random.default_rng(seed).standard_normal((B, 64, 64, 3))).astype(np.float32)


def _jax_run(jcfg, p, img, training):
    """JAX logits, stats and gradients (params and image) of sum(logits)."""
    def jf(dp, x):
        logit, stats = JG.discriminator_apply(dp, jcfg, x, training=training)
        return jnp.sum(logit), (logit, stats)

    (_, (logit, stats)), (gp, gx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(img))
    return np.asarray(logit), stats, gp, np.asarray(gx)


def _check(logit, stats, grads, names, jlogit, jstats, jgrads, training):
    np.testing.assert_allclose(logit.detach().numpy(), jlogit, **TOL)
    assert set(stats) == set(jstats)
    for k in stats:
        for kk in ("mean", "var"):
            np.testing.assert_allclose(stats[k][kk].detach().numpy(), np.asarray(jstats[k][kk]), atol=1e-4, rtol=0,
                                       err_msg=f"{k}.{kk}")
    top = max(float(np.abs(np.asarray(w)).max()) for w in jgrads)
    for g, w, (k, kk) in zip(grads, jgrads, names):
        w = np.asarray(w)
        exact_zero = training and kk == "b" and f"{k}_bn" in stats
        atol = 1e-5 * top if exact_zero else 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=f"{k}.{kk}")


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("impl", ["chained_ref", "cuda_chained"])
def test_chained_disc_matches_jax_chained_ref(impl, training):
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "chained_ref"), tzoo.tiny_dcgan("cuda_chained", impl)
    p = _randomise_bn(jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(5), jcfg)), 6)
    assert set(p["conv0"]) == {"ww", "b"}  # packed params cross as they are
    img = _images()
    jlogit, jstats, jgp, jgx = _jax_run(jcfg, p, img, training)

    tp = discriminator_params_from_numpy(p, tcfg, device="cpu")
    ti = torch.from_numpy(img).requires_grad_()
    names = [(k, kk) for k, d in tp.items() for kk in d if kk not in ("mean", "var")]
    leaves = [tp[k][kk].requires_grad_() for k, kk in names]
    logit, stats = TG.discriminator_apply(tp, tcfg, ti, training=training)
    grads = torch.autograd.grad(logit.sum(), leaves + [ti])
    _check(logit, stats, grads, names + [("image", "x")], jlogit, jstats,
           [jgp[k][kk] for k, kk in names] + [jgx], training)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("impl", ["chained_ref", "cuda_chained"])
def test_chained_disc_matches_jax_lax(impl, training):
    """The same raw params through JAX's XLA convolution and the port's
    conv engine: the pack runs inside the port's graph, so every raw leaf
    gets its gradient."""
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "lax"), tzoo.tiny_dcgan("cuda_chained", impl)
    p = _randomise_bn(jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(8), jcfg)), 9)
    img = _images(10)
    jlogit, jstats, jgp, jgx = _jax_run(jcfg, p, img, training)

    raw = discriminator_params_from_numpy(p, tcfg, device="cpu")
    names = [(k, kk) for k, d in raw.items() for kk in d if kk not in ("mean", "var")]
    leaves = [raw[k][kk].requires_grad_() for k, kk in names]
    ti = torch.from_numpy(img).requires_grad_()
    logit, stats = TG.discriminator_apply(TG.prepack_discriminator(raw, tcfg), tcfg, ti, training=training)
    grads = torch.autograd.grad(logit.sum(), leaves + [ti])
    _check(logit, stats, grads, names + [("image", "x")], jlogit, jstats,
           [jgp[k][kk] for k, kk in names] + [jgx], training)


def test_prepack_discriminator_and_init_match_jax():
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "lax"), tzoo.tiny_dcgan("cuda_chained", "chained_ref")
    p = jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(3), jcfg))
    want = JG.prepack_discriminator(jax.tree.map(jnp.asarray, p), jcfg)
    got = TG.prepack_discriminator(discriminator_params_from_numpy(p, tcfg, device="cpu"), tcfg)
    assert set(got) == set(want)
    for k in got:
        assert set(got[k]) == set(want[k]), k
        for kk, v in got[k].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k][kk]), rtol=1e-6, atol=1e-7, err_msg=f"{k}.{kk}")
    again = TG.prepack_discriminator(got, tcfg)  # packed leaves pass through
    assert all(again[k]["ww"] is got[k]["ww"] for k in got if k.startswith("conv") and "ww" in got[k])

    init = TG.discriminator_init(tcfg, seed=0, device="cpu")
    dims = TG.disc_conv_dims(tcfg)
    assert [(d.kernel, d.stride, d.padding, d.pad_hi) for d in dims] == \
        [(d.kernel, d.stride, d.padding, d.pad_hi) for d in JG.disc_conv_dims(jcfg)]
    for i, c_in in enumerate((3, 8, 8, 8)):
        assert set(init[f"conv{i}"]) == {"ww", "b"}
        assert tuple(init[f"conv{i}"]["ww"].shape) == (36, c_in, 8)
    # a packed leaf of the wrong size is refused
    bad = jax.tree.map(np.asarray, want)
    bad["conv2"]["ww"] = bad["conv2"]["ww"][:35]
    with pytest.raises(ValueError, match="conv2"):
        discriminator_params_from_numpy(bad, tcfg, device="cpu")
    assert TG.uses_chained_conv("cuda_chained") and not TG.uses_chained_conv("lax")
    with pytest.raises(ValueError, match="not one of"):
        TG.discriminator_init(dataclasses.replace(tcfg, conv_impl="pallas_chained"), device="cpu")
    with pytest.raises(ValueError, match="prepack_discriminator"):
        TG.discriminator_apply(discriminator_params_from_numpy(p, tcfg, device="cpu"), tcfg, torch.zeros(1, 64, 64, 3))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_cuda_chained_runs_each_conv_wrapper_once_per_layer_and_no_conv2d(monkeypatch, training):
    cfg = tzoo.tiny_dcgan("cuda_chained", "cuda_chained")
    p = TG.discriminator_init(cfg, seed=0, device="cpu")
    calls = {"fwd": 0, "x": 0, "w": 0, "conv2d": 0, "plain_fwd": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(E, "conv_fused_engine", count("fwd", E.conv_fused_engine))
    monkeypatch.setattr(E, "conv_fused_engine_bwd_x", count("x", E.conv_fused_engine_bwd_x))
    monkeypatch.setattr(E, "conv_fused_engine_bwd_w", count("w", E.conv_fused_engine_bwd_w))
    monkeypatch.setattr(torch.nn.functional, "conv2d", count("conv2d", torch.nn.functional.conv2d))
    leaves = [p[f"conv{i}"]["ww"].requires_grad_() for i in range(4)]
    img = torch.tanh(torch.randn(2, 64, 64, 3)).requires_grad_()
    logit, _ = TG.discriminator_apply(p, cfg, img, training=training)
    assert (calls["fwd"], calls["x"], calls["w"]) == (4, 0, 0)
    monkeypatch.setattr(E, "conv_fused_engine_plain", count("plain_fwd", E.conv_fused_engine_plain))
    torch.autograd.grad(logit.sum(), leaves + [img])
    assert (calls["fwd"], calls["x"], calls["w"]) == (4, 4, 4)
    assert calls["conv2d"] == 0 and calls["plain_fwd"] == 0


def test_backends_give_the_same_gradients():
    """cuda_chained (Function + backward plain versions) and chained_ref
    (autograd through the plain forward) agree on CPU."""
    cfg = tzoo.tiny_dcgan("cuda_chained", "cuda_chained")
    p = TG.discriminator_init(cfg, seed=1, device="cpu")
    img = torch.tanh(torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)))
    out = {}
    for impl in ("cuda_chained", "chained_ref"):
        q = tree_map(lambda t: t.clone().requires_grad_(), p)
        logit, _ = TG.discriminator_apply(q, dataclasses.replace(cfg, conv_impl=impl), img, training=True)
        out[impl] = torch.autograd.grad(logit.square().sum(), [q[f"conv{i}"]["ww"] for i in range(4)])
    for a, b in zip(out["cuda_chained"], out["chained_ref"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4 * b.abs().max().item() + 1e-7)
