"""Port parity of the adversarial train step with the chained engine on both
nets: 3 steps of the port's ``make_gan_step(tiny_dcgan("cuda_chained",
"cuda_chained"))`` on CPU tensors (both backwards through the autograd
Functions over the backward kernels' plain versions) against JAX
``make_gan_step(tiny_dcgan("chained_ref", "chained_ref"))``, from the same
numpy params (the discriminator's packed ``{"ww", "b"}`` leaves carried
across by ``convert``) and the same JAX-made batches.  And the launches per
gradient pull of every engine wrapper.

Tolerances, as ``test_torch_train_step.py`` (the ``lax`` discriminator's
step): step-1 gradients per leaf within 1e-3 of the leaf's largest
magnitude, a bias right before a batch-statistics batchnorm (whose exact
gradient is zero) within 1e-5 of the tree's largest gradient; metrics
within 1e-3 relative every step; BN running statistics within 1e-4 after
step 1; parameters within 6·lr and running statistics within 1e-3 after 3
steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as JD
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.optim import adamw_init as jadamw_init
from repro.train import trainer as JT
from repro_torch import data as TD
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import discriminator_params_from_numpy, generator_params_from_numpy
from repro_torch.kernels import engine as E
from repro_torch.models import gan as TG
from repro_torch.optim import adamw_init
from repro_torch.train import METRIC_SPEC_KEYS, StepSettings, make_gan_step
from repro_torch.train import trainer as TT
from repro_torch.tree import tree_map

B, STEPS, LR = 4, 3, 2e-4


def _randomise_bn(p, seed):
    rng = np.random.default_rng(seed)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def runs():
    """Both packages' 3-step runs from one numpy start, and the step-1
    gradients of each."""
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "chained_ref"), tzoo.tiny_dcgan("cuda_chained", "cuda_chained")
    gp = _randomise_bn(jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(0), jcfg)), 1)
    dp = _randomise_bn(jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(1), jcfg)), 2)
    batches = [(np.asarray(JD.latent_batch(0, s, B, jcfg.z_dim)), np.asarray(JD.gan_batch(0, s, B, 64)))
               for s in range(STEPS)]

    jstep = JT.make_gan_step(jcfg, settings=JT.StepSettings(lr=LR, b1=0.5))
    jg, jd = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    jgo, jdo = jadamw_init(jg), jadamw_init(jd)
    jmetrics, jfirst = [], None
    for z, real in batches:
        jg, jd, jgo, jdo, m = jstep(jg, jd, jgo, jdo, jnp.asarray(z), jnp.asarray(real))
        jmetrics.append({k: float(v) for k, v in m.items()})
        jfirst = jfirst or (jg, jd, jgo, jdo)

    tstep = make_gan_step(tcfg, settings=StepSettings(lr=LR, b1=0.5))
    tg, td = generator_params_from_numpy(gp, tcfg, device="cpu"), discriminator_params_from_numpy(dp, tcfg, device="cpu")
    tgo, tdo = adamw_init(tg), adamw_init(td)
    tmetrics, tfirst = [], None
    for z, real in batches:
        tg, td, tgo, tdo, m = tstep(tg, td, tgo, tdo, torch.from_numpy(z), torch.from_numpy(real))
        tmetrics.append({k: float(v) for k, v in m.items()})
        tfirst = tfirst or (tg, td, tgo, tdo)

    # step-1 gradients, as each package's step took them: AdamW's first
    # moment after one step from zero is (1 - b1) * g, exactly for b1 = 0.5
    grads = [(jax.tree.map(lambda m: np.asarray(m) / 0.5, jo.m), tree_map(lambda m: m / 0.5, to.m))
             for jo, to in ((jfirst[2], tfirst[2]), (jfirst[3], tfirst[3]))]
    return dict(j=(jg, jd, jmetrics), t=(tg, td, tmetrics), first=(jfirst[:2], tfirst[:2]), grads=grads)


def test_step1_gradients_match_jax(runs):
    for jgrads, tgrads in runs["grads"]:
        names = [(k, kk) for k in tgrads for kk in tgrads[k]]
        top = max(float(np.abs(np.asarray(jgrads[k][kk])).max()) for k, kk in names)
        for k, kk in names:
            want = np.asarray(jgrads[k][kk])
            exact_zero = kk == "b" and f"{k}_bn" in tgrads  # bias right before a batch-stat BN
            atol = 1e-5 * top if exact_zero else 1e-3 * np.abs(want).max()
            np.testing.assert_allclose(tgrads[k][kk].numpy(), want, rtol=0, atol=atol, err_msg=f"{k}.{kk}")


def test_metrics_match_jax_every_step(runs):
    jm, tm = runs["j"][2], runs["t"][2]
    assert len(tm) == STEPS
    for a, b in zip(tm, jm):
        assert set(a) == set(METRIC_SPEC_KEYS) == set(b)
        assert a["nonfinite"] == b["nonfinite"] == 0.0
        for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)


def _bn_stats(tree):
    return [(k, kk) for k in tree if k.endswith("_bn") for kk in ("mean", "var")]


def test_bn_stats_match_jax_after_step_one(runs):
    (jg, jd), (tg, td) = runs["first"]
    for jtree, ttree in ((jg, tg), (jd, td)):
        for k, kk in _bn_stats(ttree):
            np.testing.assert_allclose(ttree[k][kk].numpy(), np.asarray(jtree[k][kk]), atol=1e-4, rtol=0,
                                       err_msg=f"{k}.{kk}")


def test_params_and_bn_stats_match_jax_after_three_steps(runs):
    for jtree, ttree in zip(runs["j"][:2], runs["t"][:2]):
        assert set(jtree) == set(ttree)
        for k in ttree:
            for kk, v in ttree[k].items():
                want = np.asarray(jtree[k][kk])
                atol = 1e-3 if (k, kk) in _bn_stats(ttree) else 6 * LR
                np.testing.assert_allclose(v.numpy(), want, atol=atol, rtol=0, err_msg=f"{k}.{kk}")


def test_chained_step_launches_per_pull(monkeypatch):
    """Per step: the conv forward runs 8 times (4 layers x fake and real);
    the generator's kernels 4/4/4 with its backward only in the G pull;
    the conv backward kernels 4 + 4 in the G pull (bwd_w included, though
    that pull throws it away) and 7 + 8 in the D pull (conv0's bwd_x runs on
    the fake images, not on the real ones)."""
    cfg = StepSettings(conv_impl="cuda_chained").apply_to_cfg(tzoo.tiny_dcgan("cuda_chained", "lax"))
    assert (cfg.deconv_impl, cfg.conv_impl) == ("cuda_chained", "cuda_chained")
    names = ("fused_engine", "fused_engine_bwd_x", "fused_engine_bwd_w",
             "conv_fused_engine", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_w")
    calls = dict.fromkeys(names, 0)

    def count(name):
        real = getattr(E, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    for name in names:
        monkeypatch.setattr(E, name, count(name))
    pulls = []
    real_grads = TT._grads

    def recording(loss, tree, *, retain_graph):
        before = dict(calls)
        out = real_grads(loss, tree, retain_graph=retain_graph)
        pulls.append(tuple(calls[n] - before[n] for n in names))
        return out

    monkeypatch.setattr(TT, "_grads", recording)
    gp = TG.generator_init(cfg, seed=0, device="cpu")
    dp = TG.discriminator_init(cfg, seed=1, device="cpu")
    step = make_gan_step(cfg)
    z, real = TD.latent_batch(0, 0, 2, cfg.z_dim, device="cpu"), TD.gan_batch(0, 0, 2, cfg.img_hw, device="cpu")
    *_, m = step(gp, dp, adamw_init(gp), adamw_init(dp), z, real)
    assert tuple(calls.values()) == (4, 4, 4, 8, 11, 12)
    assert pulls == [(0, 4, 4, 0, 4, 4), (0, 0, 0, 0, 7, 8)]
    assert float(m["nonfinite"]) == 0.0
