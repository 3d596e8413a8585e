"""Port parity of the adversarial train step: 3 steps of the port's
``make_gan_step(tiny_dcgan("cuda_chained", "lax"))`` on CPU tensors (the
generator's backward through the autograd Function over the backward
kernels' plain versions) against JAX ``make_gan_step(tiny_dcgan(
"chained_ref", "lax"))``, from the same numpy params (carried across by
``convert``) and the same JAX-made batches.

Tolerances: step-1 gradients per leaf within 1e-3 of the leaf's largest
magnitude; a bias right before a batch-statistics batchnorm (the stem's,
and the discriminator's convs but the first) has an exact gradient of
zero, which both packages give as fp32 noise, so those leaves are held to
1e-5 of the tree's largest gradient instead; every step's metrics within 1e-3
relative; BN running statistics after step 1 (taken from identical
params) within 1e-4; parameters after 3 steps within 6·lr, since AdamW's
first steps move each parameter by about lr·sign(g) and a gradient entry
near zero may take either sign in two correct implementations; the
running statistics after 3 steps, taken from params that may differ that
much, within 1e-3.

The JAX step is built and compiled once for the module (about 15-30 s);
the step-1 gradients are read from each step's AdamW first moment.
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
from repro_torch.optim import adamw_init
from repro_torch.train import METRIC_SPEC_KEYS, StepSettings, make_gan_step, nonfinite_flag
from repro_torch.train import trainer as TT
from repro_torch.tree import tree_leaves, tree_map

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
    jcfg, tcfg = jzoo.tiny_dcgan("chained_ref", "lax"), tzoo.tiny_dcgan("cuda_chained", "lax")
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


def test_port_step_leaves_its_inputs_and_uses_the_kernel_wrappers(monkeypatch):
    """The step returns new trees and leaves its inputs untouched; its
    generator backward runs each backward wrapper once per deconv layer, in
    the G pull only."""
    cfg = tzoo.tiny_dcgan("cuda_chained", "lax")
    from repro_torch.models import gan as TG

    gp = TG.generator_init(cfg, seed=0, device="cpu")
    dp = TG.discriminator_init(cfg, seed=1, device="cpu")
    before = tree_map(torch.clone, gp)
    calls = []
    real_x, real_w = E.fused_engine_bwd_x, E.fused_engine_bwd_w
    monkeypatch.setattr(E, "fused_engine_bwd_x", lambda *a, **k: (calls.append("x"), real_x(*a, **k))[1])
    monkeypatch.setattr(E, "fused_engine_bwd_w", lambda *a, **k: (calls.append("w"), real_w(*a, **k))[1])
    pulls = []
    real_grads = TT._grads

    def recording(loss, tree, *, retain_graph):
        n = len(calls)
        out = real_grads(loss, tree, retain_graph=retain_graph)
        pulls.append(len(calls) - n)
        return out

    monkeypatch.setattr(TT, "_grads", recording)
    step = make_gan_step(cfg)
    z = TD.latent_batch(0, 0, 2, cfg.z_dim, device="cpu")
    real = TD.gan_batch(0, 0, 2, cfg.img_hw, device="cpu")
    gp2, dp2, g_opt, d_opt, m = step(gp, dp, adamw_init(gp), adamw_init(dp), z, real)
    assert pulls == [2 * cfg.n_deconv, 0]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gp), tree_leaves(before)))
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(gp2)[:1], tree_leaves(gp)[:1]))
    assert g_opt.step == d_opt.step == 1 and float(m["nonfinite"]) == 0.0


def test_step_settings_and_sentinel():
    """The multi-device fields are accepted (parallel/ runs them); a mesh
    step without its mesh or its global batch is refused."""
    assert StepSettings(overlap=True).comm and StepSettings(grad_compression="int8").comm
    assert not StepSettings(mesh=object(), batch=8, bucket_bytes=1 << 20).comm
    with pytest.raises(ValueError, match="require mesh and batch"):
        make_gan_step(tzoo.tiny_dcgan(), settings=StepSettings(overlap=True))
    with pytest.raises(ValueError, match="needs mesh and batch"):
        make_gan_step(tzoo.tiny_dcgan(), settings=StepSettings(mesh=object()))
    cfg = StepSettings(deconv_impl="chained_ref", conv_impl="lax").apply_to_cfg(tzoo.tiny_dcgan("cuda_chained"))
    assert (cfg.deconv_impl, cfg.conv_impl) == ("chained_ref", "lax")
    ok = {k: torch.tensor(1.0) for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")}
    assert float(nonfinite_flag(ok)) == 0.0
    assert float(nonfinite_flag({**ok, "d_grad_norm": torch.tensor(float("inf"))})) == 1.0
    assert float(nonfinite_flag({**ok, "g_loss": torch.tensor(float("nan"))})) == 1.0


def test_synthetic_batches_are_functions_of_seed_and_step():
    a = TD.latent_batch(3, 5, 4, 10, device="cpu")
    assert torch.equal(a, TD.latent_batch(3, 5, 4, 10, device="cpu"))
    assert not torch.equal(a, TD.latent_batch(3, 6, 4, 10, device="cpu"))
    img = TD.gan_batch(3, 5, 2, 16, device="cpu")
    assert tuple(img.shape) == (2, 16, 16, 3) and img.abs().max() <= 1.0
    assert torch.equal(img, TD.gan_batch(3, 5, 2, 16, device="cpu"))
    assert img.std() > 0.01
