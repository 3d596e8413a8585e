"""Port parity of the adversarial train step with both nets per layer: 3
steps of the port's ``make_gan_step`` on ``tiny_dcgan("cuda_prepacked",
"cuda_prepacked")`` (the unfused engine, kernels 1/4/5) and on
``tiny_dcgan("cuda_fused_pre_prepacked", "cuda_prepacked")`` (the fused
pre-PE engine in scratch mode, kernels 2/6/7), on CPU tensors, against JAX
``make_gan_step(tiny_dcgan("prepacked_ref", "prepacked_ref"))``, the
reference's per-layer plain step, which computes the same function; from
the same numpy params and the same JAX-made batches.  And the launches per
gradient pull of every engine wrapper.

Tolerances, as ``test_torch_train_step_chained.py``: step-1 gradients per
leaf within 1e-3 of the leaf's largest magnitude, a bias right before a
batch-statistics batchnorm (exact gradient zero) within 1e-5 of the tree's
largest gradient; metrics within 1e-3 relative every step; BN running
statistics within 1e-4 after step 1; parameters within 6·lr and running
statistics within 1e-3 after 3 steps.

The batches come from data stream ``DATA_SEED`` = 1, not 0: on stream 0 one
pre-activation of the discriminator's first layer sits within fp32 noise
of leaky_relu's kink, so the generator's summation order (the plain
per-layer path, ``prepacked_ref``, as much as the kernels') flips that
slope and moves the step past the tolerances below.
``test_data_is_away_from_leaky_relu_kinks`` checks the premise for the data
used here: 2e-7 changes of the generator's output leave the
discriminator's input gradient in place; ``test_stream0_sits_on_a_leaky_relu_kink``
shows that stream 0 fails it, and at which pre-activation.
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

B, STEPS, LR, DATA_SEED = 4, 3, 2e-4, 1
PORT_IMPLS = [("cuda_prepacked", "cuda_prepacked"), ("cuda_fused_pre_prepacked", "cuda_prepacked")]


def _randomise_bn(p, seed):
    rng = np.random.default_rng(seed)
    for k, v in p.items():
        if k.endswith("_bn"):
            c = v["mean"].shape[0]
            v["mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            v["var"] = (0.5 + rng.random(c)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def jax_run():
    """The JAX per-layer plain step, 3 times from one numpy start."""
    jcfg = jzoo.tiny_dcgan("prepacked_ref", "prepacked_ref")
    gp = _randomise_bn(jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(0), jcfg)), 1)
    dp = _randomise_bn(jax.tree.map(np.asarray, JG.discriminator_init(jax.random.PRNGKey(1), jcfg)), 2)
    batches = [(np.asarray(JD.latent_batch(DATA_SEED, s, B, jcfg.z_dim)),
                np.asarray(JD.gan_batch(DATA_SEED, s, B, 64))) for s in range(STEPS)]
    jstep = JT.make_gan_step(jcfg, settings=JT.StepSettings(lr=LR, b1=0.5))
    jg, jd = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    jgo, jdo = jadamw_init(jg), jadamw_init(jd)
    metrics, first = [], None
    for z, real in batches:
        jg, jd, jgo, jdo, m = jstep(jg, jd, jgo, jdo, jnp.asarray(z), jnp.asarray(real))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or (jg, jd, jgo, jdo)
    # step-1 gradients, as the step took them: AdamW's first moment after one
    # step from zero is (1 - b1) * g, exactly for b1 = 0.5
    grads = [jax.tree.map(lambda m: np.asarray(m) / 0.5, o.m) for o in first[2:]]
    return dict(start=(gp, dp), batches=batches, end=(jg, jd), metrics=metrics, first=first[:2], grads=grads)


@pytest.fixture(scope="module", params=PORT_IMPLS, ids=["unfused", "fused_pre"])
def runs(request, jax_run):
    """The port's 3-step run on ``request.param`` beside the JAX one."""
    tcfg = tzoo.tiny_dcgan(*request.param)
    gp, dp = jax_run["start"]
    tstep = make_gan_step(tcfg, settings=StepSettings(lr=LR, b1=0.5))
    tg, td = generator_params_from_numpy(gp, tcfg, device="cpu"), discriminator_params_from_numpy(dp, tcfg, device="cpu")
    tgo, tdo = adamw_init(tg), adamw_init(td)
    metrics, first = [], None
    for z, real in jax_run["batches"]:
        tg, td, tgo, tdo, m = tstep(tg, td, tgo, tdo, torch.from_numpy(z), torch.from_numpy(real))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or (tg, td, tgo, tdo)
    grads = [tree_map(lambda m: m / 0.5, o.m) for o in first[2:]]
    return dict(j=jax_run, t=dict(end=(tg, td), metrics=metrics, first=first[:2], grads=grads))


def _kink_probe(jax_run, seed, monkeypatch):
    """On data stream ``seed``'s first batch, through the plain per-layer
    nets: the largest move of the discriminator's input gradient under
    eight 2e-7 changes of the generator's output, and the smallest
    |pre-activation| of the discriminator's first leaky_relu with its index."""
    cfg = tzoo.tiny_dcgan("prepacked_ref", "prepacked_ref")
    gp, dp = jax_run["start"]
    tg, td = generator_params_from_numpy(gp, cfg, device="cpu"), discriminator_params_from_numpy(dp, cfg, device="cpu")
    z = np.asarray(JD.latent_batch(seed, 0, B, cfg.z_dim))
    fake, _ = TG.generator_apply(tg, cfg, torch.from_numpy(z), training=True)

    def input_grad(x):
        x = x.detach().clone().requires_grad_()
        logits, _ = TG.discriminator_apply(td, cfg, x, training=True)
        return torch.autograd.grad(TT._bce(logits, 1.0), x)[0]

    g0 = input_grad(fake)
    moves = []
    for s in range(8):
        noise = 2e-7 * torch.randn(fake.shape, generator=torch.Generator().manual_seed(s))
        moves.append((input_grad(fake + noise) - g0).abs().max().item())
    pre = []
    real_leaky = TG.L.leaky_relu
    monkeypatch.setattr(TG.L, "leaky_relu", lambda h: pre.append(h.detach()) or real_leaky(h))
    TG.discriminator_apply(td, cfg, fake.detach(), training=True)
    monkeypatch.undo()
    a = pre[0].abs()
    return max(moves), a.min().item(), np.unravel_index(int(a.argmin()), a.shape), a.max().item()


def test_data_is_away_from_leaky_relu_kinks(jax_run, monkeypatch):
    """The premise of comparing two fp32 paths through a piecewise-linear
    discriminator: perturbing the generator's output at the first batch by
    2e-7 (8 draws) leaves the discriminator's input gradient in place."""
    move, *_ = _kink_probe(jax_run, DATA_SEED, monkeypatch)
    assert move < 1e-4


def test_stream0_sits_on_a_leaky_relu_kink(jax_run, monkeypatch):
    """Why the batches are not from stream 0: there the discriminator's
    first layer has a pre-activation of 3.7e-9 (image 3, row 10, column
    22, channel 2), 2e-8 of the layer's largest and below fp32's rounding
    of it, and 2e-7 changes of the generator's output move the input
    gradient by 2e-3, which fails the premise above by 20x."""
    move, least, where, top = _kink_probe(jax_run, 0, monkeypatch)
    assert tuple(int(i) for i in where) == (3, 10, 22, 2)
    assert least < 1e-8 and least / top < np.finfo(np.float32).eps
    assert move > 1e-3


def test_step1_gradients_match_jax(runs):
    for jgrads, tgrads in zip(runs["j"]["grads"], runs["t"]["grads"]):
        names = [(k, kk) for k in tgrads for kk in tgrads[k]]
        top = max(float(np.abs(np.asarray(jgrads[k][kk])).max()) for k, kk in names)
        for k, kk in names:
            want = np.asarray(jgrads[k][kk])
            exact_zero = kk == "b" and f"{k}_bn" in tgrads  # bias right before a batch-stat BN
            atol = 1e-5 * top if exact_zero else 1e-3 * np.abs(want).max()
            np.testing.assert_allclose(tgrads[k][kk].numpy(), want, rtol=0, atol=atol, err_msg=f"{k}.{kk}")


def test_metrics_match_jax_every_step(runs):
    jm, tm = runs["j"]["metrics"], runs["t"]["metrics"]
    assert len(tm) == STEPS
    for a, b in zip(tm, jm):
        assert set(a) == set(METRIC_SPEC_KEYS) == set(b)
        assert a["nonfinite"] == b["nonfinite"] == 0.0
        for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)


def _bn_stats(tree):
    return [(k, kk) for k in tree if k.endswith("_bn") for kk in ("mean", "var")]


def test_bn_stats_match_jax_after_step_one(runs):
    for jtree, ttree in zip(runs["j"]["first"], runs["t"]["first"]):
        for k, kk in _bn_stats(ttree):
            np.testing.assert_allclose(ttree[k][kk].numpy(), np.asarray(jtree[k][kk]), atol=1e-4, rtol=0,
                                       err_msg=f"{k}.{kk}")


def test_params_and_bn_stats_match_jax_after_three_steps(runs):
    for jtree, ttree in zip(runs["j"]["end"], runs["t"]["end"]):
        assert set(jtree) == set(ttree)
        for k in ttree:
            for kk, v in ttree[k].items():
                want = np.asarray(jtree[k][kk])
                atol = 1e-3 if (k, kk) in _bn_stats(ttree) else 6 * LR
                np.testing.assert_allclose(v.numpy(), want, atol=atol, rtol=0, err_msg=f"{k}.{kk}")


@pytest.mark.parametrize("deconv_impl", [i for i, _ in PORT_IMPLS], ids=["unfused", "fused_pre"])
def test_per_layer_step_launches_per_pull(monkeypatch, deconv_impl):
    """Per step: the generator's engine 4 times forward and its two backward
    wrappers 4 times each, only in the G pull; nothing of the chained
    deconv corner's epilogue kernel; the per-layer discriminator's conv
    wrappers 8 / 11 / 12 times (G pull 4 + 4, D pull 7 + 8), as the chained
    discriminator's."""
    cfg = tzoo.tiny_dcgan(deconv_impl, "cuda_prepacked")
    fused_pre = deconv_impl == "cuda_fused_pre_prepacked"
    gen = ("fused_engine", "fused_engine_bwd_x", "fused_engine_bwd_w") if fused_pre else \
        ("domain_engine", "domain_engine_bwd_x", "domain_engine_bwd_w")
    names = (*gen, "conv_fused_engine", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_w")
    calls = dict.fromkeys(names, 0)
    modes = []

    def count(name):
        real = getattr(E, name)

        def wrapped(*a, **k):
            calls[name] += 1
            if name == "fused_engine":
                modes.append(k["out_mode"])
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
    assert "ww" in gp["deconv0"] and set(dp["conv0"]) == {"ww", "b"}
    step = make_gan_step(cfg)
    z, real = TD.latent_batch(0, 0, 2, cfg.z_dim, device="cpu"), TD.gan_batch(0, 0, 2, cfg.img_hw, device="cpu")
    *_, m = step(gp, dp, adamw_init(gp), adamw_init(dp), z, real)
    assert tuple(calls.values()) == (4, 4, 4, 8, 11, 12)
    assert pulls == [(0, 4, 4, 0, 4, 4), (0, 0, 0, 0, 7, 8)]
    assert modes == (["scratch"] * 4 if fused_pre else [])
    assert float(m["nonfinite"]) == 0.0
