"""The JAX side of the port's distributed tests: single-device reference
runs of ``tiny_dcgan`` on numpy inputs, and the train-step tolerances the
port's single-device parity tests hold (metrics 1e-3 relative, parameters
6·lr, batchnorm running statistics 1e-3 after 3 steps)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro import data as JD
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.optim import adamw_init as jadamw_init
from repro.train import trainer as JT

LR = 2e-4
METRICS = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")


def start(zoo_args, seed=0):
    """JAX's init for ``tiny_dcgan(*zoo_args)`` as numpy trees."""
    cfg = jzoo.tiny_dcgan(*zoo_args)
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return cfg, as_np(JG.generator_init(kg, cfg)), as_np(JG.discriminator_init(kd, cfg))


def batches(cfg, B, steps=3, seed=0):
    """JAX's (z, real) batches of steps 0..steps-1, as numpy."""
    return [(np.asarray(JD.latent_batch(seed, s, B, cfg.z_dim)), np.asarray(JD.gan_batch(seed, s, B, cfg.img_hw)))
            for s in range(steps)]


def steps(cfg, gp, dp, data, lr=LR):
    """JAX's single-device ``make_gan_step`` over ``data``: the metrics, the
    final params (numpy) and the step-1 gradients (AdamW's first moment over
    1 - b1)."""
    step = JT.make_gan_step(cfg, settings=JT.StepSettings(lr=lr, b1=0.5))
    g, d = jax.tree.map(jnp.asarray, gp), jax.tree.map(jnp.asarray, dp)
    go, do = jadamw_init(g), jadamw_init(d)
    metrics, first = [], None
    for z, real in data:
        g, d, go, do, m = step(g, d, go, do, jnp.asarray(z), jnp.asarray(real))
        metrics.append({k: float(v) for k, v in m.items()})
        if first is None:
            first = tuple(jax.tree.map(lambda v: np.asarray(v) / 0.5, o.m) for o in (go, do))
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(metrics=metrics, gp=as_np(g), dp=as_np(d), first=first)


def check_metrics(port, ref, rtol=1e-3):
    assert len(port) == len(ref)
    for s, (a, b) in enumerate(zip(port, ref)):
        assert a["nonfinite"] == b["nonfinite"] == 0.0, s
        for k in METRICS:
            assert abs(a[k] - b[k]) <= rtol * abs(b[k]), (s, k, a[k], b[k])


def check_params(port, ref, atol=6 * LR, stats_atol=1e-3):
    """Every leaf within ``atol``; batchnorm running statistics within
    ``stats_atol``."""
    assert set(port) == set(ref)
    for k in port:
        for kk, v in port[k].items():
            tol = stats_atol if k.endswith("_bn") and kk in ("mean", "var") else atol
            np.testing.assert_allclose(v, np.asarray(ref[k][kk]), atol=tol, rtol=0, err_msg=f"{k}.{kk}")


def tree_max_abs(a, b) -> float:
    return max(float(np.abs(np.asarray(a[k][kk]) - np.asarray(b[k][kk])).max()) for k in a for kk in a[k])


def save_start(directory, cfg, seed=0):
    """A step-0 checkpoint of JAX ``train_gan``'s own init for ``seed``."""
    from repro.train import checkpoint as JC

    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    gp, dp = JG.generator_init(kg, cfg), JG.discriminator_init(kd, cfg)
    JC.save_checkpoint(str(directory), 0, {"gp": gp, "dp": dp, "g_opt": jadamw_init(gp), "d_opt": jadamw_init(dp)})
