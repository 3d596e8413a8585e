"""Both packages' GAN serve stacks side by side, for the port's serve parity
tests: one numpy param tree and one set of numpy latents feed the JAX
engine (``deconv_impl="ref"``, which serves ``prepacked_ref``) and the
port's engine on the CPU.  A scenario runs once per ``Side``; what it
records (scheduling, outcomes, error kinds and attempts, health, fault
counts) must be identical, and the images agree within ``TOL``, never
bitwise: the port's padded bucket sums in another order."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import serve as jserve
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro_torch import serve as tserve
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import generator_params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-4)


def tiny_artgan(zoo):
    """ArtGAN shrunk as the reference's serve tests shrink it (16-channel
    stem, 8-channel trunk): a second, structurally different resident."""
    last = len(zoo.ARTGAN.deconvs) - 1
    return dataclasses.replace(
        zoo.ARTGAN, stem_ch=16, deconv_impl="ref", disc_channels=(8, 8, 8, 8),
        deconvs=tuple(dataclasses.replace(d, c_in=16 if i == 0 else 8, c_out=8 if i < last else 3)
                      for i, d in enumerate(zoo.ARTGAN.deconvs)))


CONFIGS = {"dcgan": lambda zoo: zoo.tiny_dcgan("ref"), "artgan": tiny_artgan}


@functools.lru_cache(maxsize=None)
def params(arch: str, seed: int):
    """The reference's generator_init tree for ``arch``, as numpy."""
    return jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(seed), CONFIGS[arch](jzoo)))


def latents(sizes, seed: int, z_dim: int = 100):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, z_dim)).astype(np.float32) for b in sizes]


class Side:
    """One package's serve stack: its ``serve`` module (``S``), its models
    module (``G``), an engine, and conversions of numpy arrays to and from
    its tensors."""

    def __init__(self, name: str, S, G, eng):
        self.name, self.S, self.G, self.eng = name, S, G, eng

    def z(self, a: np.ndarray):
        return jnp.asarray(a) if self.name == "jax" else torch.from_numpy(a)

    @staticmethod
    def np(t) -> np.ndarray:
        return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def models_for(name: str, archs: dict[str, int]):
    """``models=`` of one package for ``archs`` ({arch: param seed})."""
    if name == "jax":
        return {a: (jax.tree.map(jnp.asarray, params(a, s)), CONFIGS[a](jzoo)) for a, s in archs.items()}
    return {a: (generator_params_from_numpy(params(a, s), CONFIGS[a](tzoo), device="cpu"), CONFIGS[a](tzoo))
            for a, s in archs.items()}


def pair(archs: dict[str, int], **kw) -> tuple[Side, Side]:
    """(JAX side, port side), each a GanServeEngine over ``archs`` with the
    same engine kwargs (``batch`` 4 unless given)."""
    kw.setdefault("batch", 4)
    jeng = jserve.GanServeEngine(models=models_for("jax", archs), **kw)
    teng = tserve.GanServeEngine(models=models_for("torch", archs), device="cpu", **kw)
    from repro_torch.models import gan as TG

    return Side("jax", jserve, JG, jeng), Side("torch", tserve, TG, teng)


def outcome(f) -> dict:
    """A future's outcome (or a submit's rejection message, given as a
    string), as plain data."""
    if isinstance(f, str):
        return {"submit_rejected": f}
    r, err = f.request, f.exception()
    return {
        "rid": r.rid, "arch": r.arch, "done": r.done, "rejected": r.rejected, "failed": r.failed,
        "attempts": r.attempts, "reject_reason": r.reject_reason,
        "error": None if err is None else type(err).__name__, "message": None if err is None else str(err),
        "kind": getattr(err, "kind", None), "err_attempts": getattr(err, "attempts", None),
        "cause": type(getattr(err, "cause", None)).__name__,
    }


def record(side: Side, futs, plan=None) -> dict:
    """What must be identical between the packages after a scenario."""
    eng = side.eng
    return {
        "dispatch_log": list(eng.dispatch_log),
        "bucket_counts": {a: dict(r.bucket_counts) for a, r in eng.archs.items()},
        "served": {a: r.served for a, r in eng.archs.items()},
        "engine_served": eng.served,
        "health": eng.health(),
        "outcomes": [outcome(f) for f in futs],
        "fired": None if plan is None else (plan.fired, dict(plan.fired_by_kind)),
    }


def images(futs) -> list:
    """The delivered images of ``futs`` as numpy (None where not done)."""
    return [Side.np(f.request.out) if not isinstance(f, str) and f.request.done else None for f in futs]


def assert_same(rec_j: dict, rec_t: dict, imgs_j=(), imgs_t=()) -> None:
    assert rec_t == rec_j
    assert len(imgs_t) == len(imgs_j)
    for a, b in zip(imgs_j, imgs_t):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.shape == a.shape
            if np.isnan(a).all():  # a NaN-poisoned batch served without the guard
                assert np.isnan(b).all()
            else:
                np.testing.assert_allclose(b, a, **TOL)
