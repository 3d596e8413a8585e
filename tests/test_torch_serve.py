"""Port parity of ``GanServeEngine``: the same request sizes through the JAX
engine (``deconv_impl="ref"``, which serves ``prepacked_ref``) and the
port's engine on the CPU, from one param tree.  Scheduling must match
exactly (``dispatch_log``, ``bucket_counts``, ``served``); images within
atol 1e-5, never bitwise: a padded bucket sums in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.serve.engine import GanServeEngine as JaxEngine
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import generator_params_from_numpy
from repro_torch.serve import GanServeEngine

TOL = dict(atol=1e-5, rtol=1e-4)


def _artgan(zoo):
    widths = [(8, 8), (8, 8), (8, 8), (8, 8), (8, 3)]
    return dataclasses.replace(
        zoo.ARTGAN, stem_ch=8,
        deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b) for d, (a, b) in zip(zoo.ARTGAN.deconvs, widths)),
    )


def _params(cfg, seed):
    return jax.tree.map(np.asarray, JG.generator_init(jax.random.PRNGKey(seed), cfg))


def _zs(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, 100)).astype(np.float32) for b in sizes]


def test_serve_matches_jax_engine_single_arch():
    jcfg, tcfg = jzoo.tiny_dcgan("ref"), tzoo.tiny_dcgan("ref")
    p = _params(jcfg, 0)
    zs = _zs([3, 1, 2, 4, 1], 1)
    jeng = JaxEngine(jax.tree.map(jnp.asarray, p), jcfg, batch=4)
    want = jeng.run([jnp.asarray(z) for z in zs])
    teng = GanServeEngine(generator_params_from_numpy(p, tcfg, device="cpu"), tcfg, batch=4, device="cpu")
    got = teng.run([torch.from_numpy(z) for z in zs])
    assert teng.dispatch_log == jeng.dispatch_log == [(0, 1), (2,), (3,), (4,)]
    assert teng.bucket_counts == jeng.bucket_counts
    assert teng.served == jeng.served == 11
    assert teng.buckets == jeng.buckets
    for g, w, z in zip(got, want, zs):
        assert g.shape == (z.shape[0], 64, 64, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_serve_matches_jax_engine_two_archs():
    cfgs = {"dcgan": (jzoo.tiny_dcgan("ref"), tzoo.tiny_dcgan("ref")),
            "artgan": (_artgan(jzoo), _artgan(tzoo))}
    ps = {a: _params(jc, i) for i, (a, (jc, _)) in enumerate(cfgs.items())}
    jeng = JaxEngine(models={a: (jax.tree.map(jnp.asarray, ps[a]), jc) for a, (jc, _) in cfgs.items()}, batch=4)
    teng = GanServeEngine(
        models={a: (generator_params_from_numpy(ps[a], tc, device="cpu"), tc) for a, (_, tc) in cfgs.items()},
        batch=4, device="cpu",
    )
    plan = [("dcgan", 1), ("artgan", 2), ("dcgan", 1), ("artgan", 3), ("dcgan", 2)]
    zs = _zs([b for _, b in plan], 7)
    jf = [jeng.submit(jnp.asarray(z), arch=a) for (a, _), z in zip(plan, zs)]
    tf = [teng.submit(torch.from_numpy(z), arch=a) for (a, _), z in zip(plan, zs)]
    want = [f.result() for f in jf]
    got = [f.result() for f in tf]
    assert teng.dispatch_log == jeng.dispatch_log
    for a in cfgs:
        assert teng.archs[a].bucket_counts == jeng.archs[a].bucket_counts
        assert teng.archs[a].served == jeng.archs[a].served
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_serve_routing_and_limits():
    cfg = tzoo.tiny_dcgan()
    from repro_torch.models import gan as TG

    p = TG.generator_init(cfg, seed=0, device="cpu")
    eng = GanServeEngine(models={"a": (p, cfg), "b": (p, cfg)}, batch=4, device="cpu")
    assert eng.archs["a"].cfg.deconv_impl == "cuda_chained"
    with pytest.raises(ValueError):
        eng.submit(torch.zeros(1, 100))  # arch= required with two residents
    with pytest.raises(KeyError):
        eng.submit(torch.zeros(1, 100), arch="c")
    with pytest.raises(ValueError):
        eng.submit(torch.zeros(5, 100), arch="a")
    assert eng.bucket_for(3) == 4 and eng.buckets == (1, 2, 4)
    out = eng.generate(torch.zeros(3, 100), arch="b")
    assert out.shape == (3, 64, 64, 3) and eng.archs["b"].bucket_counts == {4: 1}


def test_serve_impl_per_layer_mapping():
    """chained=False: every name serves per layer on packed weights, on the
    kernels unless the plain version is asked for by name (``prepacked_ref``,
    or ``chained_ref``'s per-layer form)."""
    from repro_torch.models import gan as TG

    for name in ("pallas", "pallas_prepacked", "cuda", "cuda_prepacked", "ref"):
        assert TG.serve_impl(name, chained=False) == "cuda_prepacked"
    for name in ("pallas_fused_pre", "pallas_fused_pre_prepacked", "cuda_fused_pre", "cuda_fused_pre_prepacked"):
        assert TG.serve_impl(name, chained=False) == "cuda_fused_pre_prepacked"
    assert TG.serve_impl("chained_ref", chained=False) == "prepacked_ref"
    assert TG.serve_impl("prepacked_ref", chained=False) == "prepacked_ref"
    assert TG.serve_impl("cuda_chained", chained=False) == "cuda_fused_pre_prepacked"
    # the default stays the chained pipeline
    assert TG.serve_impl("ref") == TG.serve_impl("ref", chained=True) == "cuda_chained"


@pytest.mark.parametrize("impl", ["ref", "pallas_fused_pre"], ids=["unfused", "fused_pre"])
def test_serve_per_layer_matches_jax_engine(impl):
    """GanServeEngine(chained=False) schedules as the JAX engine with
    chained=False does, and its images (the port's per-layer engine, plain
    versions on CPU) match the JAX engine's (JAX ``ref`` serves its
    per-layer ``prepacked_ref``, the same function)."""
    jcfg, tcfg = jzoo.tiny_dcgan("ref"), tzoo.tiny_dcgan(impl)
    p = _params(jcfg, 5)
    zs = _zs([2, 1, 4, 3, 1], 6)
    jeng = JaxEngine(jax.tree.map(jnp.asarray, p), jcfg, batch=4, chained=False)
    assert jeng.cfg.deconv_impl == "prepacked_ref"
    want = jeng.run([jnp.asarray(z) for z in zs])
    teng = GanServeEngine(generator_params_from_numpy(p, tcfg, device="cpu"), tcfg, batch=4, device="cpu",
                          chained=False)
    assert teng.cfg.deconv_impl == ("cuda_prepacked" if impl == "ref" else "cuda_fused_pre_prepacked")
    assert "ww" in teng.params["deconv0"]
    got = teng.run([torch.from_numpy(z) for z in zs])
    assert teng.dispatch_log == jeng.dispatch_log
    assert teng.bucket_counts == jeng.bucket_counts
    assert teng.served == jeng.served == 11
    for g, w, z in zip(got, want, zs):
        assert g.shape == (z.shape[0], 64, 64, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
