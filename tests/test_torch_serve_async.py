"""Port parity of the futures API, deadline windows, multi-model residency,
the prepacked-generator registry, ``AsyncGanServer`` and the SLO metrics:
the scenarios of the reference's ``tests/test_serve_async.py`` replayed on
the JAX engine and the port's from one numpy param tree (``_serve_pair``).

Synchronous scenarios compare scheduling exactly; threaded ones compare
what is deterministic there (every request resolves, the outcomes add up,
images within atol 1e-5 / rtol 1e-4 of JAX's ``generator_apply``), never a
thread-timed ``dispatch_log``.  Every ``result()`` and ``stop()`` passes a
timeout, so a hang fails the test instead of eating the suite's limit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _serve_pair import CONFIGS, TOL, Side, assert_same, images, jserve, latents, pair, params, record, tserve
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.convert import generator_params_from_numpy
from repro_torch.models import gan as TG
from repro_torch.serve import metrics as SM


def _want(arch: str, seed: int, z: np.ndarray) -> np.ndarray:
    """JAX's eval-mode generator on ``z`` (raw weights, ``ref``)."""
    p = jax.tree.map(jnp.asarray, params(arch, seed))
    img, _ = JG.generator_apply(p, CONFIGS[arch](jzoo), jnp.asarray(z), training=False)
    return np.asarray(img)


# ---------------------------------------------------------------- futures
def test_futures_equivalent_to_legacy_drive():
    """submit/result and the deprecated try_admit/step loop are one core:
    the same dispatch batches, bucket counts and outputs, in each package
    and across them; each deprecated call warns."""
    zs = latents([3, 1, 2, 4, 1], 10)
    recs, outs = [], []
    for legacy, fut in zip(pair({"dcgan": 0}), pair({"dcgan": 0})):
        reqs = [legacy.S.GanRequest(rid=i, z=legacy.z(z)) for i, z in enumerate(zs)]
        pending = list(reqs)
        with pytest.warns(DeprecationWarning):
            while pending or legacy.eng.active:
                while pending and legacy.eng.try_admit(pending[0]):
                    pending.pop(0)
                legacy.eng.step()
        futs = [fut.eng.submit(fut.z(z)) for z in zs]
        got = [Side.np(f.result(timeout=120)) for f in futs]
        assert fut.eng.dispatch_log == legacy.eng.dispatch_log
        assert fut.eng.bucket_counts == legacy.eng.bucket_counts
        assert fut.eng.served == legacy.eng.served == sum(z.shape[0] for z in zs)
        for r, o in zip(reqs, got):
            np.testing.assert_array_equal(Side.np(r.out), o)
        recs.append(record(fut, futs))
        outs.append(got)
    assert_same(recs[0], recs[1], outs[0], outs[1])


def test_deprecated_poll_serves_only_a_closed_window():
    zs = latents([1, 1], 11)
    recs = []
    for s in pair({"dcgan": 0}):
        reqs = [s.S.GanRequest(rid=i, z=s.z(z)) for i, z in enumerate(zs)]
        with pytest.warns(DeprecationWarning):
            assert s.eng.try_admit(reqs[0], deadline_ms=10.0, now=0.0)
            assert s.eng.poll(now=5.0) == []  # the window is still open
            assert s.eng.try_admit(reqs[1], deadline_ms=50.0, now=6.0)
            done = s.eng.poll(now=10.0)  # the earliest deadline expired
        assert [r.rid for r in done] == [0, 1] and all(r.done for r in reqs)
        recs.append((s.eng.dispatch_log, s.eng.bucket_counts, [Side.np(r.out) for r in reqs]))
    assert recs[1][:2] == recs[0][:2]
    assert_same({}, {}, recs[0][2], recs[1][2])


def test_future_result_timeout():
    z = latents([1], 1)[0]
    recs = []
    for s in pair({"dcgan": 0}):
        f = s.eng.submit(s.z(z), deadline_ms=60_000.0)
        with pytest.raises(TimeoutError):
            f.result(timeout=0.05)
        assert not f.done()
        f2 = s.eng.submit(s.z(z))  # an immediate request closes the window
        assert f.result(timeout=120).shape[0] == 1 and f2.done()
        recs.append((record(s, [f, f2]), images([f, f2])))
    assert_same(recs[0][0], recs[1][0], recs[0][1], recs[1][1])


# --------------------------------------------- deadline-window edge cases
def test_deadline_window_edges():
    """A deadline already expired serves at once; an immediate request
    closes a window, in either order; a full pool closes it."""
    z, z2 = latents([1], 2)[0], latents([2], 4)[0]
    recs = []
    for s in pair({"dcgan": 0}):
        eng = s.eng
        eng.submit(s.z(z), deadline_ms=0.0, now=100.0)
        assert not eng.window_open(now=100.0)
        done = eng._dispatch(now=100.0)
        assert len(done) == 1 and done[0].done
        eng.submit(s.z(z), deadline_ms=1e6, now=0.0)
        assert eng.window_open(now=0.0)
        eng.submit(s.z(z), now=0.0)
        assert not eng.window_open(now=0.0)
        assert len(eng._dispatch(now=0.0)) == 2
        eng.submit(s.z(z), now=0.0)
        eng.submit(s.z(z), deadline_ms=1e6, now=0.0)
        assert not eng.window_open(now=0.0)
        assert len(eng._dispatch(now=0.0)) == 2
        eng.submit(s.z(z2), deadline_ms=1e6, now=0.0)
        assert eng.window_open(now=0.0)
        eng.submit(s.z(z2), deadline_ms=1e6, now=0.0)  # 4 of 4 rows
        assert not eng.window_open(now=0.0)
        assert [r.size for r in eng._dispatch(now=0.0)] == [2, 2]
        recs.append(record(s, []))
    assert recs[1] == recs[0]


# ---------------------------------------------------- multi-model residency
def test_multi_model_matches_single_model_engines():
    """Two archs resident in one engine, scheduled from one shared queue,
    give each single-model engine's images (bitwise within a package, as
    the reference asserts), and the packages agree."""
    za, zb = latents([2], 5)[0], latents([1], 6)[0]
    recs = []
    for multi, single_a, single_b in zip(pair({"dcgan": 0, "artgan": 1}), pair({"dcgan": 0}), pair({"artgan": 1})):
        fa, fb = multi.eng.submit(multi.z(za), arch="dcgan"), multi.eng.submit(multi.z(zb), arch="artgan")
        oa, ob = Side.np(fa.result(timeout=240)), Side.np(fb.result(timeout=240))
        assert multi.eng.dispatch_log == [(fa.request.rid, fb.request.rid)]
        np.testing.assert_array_equal(oa, Side.np(single_a.eng.generate(multi.z(za))))
        np.testing.assert_array_equal(ob, Side.np(single_b.eng.generate(multi.z(zb))))
        assert multi.eng.archs["dcgan"].bucket_counts == {2: 1}
        assert multi.eng.archs["artgan"].bucket_counts == {1: 1}
        recs.append((record(multi, [fa, fb]), [oa, ob]))
    assert_same(recs[0][0], recs[1][0], recs[0][1], recs[1][1])


def test_multi_model_requires_arch_and_validates_it():
    z = latents([1], 2)[0]
    for s in pair({"dcgan": 0, "artgan": 1}):
        with pytest.raises(ValueError):
            s.eng.submit(s.z(z))  # ambiguous on a multi-model engine
        with pytest.raises(KeyError):
            s.eng.submit(s.z(z), arch="nope")


# ---------------------------------------------------------------- registry
def test_prepack_registry_roundtrip():
    cfgs = {"jax": jzoo.tiny_dcgan("ref"), "torch": tzoo.tiny_dcgan("ref")}
    p = params("dcgan", 0)
    z = latents([1], 1)[0]
    out = {}
    for name, G, S in (("jax", JG, jserve), ("torch", TG, tserve)):
        G.clear_prepacked_generators()
        try:
            if name == "jax":
                entry = G.register_prepacked_generator("tiny", jax.tree.map(jnp.asarray, p), cfgs[name])
                assert entry.cfg.deconv_impl == "prepacked_ref"
            else:
                entry = G.register_prepacked_generator("tiny", generator_params_from_numpy(p, cfgs[name], "cpu"),
                                                       cfgs[name], device="cpu")
                assert entry.cfg.deconv_impl == "cuda_chained"  # the port's serve_impl deviation
                assert all("ww" in entry.params[f"deconv{i}"] for i in range(4))
            assert G.registered_archs() == ("tiny",) and G.get_prepacked_generator("tiny") is entry
            kw = {} if name == "jax" else {"device": "cpu"}
            eng = S.GanServeEngine(models={"tiny": "tiny"}, batch=2, **kw)
            assert eng.cfg.deconv_impl == entry.cfg.deconv_impl
            side = Side(name, S, G, eng)
            out[name] = Side.np(eng.submit(side.z(z)).result(timeout=120))
            G.clear_prepacked_generators()
            with pytest.raises(KeyError):
                G.get_prepacked_generator("tiny")
        finally:
            G.clear_prepacked_generators()
    np.testing.assert_allclose(out["torch"], out["jax"], **TOL)
    np.testing.assert_allclose(out["torch"], _want("dcgan", 0, z), **TOL)


# (reference cfg impl, port cfg impl, chained at registration) -> the five
# serving impls a port entry can hold: cuda_chained, chained_ref,
# cuda_prepacked, cuda_fused_pre_prepacked, prepacked_ref
ENTRIES = [("pallas", "pallas", True), ("chained_ref", "chained_ref", True), ("pallas", "pallas", False),
           ("pallas_fused_pre", "pallas_fused_pre", False), ("prepacked_ref", "chained_ref", False)]


@pytest.mark.parametrize("chained_engine", [True, False], ids=["chained_engine", "per_layer_engine"])
def test_registry_entry_serves_where_the_reference_would(chained_engine):
    """An engine serves a registry entry with the impl the reference's
    serves its counterpart with (its serve_impl passes chained and plain
    packed names through): an entry registered chained stays chained on a
    chained=False engine, prepacked_ref stays plain, and a per-layer kernel
    entry follows the engine's flag.  An entry registered on a mesh (its
    blocks) serves only on that mesh."""
    cfg_t = tzoo.tiny_dcgan("ref")
    p = generator_params_from_numpy(params("dcgan", 0), cfg_t, device="cpu")
    jp = jax.tree.map(jnp.asarray, params("dcgan", 0))
    try:
        for j_impl, t_impl, chained_entry in ENTRIES:
            t_entry = TG.register_prepacked_generator("a", p, tzoo.tiny_dcgan(t_impl), device="cpu",
                                                      chained=chained_entry)
            j_entry = JG.register_prepacked_generator("a", jp, jzoo.tiny_dcgan(j_impl), chained=chained_entry)
            assert TG.PORT_NAMES.get(j_entry.cfg.deconv_impl, j_entry.cfg.deconv_impl) == t_entry.cfg.deconv_impl
            teng = tserve.GanServeEngine(models={"a": "a"}, batch=2, device="cpu", chained=chained_engine)
            jeng = jserve.GanServeEngine(models={"a": "a"}, batch=2, chained=chained_engine)
            assert TG.PORT_NAMES.get(jeng.cfg.deconv_impl, jeng.cfg.deconv_impl) == teng.cfg.deconv_impl
            if chained_entry and t_impl == "pallas":
                assert teng.cfg.deconv_impl == "cuda_chained"
        # an entry registered on a mesh holds that mesh's blocks, and serves only on that mesh
        from _torch_dist import OneRankMesh

        one = OneRankMesh()
        entry = TG.register_prepacked_generator("a", p, cfg_t, device="cpu", mesh=one)
        full = TG.register_prepacked_generator("b", p, cfg_t, device="cpu")
        assert entry.mesh is one and full.mesh is None
        for k, leaves in full.params.items():
            assert all(torch.equal(entry.params[k][kk], v) for kk, v in leaves.items()), k
        with pytest.raises(ValueError, match="another mesh"):
            tserve.GanServeEngine(models={"a": "a"}, batch=2, device="cpu")
        assert tserve.GanServeEngine(models={"a": "a"}, batch=2, mesh=one).archs["a"].mesh is one
    finally:
        TG.clear_prepacked_generators()
        JG.clear_prepacked_generators()


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
def test_params_finite_and_generator_health(poison):
    """``params_finite`` / ``generator_health`` agree with the reference's
    on a clean packed tree and on one with a single non-finite value."""
    from repro_torch.models.gan import generator_health, params_finite, prepack_generator

    cfg_t, cfg_j = tzoo.tiny_dcgan("prepacked_ref"), jzoo.tiny_dcgan("prepacked_ref")
    tp = prepack_generator(generator_params_from_numpy(params("dcgan", 0), cfg_t, device="cpu"), cfg_t)
    tree = {k: {kk: v.numpy().copy() for kk, v in d.items()} for k, d in tp.items()}
    if poison:
        tree["deconv2"]["ww"][5, 1, 2] = np.nan if poison == "nan" else np.inf
    t_tree = {k: {kk: torch.from_numpy(v) for kk, v in d.items()} for k, d in tree.items()}
    j_tree = jax.tree.map(jnp.asarray, tree)
    assert params_finite(t_tree) == JG.params_finite(j_tree) == (poison is None)
    assert generator_health(t_tree, cfg_t) == JG.generator_health(j_tree, cfg_j)


# ------------------------------------------------------------- async server
def test_async_server_serves_and_stamps_slo():
    """The reference's own version asserts bitwise equality with
    ``generator_apply`` (one of its four known failures); here images are
    held within tolerance of JAX's generator, and the SLO stamps add up."""
    z = latents([1], 7)[0]
    want = _want("dcgan", 0, z)
    for s in pair({"dcgan": 0}):
        with s.S.AsyncGanServer(s.eng, max_queue=16, poll_interval_ms=0.5) as srv:
            futs = [srv.submit(s.z(z), deadline_ms=5.0) for _ in range(6)]
            outs = [Side.np(f.result(timeout=240)) for f in futs]
        assert srv.engine._driver is None
        for o in outs:
            np.testing.assert_allclose(o, want, **TOL)
        for f in futs:
            t = f.request.timing
            assert t is not None and t["e2e_ms"] >= 0 and t["compute_ms"] >= 0
            assert abs(t["queue_wait_ms"] + t["batch_wait_ms"] + t["compute_ms"] - t["e2e_ms"]) < 1e-6


def test_async_server_backpressure_rejects():
    z = latents([1], 8)[0]
    want = _want("dcgan", 0, z)
    for s in pair({"dcgan": 0}, batch=2):
        srv = s.S.AsyncGanServer(s.eng, max_queue=2, poll_interval_ms=0.5).start()
        served = rejected = 0
        try:
            futs = [srv.submit(s.z(z), deadline_ms=500.0) for _ in range(12)]
            for f in futs:
                try:
                    np.testing.assert_allclose(Side.np(f.result(timeout=240)), want, **TOL)
                    served += 1
                except s.S.GanServeRejected:
                    rejected += 1
        finally:
            srv.stop(timeout=60)
        assert rejected > 0 and served > 0 and served + rejected == 12
        assert srv.rejected_count == rejected
        assert all(f.done() for f in futs)


def test_async_server_stop_without_drain_rejects_inflight():
    z = latents([1], 9)[0]
    for s in pair({"dcgan": 0}):
        srv = s.S.AsyncGanServer(s.eng, max_queue=16).start()
        futs = [srv.submit(s.z(z), deadline_ms=60_000.0) for _ in range(3)]
        srv.stop(drain=False, timeout=60)
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=10)
                outcomes.append("served")
            except s.S.GanServeRejected as e:
                assert "without drain" in str(e)
                outcomes.append("rejected")
        assert all(f.done() for f in futs) and "rejected" in outcomes
        assert srv.rejected_count == outcomes.count("rejected")


def test_async_server_multi_model_under_load_accounts_for_every_request():
    """Two archs through one server, variable sizes and deadlines: every
    request resolves, the accounting reconciles, and every delivered image
    of the port's is within tolerance of the JAX server's on its latents."""
    rng = np.random.default_rng(12)
    plan = [("dcgan" if i % 3 else "artgan", int(rng.integers(1, 5)), [None, 2.0, 20.0][i % 3]) for i in range(16)]
    zs = [rng.standard_normal((b, 100)).astype(np.float32) for _, b, _ in plan]
    outs = []
    for s in pair({"dcgan": 0, "artgan": 1}):
        with s.S.AsyncGanServer(s.eng, max_queue=64, poll_interval_ms=0.5) as srv:
            futs = [srv.submit(s.z(z), arch=a, deadline_ms=d) for (a, _, d), z in zip(plan, zs)]
            for f in futs:
                f.result(timeout=240)
        assert all(f.request.done for f in futs)
        assert sum(s.eng.archs[a].served for a in s.eng.archs) == s.eng.served == sum(z.shape[0] for z in zs)
        assert sorted(r for batch in s.eng.dispatch_log for r in batch) == [f.request.rid for f in futs]
        summ = SM.summarize([f.request for f in futs], counters=srv.health()["archs"])
        assert summ["_all"]["requests"] == 16 and summ["_all"]["failed"] == 0
        outs.append(images(futs))
    assert_same({}, {}, outs[0], outs[1])


# ------------------------------------------------------------------ metrics
def test_metrics_percentile_and_summarize():
    from repro.serve import GanRequest as JR
    from repro.serve import metrics as JM
    from repro_torch.serve import GanRequest as TR

    for P in (SM, JM):
        assert P.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
        assert P.percentile([5.0], 99) == 5.0
        with pytest.raises(ValueError):
            P.percentile([], 50)

    def reqs(R, zeros):
        def req(rid, arch, t0, t3, size=1, rejected=False, failed=False):
            r = R(rid=rid, z=zeros((size, 4)), arch=arch)
            r.t_submit, r.t_admit = t0, t0 + 1.0
            r.t_dispatch, r.t_done = t0 + 2.0, t3
            r.done, r.rejected, r.failed = not (rejected or failed), rejected, failed
            return r

        return [req(0, "a", 0.0, 10.0), req(1, "a", 0.0, 20.0, size=3), req(2, "b", 5.0, 25.0),
                req(3, "b", 0.0, 0.0, rejected=True), req(4, "a", 1.0, 4.0, failed=True)]

    t_reqs, j_reqs = reqs(TR, torch.zeros), reqs(JR, jnp.zeros)
    out = SM.summarize(t_reqs)
    assert out["_all"]["requests"] == 3 and out["_all"]["rejected"] == 1 and out["_all"]["failed"] == 1
    assert out["_all"]["span_s"] == 0.025 and out["a"]["p50_ms"] == 15.0
    assert out["b"]["requests"] == 1 and out["b"]["rejected"] == 1
    assert SM.summarize(t_reqs, span_s=2.0)["_all"]["throughput_rps"] == 1.5
    counters = {"a": {"failures": 1, "state": "closed"}, "b": {"failures": 2, "state": "open"},
                "_server": {"restarts": 1}}
    for kw in ({}, {"span_s": 2.0}, {"counters": counters}):
        assert SM.summarize(t_reqs, **kw) == JM.summarize(j_reqs, **kw)
    assert [SM.request_timing(r) for r in t_reqs] == [JM.request_timing(r) for r in j_reqs]
    assert t_reqs[0].timing == j_reqs[0].timing


def test_serve_exports_the_reference_gan_names():
    gan_names = {n for n in jserve.__all__ if n not in ("Request", "ServeEngine")}
    assert gan_names <= set(tserve.__all__)
    assert all(hasattr(tserve, n) for n in tserve.__all__)


def test_server_batch_reads_on_the_callers_thread():
    """A batch made on the generate thread (under its own inference mode)
    reads on the caller's thread and equals the caller's own generate of
    the same bucket exactly."""
    z = latents([2], 13)[0]
    _, s = pair({"dcgan": 0})
    with s.S.AsyncGanServer(s.eng, poll_interval_ms=0.5) as srv:
        got = srv.submit(s.z(z)).result(timeout=120)
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy(), s.eng.generate(s.z(z)).numpy())
