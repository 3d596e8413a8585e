"""Port parity of the serve stack's failure semantics: every scenario of the
reference's ``tests/test_serve_faults.py`` replayed on the JAX engine and
the port's, from one numpy param tree (``_serve_pair``).  Each scenario
keeps the reference's own assertions on both sides, and the two sides'
scheduling (``dispatch_log``, ``bucket_counts``, ``served``), outcomes
(done / rejected / failed, the error's kind, message and attempts),
``health()`` and fault counts (``fired``, ``fired_by_kind``) must be
identical; images agree within atol 1e-5 / rtol 1e-4.

The synchronous scenarios run on virtual ``now=`` timestamps, as the
reference's do; the supervision scenarios use real threads and compare
what is deterministic there (outcomes, kinds, restart counts)."""
import threading
import time

import numpy as np
import pytest
import torch

from _serve_pair import assert_same, images, latents, outcome, pair, record

ZA, ZB = latents([1], 2)[0], latents([1], 3)[0]


def _two(**kw):
    return pair({"dcgan": 0, "artgan": 1}, **kw)


def _one(**kw):
    return pair({"dcgan": 0}, **kw)


def _both(sides, scenario):
    """Run ``scenario(side) -> (futs, plan)`` on both sides; compare."""
    recs, imgs = [], []
    for side in sides:
        futs, plan = scenario(side)
        recs.append(record(side, futs, plan))
        imgs.append(images(futs))
    assert_same(recs[0], recs[1], imgs[0], imgs[1])
    return recs[1]


# ------------------------------------------------------- failure isolation
def test_injected_exception_isolates_failing_arch():
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="raise", arch="dcgan", persistent=True)
        fa = s.eng.submit(s.z(ZA), arch="dcgan", now=0.0)
        fb = s.eng.submit(s.z(ZB), arch="artgan", now=0.0)
        s.eng._dispatch(now=0.0)
        assert s.eng.dispatch_log == [(fa.request.rid, fb.request.rid)]
        with pytest.raises(s.S.GanServeError) as ei:
            fa.result(timeout=1)
        assert ei.value.arch == "dcgan" and ei.value.kind == "exception"
        assert isinstance(ei.value.cause, s.S.InjectedFault)
        assert fb.result(timeout=1).shape[0] == 1 and fb.done()
        assert s.eng.archs["dcgan"].failures == 1 and s.eng.archs["artgan"].failures == 0
        assert fa.request.resolved and fa.request.t_done is not None
        return [fa, fb], plan

    _both(_two(max_retries=0), scenario)


@pytest.mark.parametrize("nan_guard", [True, False], ids=["guard", "no_guard"])
def test_nan_fault_with_and_without_guard(nan_guard):
    """The guard refuses a poisoned batch (kind "nan", one trip); without it
    the NaN batch is delivered (the caller owns output validation)."""
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="nan", persistent=True)
        f = s.eng.submit(s.z(ZA), now=0.0)
        s.eng._dispatch(now=0.0)
        res = s.eng.archs[s.eng.default_arch]
        if nan_guard:
            with pytest.raises(s.S.GanServeError) as ei:
                f.result(timeout=1)
            assert ei.value.kind == "nan" and res.nan_trips == 1
        else:
            assert np.isnan(s.np(f.result(timeout=1))).all() and res.nan_trips == 0
        return [f], plan

    _both(_one(max_retries=0, nan_guard=nan_guard), scenario)


def test_delay_fault_is_tail_latency_not_failure():
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="delay", delay_ms=1.0, persistent=True)
        f = s.eng.submit(s.z(ZA), now=0.0)
        s.eng._dispatch(now=0.0)
        assert f.result(timeout=1).shape[0] == 1
        assert plan.fired == 1 and s.eng.archs[s.eng.default_arch].failures == 0
        return [f], plan

    _both(_one(), scenario)


# ------------------------------------------------------------------ retry
def test_retry_recovers_transient_fault():
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="raise", rate=1.0, persistent=False)
        f = s.eng.submit(s.z(ZA), now=0.0)
        s.eng._dispatch(now=0.0)
        assert f.result(timeout=1).shape[0] == 1
        res = s.eng.archs[s.eng.default_arch]
        assert f.request.attempts == 2 and res.retries == 1 and res.failures == 0
        assert res.breaker.state == "closed"
        return [f], plan

    _both(_one(max_retries=2), scenario)


def test_retry_never_runs_past_deadline():
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="raise", rate=1.0, persistent=False)
        f = s.eng.submit(s.z(ZA), deadline_ms=0.0, now=0.0)
        s.eng._dispatch(now=0.0)
        with pytest.raises(s.S.GanServeError) as ei:
            f.result(timeout=1)
        assert ei.value.kind == "deadline" and ei.value.attempts == 1
        res = s.eng.archs[s.eng.default_arch]
        assert res.retries == 0 and res.failures == 1
        return [f], plan

    _both(_one(max_retries=2, backoff_ms=2.0), scenario)


def test_retry_exhaustion_counts_one_breaker_failure():
    def scenario(s):
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="raise", persistent=True)
        f = s.eng.submit(s.z(ZA), now=0.0)
        s.eng._dispatch(now=0.0)
        with pytest.raises(s.S.GanServeError) as ei:
            f.result(timeout=1)
        assert ei.value.attempts == 3
        br = s.eng.archs[s.eng.default_arch].breaker
        assert br.consecutive_failures == 1 and br.state == "closed"
        return [f], plan

    _both(_one(max_retries=2, breaker_threshold=3), scenario)


# -------------------------------------------------------------- quarantine
def test_quarantine_fast_reject_halfopen_recovery():
    def scenario(s):
        eng = s.eng
        res = eng.archs["dcgan"]
        eng.fault_plan = plan = s.S.FaultPlan(kind="raise", arch="dcgan", persistent=True)
        futs = []
        for t in (0.0, 10.0):
            f = eng.submit(s.z(ZA), arch="dcgan", now=t)
            eng._dispatch(now=t)
            with pytest.raises(s.S.GanServeError):
                f.result(timeout=1)
            futs.append(f)
        assert res.breaker.state == "open" and res.breaker.trips == 1
        with pytest.raises(s.S.GanServeRejected, match="quarantined after 2") as ei:
            eng.submit(s.z(ZA), arch="dcgan", now=20.0)
        futs.append(str(ei.value))
        fb = eng.submit(s.z(ZB), arch="artgan", now=20.0)
        eng._dispatch(now=20.0)
        assert fb.result(timeout=1).shape[0] == 1
        eng.fault_plan = None
        fp = eng.submit(s.z(ZA), arch="dcgan", now=150.0)
        assert res.breaker.state == "half_open"
        eng._dispatch(now=150.0)
        assert fp.result(timeout=1).shape[0] == 1
        assert res.breaker.state == "closed" and res.breaker.recoveries == 1
        h = eng.health()["dcgan"]
        assert h["breaker_trips"] == 1 and h["breaker_recoveries"] == 1
        return futs + [fb, fp], plan

    _both(_two(max_retries=0, breaker_threshold=2, breaker_cooldown_ms=100.0), scenario)


def test_failed_halfopen_probe_reopens():
    def scenario(s):
        eng = s.eng
        res = eng.archs[eng.default_arch]
        eng.fault_plan = plan = s.S.FaultPlan(kind="raise", persistent=True)
        f = eng.submit(s.z(ZA), now=0.0)
        eng._dispatch(now=0.0)
        with pytest.raises(s.S.GanServeError):
            f.result(timeout=1)
        assert res.breaker.state == "open"
        fp = eng.submit(s.z(ZA), now=200.0)
        assert res.breaker.state == "half_open"
        eng._dispatch(now=200.0)
        with pytest.raises(s.S.GanServeError):
            fp.result(timeout=1)
        assert res.breaker.state == "open" and res.breaker.trips == 2 and res.breaker.recoveries == 0
        return [f, fp], plan

    _both(_one(max_retries=0, breaker_threshold=1, breaker_cooldown_ms=100.0), scenario)


@pytest.mark.parametrize("nan_guard", [False, True], ids=["no_guard", "guard"])
def test_halfopen_probe_through_poisoned_weights(nan_guard):
    """The half-open probe is refused while the resident's packed weights
    hold a NaN: kind "weights" (the health gate, ``params_finite``) with the
    guard off; with it on the NaN batch trips the guard first (kind "nan",
    after every retry), as the reference's does.  Restoring the weights,
    the next probe serves and closes the breaker."""
    def scenario(s):
        eng = s.eng
        res = eng.archs[eng.default_arch]
        eng.fault_plan = plan = s.S.FaultPlan(kind="raise", persistent=True, max_faults=2)
        f = eng.submit(s.z(ZA), now=0.0)
        eng._dispatch(now=0.0)
        assert res.breaker.state == "open"
        clean = res.params
        ww = s.np(clean["deconv1"]["ww"]).copy()
        ww[3, 2, 1] = np.nan
        res.params = {**clean, "deconv1": {"ww": s.z(ww)}}
        assert not res.health_ok() and not s.G.params_finite(res.params)
        fp = eng.submit(s.z(ZA), now=200.0)
        eng._dispatch(now=200.0)
        with pytest.raises(s.S.GanServeError) as ei:
            fp.result(timeout=1)
        assert ei.value.kind == ("nan" if nan_guard else "weights")
        assert res.breaker.state == "open" and res.breaker.trips == 2
        res.params = clean
        fr = eng.submit(s.z(ZA), now=400.0)
        eng._dispatch(now=400.0)
        assert fr.result(timeout=1).shape[0] == 1
        assert res.breaker.state == "closed" and res.breaker.recoveries == 1
        return [f, fp, fr], plan

    _both(_one(max_retries=1, breaker_threshold=1, breaker_cooldown_ms=100.0, nan_guard=nan_guard), scenario)


def test_breaker_state_machine_pure():
    """The state machine alone, on virtual clocks, in both packages."""
    from repro.serve import CircuitBreaker as JB
    from repro_torch.serve import CircuitBreaker as TB

    trace = []
    for cls in (JB, TB):
        br, steps = cls(threshold=2, cooldown_ms=50.0), []
        assert br.allow_submit(0.0) == (True, "")
        br.on_failure(0.0)
        steps.append(br.counters())
        br.on_failure(1.0)
        assert br.state == "open"
        ok, reason = br.allow_submit(10.0)
        assert not ok and "quarantined" in reason
        steps.append((ok, reason, br.counters()))
        ok, _ = br.allow_submit(60.0)
        assert ok and br.state == "half_open"
        br.on_success()
        assert br.state == "closed" and br.recoveries == 1
        br.on_failure(70.0)
        assert br.state == "closed" and br.consecutive_failures == 1
        steps.append(br.counters())
        trace.append(steps)
    assert trace[1] == trace[0]


# -------------------------------------------------------------- fault plan
def test_fault_plan_targeting():
    from repro.serve import FaultPlan as JP
    from repro_torch.serve import FaultPlan as TP

    draws = []
    for cls in (JP, TP):
        plan = cls(kind="raise", every_n=2, arch="a", persistent=True)
        got = [plan.draw(arch=a, rids=(0,), dispatch_idx=i) for a, i in (("a", 0), ("a", 1), ("b", 2), ("a", 2))]
        assert got == ["raise", None, None, "raise"]
        plan2 = cls(kind="raise", rids=frozenset({7}))
        assert plan2.draw(arch="a", rids=(1, 2), dispatch_idx=0) is None
        assert plan2.draw(arch="a", rids=(7,), dispatch_idx=0) == "raise"
        assert plan2.draw(arch="a", rids=(7,), dispatch_idx=0, attempt=1) is None
        plan3 = cls(kind="mix", persistent=True, max_faults=3)
        kinds = [plan3.draw(arch="x", rids=(0,), dispatch_idx=i) for i in range(5)]
        assert kinds == ["raise", "nan", "delay", None, None]
        assert plan3.fired_by_kind == {"raise": 1, "nan": 1, "delay": 1}
        with pytest.raises(ValueError):
            cls(kind="segfault")
        # the seeded i.i.d. draw: the same seed fires on the same attempts
        plan4 = cls(kind="mix", rate=0.3, seed=5, persistent=True)
        got += [plan4.draw(arch="x", rids=(i,), dispatch_idx=i, attempt=i % 3) for i in range(200)]
        draws.append((got, plan4.fired, dict(plan4.fired_by_kind)))
    assert draws[1] == draws[0]
    assert 40 < draws[0][1] < 80


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_fault_mix_under_load_matches(seed):
    """A seeded mix of raise / nan / delay faults over a stream of
    variable-size requests with deadline windows, on virtual time: the
    breaker trips, rejects and recovers at the same submits in both
    packages, and every other count agrees."""
    rng = np.random.default_rng(100 + seed)
    zs = [rng.standard_normal((int(b), 100)).astype(np.float32) for b in rng.integers(1, 5, size=24)]
    deadlines = [None, 0.0, 3.0, 12.0]

    def scenario(s):
        eng = s.eng
        eng.fault_plan = plan = s.S.FaultPlan(kind="mix", rate=0.35, delay_ms=0.5, seed=seed)
        futs, t = [], 0.0
        for i, z in enumerate(zs):
            t = 4.0 * i
            try:
                futs.append(eng.submit(s.z(z), deadline_ms=deadlines[i % 4], now=t))
            except s.S.GanServeRejected as e:
                futs.append(str(e))
            if not eng.window_open(now=t):
                eng._dispatch(now=t)
        while eng._pending or eng.active:
            t += 4.0
            with eng._lock:
                eng._admit_pending(now=t)
            eng._dispatch(now=t)
        assert all(isinstance(f, str) or f.request.resolved for f in futs)
        return futs, plan

    rec = _both(_one(max_retries=1, nan_guard=True, breaker_threshold=2, breaker_cooldown_ms=20.0), scenario)
    kinds = {o.get("kind") for o in rec["outcomes"]}
    assert rec["fired"][0] > 0 and len(rec["dispatch_log"]) > 5
    assert kinds - {None} <= {"exception", "nan", "deadline"}


def test_healthy_path_unchanged_under_installed_but_idle_plan():
    """A plan that never matches leaves the serve path as with no plan:
    the dispatched image equals the direct generate's exactly in each
    package (the same bucket), and the packages agree within tolerance."""
    def scenario(s):
        base = s.np(s.eng.generate(s.z(ZA)))
        s.eng.fault_plan = plan = s.S.FaultPlan(kind="raise", arch="not-resident", persistent=True)
        f = s.eng.submit(s.z(ZA), now=0.0)
        s.eng._dispatch(now=0.0)
        np.testing.assert_array_equal(s.np(f.result(timeout=1)), base)
        assert plan.fired == 0
        return [f], plan

    _both(_one(), scenario)


# ------------------------------------------------------------- supervision
_dead_thread_ok = pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _threaded(scenario):
    """Run a supervision scenario on both sides; compare the outcomes, the
    server's restart / failure accounting, and the images."""
    outs = []
    for side in _one():
        futs, srv = scenario(side)
        h = srv.health()
        outs.append(([{k: v for k, v in outcome(f).items() if k != "rid"} for f in futs],
                     (srv.restart_count, h["restarts"], h["failed"], h["wedged"], srv.rejected_count),
                     images(futs)))
    (oj, sj, ij), (ot, st, it) = outs
    assert ot == oj and st == sj
    assert_same({}, {}, ij, it)


@_dead_thread_ok
def test_watchdog_restarts_dead_loop_and_fails_inflight():
    def scenario(s):
        eng = s.eng
        orig, calls = eng._dispatch, {"n": 0}

        def boom(now=None):
            if calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError("escaped the isolation boundary")
            return orig(now)

        eng._dispatch = boom
        srv = s.S.AsyncGanServer(eng, watchdog=True, watchdog_interval_ms=5.0, poll_interval_ms=0.5).start()
        try:
            f = srv.submit(s.z(ZA))
            with pytest.raises(s.S.GanServeError) as ei:
                f.result(timeout=30)
            assert ei.value.kind == "loop_dead" and srv.restart_count == 1
            f2 = srv.submit(s.z(ZA))
            assert f2.result(timeout=30).shape[0] == 1
            assert srv.healthy() and srv.health()["restarts"] == 1
        finally:
            srv.stop(timeout=30)
        return [f, f2], srv

    _threaded(scenario)


@_dead_thread_ok
def test_restart_budget_exhausted_fails_not_hangs():
    def scenario(s):
        def always_boom(now=None):
            raise RuntimeError("boom")

        s.eng._dispatch = always_boom
        srv = s.S.AsyncGanServer(s.eng, watchdog=True, watchdog_interval_ms=5.0, poll_interval_ms=0.5,
                                 max_restarts=0).start()
        try:
            f = srv.submit(s.z(ZA))
            with pytest.raises(s.S.GanServeError):
                f.result(timeout=30)
            deadline = time.monotonic() + 10
            while srv.healthy() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not srv.healthy() and srv.health()["failed"]
            f2 = srv.submit(s.z(ZA))
            with pytest.raises(s.S.GanServeRejected, match="restart budget"):
                f2.result(timeout=1)
        finally:
            srv.stop(drain=False, timeout=30)
        return [f, f2], srv

    _threaded(scenario)


@_dead_thread_ok
def test_result_never_hangs_when_loop_dead_and_no_watchdog():
    def scenario(s):
        def always_boom(now=None):
            raise RuntimeError("boom")

        s.eng._dispatch = always_boom
        srv = s.S.AsyncGanServer(s.eng, watchdog=False, poll_interval_ms=0.5).start()
        try:
            f = srv.submit(s.z(ZA))
            with pytest.raises(s.S.GanServeError) as ei:
                f.result(timeout=None)  # the hang case: an unbounded wait
            assert ei.value.kind == "loop_dead" and f.request.resolved
        finally:
            srv.stop(drain=False, timeout=30)
        return [f], srv

    _threaded(scenario)


def test_stop_under_wedge_fails_futures_and_raises():
    def scenario(s):
        entered = threading.Event()

        def wedge(now=None):
            entered.set()
            time.sleep(1.0)
            return []

        s.eng._dispatch = wedge
        srv = s.S.AsyncGanServer(s.eng, watchdog=False, poll_interval_ms=0.5).start()
        f = srv.submit(s.z(ZA))
        assert entered.wait(30)  # the generate loop is inside the wedged dispatch
        with pytest.raises(RuntimeError, match="still alive"):
            srv.stop(drain=False, timeout=0.3)
        assert "generate" in srv.wedged and not srv.healthy()
        with pytest.raises(s.S.GanServeError) as ei:
            f.result(timeout=1)
        assert ei.value.kind == "stop_wedged"
        return [f], srv

    _threaded(scenario)


# ------------------------------------------------------------ the port's own
def test_engine_kwargs_and_mesh():
    """The port's engine takes every constructor kwarg of the reference's,
    and holds them as the reference's does; on a mesh of one rank (blocks
    that are the whole leaves) it serves the single-device engine's
    images."""
    kw = dict(batch=4, buckets=(2,), chained=True, max_retries=5, backoff_ms=1.5, backoff_cap_ms=7.0,
              breaker_threshold=4, breaker_cooldown_ms=33.0, nan_guard=True)
    jside, tside = pair({"dcgan": 0}, **kw)
    for s in (jside, tside):
        s.eng.fault_plan = s.S.FaultPlan(kind="delay")
    attrs = ("buckets", "batch", "max_retries", "backoff_ms", "backoff_cap_ms", "nan_guard")
    assert [getattr(tside.eng, a) for a in attrs] == [getattr(jside.eng, a) for a in attrs]
    for s in (jside, tside):
        br = s.eng.archs["dcgan"].breaker
        assert (br.threshold, br.cooldown_ms) == (4, 33.0)
    from _serve_pair import models_for
    from repro_torch.serve import GanServeEngine

    from _torch_dist import OneRankMesh

    z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 100)).astype(np.float32))
    plain = GanServeEngine(models=models_for("torch", {"dcgan": 0}), device="cpu")
    meshed = GanServeEngine(models=models_for("torch", {"dcgan": 0}), device="cpu", mesh=OneRankMesh())
    assert meshed.archs["dcgan"].mesh is not None and meshed.device == torch.device("cpu")
    torch.testing.assert_close(meshed.generate(z), plain.generate(z), rtol=0, atol=0)
