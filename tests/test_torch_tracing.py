"""The port's tracer (``repro_torch.tracing``) on the CPU profiler: off, a
span site reads torch's profiler flag once and enters no
``record_function``; on, records nest with their parents and owners (across
threads too), sessions stay apart and bounded, every record sits on the
exported chrome trace's clock, and the train step and ``GanServeEngine``
record the spans the benchmark's readers read."""
from __future__ import annotations

import json
import threading

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import gan_zoo
from repro_torch.models import gan as G

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profile():
    return torch.profiler.profile(activities=CPU)


def _off_site():
    """A span site run with the profiler off: it ends the live session."""
    with tracing.span("off"):
        pass


def test_torch_profiler_flag_is_where_the_tracer_reads_it():
    prof = torch.autograd.profiler
    assert tracing._profiler is prof
    assert prof._is_profiler_enabled is False
    with _profile():
        assert prof._is_profiler_enabled is True
    assert prof._is_profiler_enabled is False


class _CountingFlag:
    """torch's profiler module, with every read of its flag counted."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return torch.autograd.profiler._is_profiler_enabled


def test_off_a_span_site_reads_the_flag_once_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: entered.append(a))
    flag = _CountingFlag()
    monkeypatch.setattr(tracing, "_profiler", flag)
    before = tracing.last_session()
    sites = [lambda: tracing.span("a"), lambda: tracing.span("b", owner=("request", 1)),
             lambda: tracing.scope("c", ("step", 0)), lambda: tracing.sync("d", "here"),
             lambda: tracing.sync("e", "here", when=False)]
    for i, site in enumerate(sites, 1):
        ctx = site()
        assert ctx is tracing._OFF and flag.reads == i
        with ctx:
            pass
    assert not entered and tracing.last_session() is before


def test_off_a_train_step_records_nothing(monkeypatch):
    entered = []
    real_rf = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: entered.append(a) or real_rf(*a, **k))
    step, args = _tiny_step()
    before = tracing.last_session()
    step(*args)
    assert not entered and tracing.last_session() is before


def test_records_nest_with_parents_and_owners_across_threads():
    _off_site()
    inside, done = threading.Event(), threading.Event()

    def device_thread():  # as autograd's device thread during a pull: no span of its own open
        inside.wait(5)
        with tracing.sync("t.mark", "elsewhere"):
            pass
        with tracing.span("t.client", owner=("request", 9)):  # a client's submit meanwhile: its own root
            pass
        done.set()

    th = threading.Thread(target=device_thread)
    th.start()
    with _profile():
        with tracing.scope("t.step", ("step", 7)):
            with tracing.span("t.pull"):
                inside.set()
                assert done.wait(5)
            with tracing.sync("t.wait", "here"):
                pass
        with tracing.span("t.submit", owner=("request", 3)):
            with tracing.sync("t.copy", "there"):
                pass
        with tracing.span("t.loose"):
            pass
    th.join(5)
    assert not th.is_alive()
    recs = tracing.last_session().records
    by = {r.name: (i, r) for i, r in enumerate(recs)}
    assert [r.name for r in recs] == ["t.step", "t.pull", "t.mark", "t.client", "t.wait", "t.submit", "t.copy",
                                      "t.loose"]
    assert by["t.client"][1].parent is None and by["t.client"][1].owner == ("request", 9)
    step, pull, mark, wait = (by[n][0] for n in ("t.step", "t.pull", "t.mark", "t.wait"))
    assert recs[step].parent is None and recs[pull].parent == step and recs[wait].parent == step
    assert recs[mark].parent == pull and recs[mark].thread != recs[pull].thread
    assert {recs[i].owner for i in (step, pull, mark, wait)} == {("step", 7)}
    assert by["t.copy"][1].parent == by["t.submit"][0]
    assert by["t.submit"][1].owner == by["t.copy"][1].owner == ("request", 3)
    assert by["t.loose"][1].owner is None and by["t.loose"][1].parent is None
    assert [r.name for r in recs if r.sync] == ["t.mark", "t.wait", "t.copy"]
    assert by["t.copy"][1].site == "there" and by["t.loose"][1].site is None
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert recs[step].start_ns <= recs[mark].start_ns and recs[mark].end_ns <= recs[step].end_ns


def test_threads_recording_at_once_lose_no_record_and_open_one_session():
    import sys

    threads, spans = 16, 100
    _off_site()
    start = threading.Barrier(threads)

    def work(k):
        start.wait(5)
        for i in range(spans):
            with tracing.span(f"x.outer{k}", owner=("request", k)):
                with tracing.span(f"x.inner{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profile():
            ths = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in ths)
    recs = tracing.last_session().records
    assert len(recs) == 2 * threads * spans
    for r in recs:
        k = int(r.name.rsplit("outer" if "outer" in r.name else "inner", 1)[1])
        assert r.owner == ("request", k) and r.end_ns is not None
        if "inner" in r.name:
            assert recs[r.parent].name == f"x.outer{k}" and recs[r.parent].thread == r.thread


def test_sessions_are_kept_apart_and_bounded():
    made = []
    for i in range(tracing.KEEP + 2):
        _off_site()
        with _profile():
            with tracing.span(f"s{i}"):
                pass
        made.append(tracing.last_session())
        assert [r.name for r in made[-1].records] == [f"s{i}"]
    assert len({id(s) for s in made}) == len(made)
    assert list(tracing._sessions) == made[-tracing.KEEP:]


def test_records_sit_on_the_chrome_trace_clock(tmp_path):
    _off_site()
    with _profile() as prof:
        with tracing.scope("c.outer", ("dispatch", 0)):
            for _ in range(3):
                with tracing.span("c.inner"):
                    torch.ones(64).sum()
            with tracing.sync("c.mark", "here"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    session = tracing.last_session()
    offset = session.trace_offset_us(events)
    assert offset is not None
    ann = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX)]
    clock = [e for e in ann if e["name"] == tracing.CLOCK]
    assert len(clock) == 1 and abs(clock[0]["ts"] - (session.clock_ns / 1e3 + offset)) < 50
    for name in ("c.outer", "c.inner", "c.mark"):
        evs = sorted((e for e in ann if e["name"] == tracing.PREFIX + name), key=lambda e: e["ts"])
        recs = [r for r in session.records if r.name == name]
        assert len(evs) == len(recs) > 0
        for e, r in zip(evs, recs):
            assert abs(r.start_ns / 1e3 + offset - e["ts"]) < 50
            assert abs(r.end_ns / 1e3 + offset - (e["ts"] + e["dur"])) < 50


def _tiny_step():
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_gan_step

    cfg = gan_zoo.tiny_dcgan("cuda_chained", "cuda_chained")
    gp = G.prepack_generator(G.generator_init(cfg, seed=0, device="cpu"), cfg)
    dp = G.prepack_discriminator(G.discriminator_init(cfg, seed=1, device="cpu"), cfg)
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((2, cfg.z_dim), generator=gen)
    real = torch.rand((2, cfg.img_hw, cfg.img_hw, cfg.img_ch), generator=gen) * 2 - 1
    return make_gan_step(cfg), (gp, dp, adamw_init(gp), adamw_init(dp), z, real)


def test_a_train_step_records_its_four_children_and_the_model_spans():
    step, args = _tiny_step()
    step(*args)  # step 0, unrecorded
    _off_site()
    with _profile():
        step(*args)
    recs = tracing.last_session().records
    assert [r.name for r in recs] == ["train.step", "train.forward", "model.generator", "model.discriminator",
                                      "model.discriminator", "train.g_pull", "train.d_pull", "train.adamw"]
    assert {r.owner for r in recs} == {("step", 1)}
    assert [r.parent for r in recs] == [None, 0, 1, 1, 1, 0, 0, 0]
    assert not any(r.sync for r in recs)  # the CPU's tensors never wait on a device


@pytest.mark.parametrize("sizes", [(3, 4, 2, 5, 1), (8, 1, 1)], ids=["two_dispatches", "full_pool"])
def test_a_serve_run_records_each_dispatch_with_its_owner(sizes):
    from repro_torch.serve.engine import GanServeEngine

    cfg = gan_zoo.tiny_dcgan("cuda_chained")
    eng = GanServeEngine(G.generator_init(cfg, seed=0, device="cpu"), cfg, batch=8, device="cpu")
    gen = torch.Generator().manual_seed(1)
    zs = [torch.randn((n, cfg.z_dim), generator=gen) for n in sizes]
    _off_site()
    with _profile():
        eng.run(zs)
    recs = tracing.last_session().records
    submits = [r for r in recs if r.name == "serve.submit"]
    assert [r.owner for r in submits] == [("request", rid) for rid in range(len(sizes))]
    assert all(r.parent is None for r in submits)
    for i, rids in enumerate(eng.dispatch_log):
        (d,) = [j for j, r in enumerate(recs) if r.name == "serve.dispatch" and r.owner == ("dispatch", i)]
        (g,) = [r for r in recs if r.name == "serve.generate" and r.owner == ("dispatch", i)]
        assert recs[d].parent is None and g.parent == d
        assert recs[d].start_ns <= g.start_ns and g.end_ns <= recs[d].end_ns
        assert all(max(s.end_ns for s in submits if s.owner == ("request", rid)) <= recs[d].start_ns for rid in rids)
    assert sum(r.name == "serve.dispatch" for r in recs) == len(eng.dispatch_log) >= 1
    assert sum(r.name == "serve.generate" for r in recs) == len(eng.dispatch_log)
    assert not any(r.sync for r in recs)
