"""The four readers of the port's own spans and sync marks
(``repro_torch.tracing``) against a session written by hand: counts over
steps and dispatches, the union of a step's waits (a mark on another
thread, overlapping and overhanging ones), consecutive dispatches' gaps;
nothing where the program has no tracer.  And the benchmark's reading of a
trace is the same with the program's annotations in it."""
from __future__ import annotations

import collections
import sys

import pytest

from bench import harness, profiling

MS = 1_000_000  # ns
MAIN, DEVICE = 1, 2  # thread idents


def _session(records):
    from repro_torch import tracing

    s = tracing.Session()
    for name, a, b, thread, owner, sync in records:
        s.records.append(tracing.Record(name, int(a * MS), None if b is None else int(b * MS), thread, None, owner,
                                        "x" if sync else None))
    return s


def _train():
    s0, s1 = ("step", 0), ("step", 1)
    return _session([
        ("train.step", 0, 10, MAIN, s0, False),
        ("ops.phase_perm", 1, 3, MAIN, s0, True),
        ("ops.phase_perm", 2, 4, DEVICE, s0, True),  # overlaps the one before, on autograd's thread
        ("ops.phase_perm", 9, 12, DEVICE, s0, True),  # overhangs the step's end
        ("train.forward", 0, 5, MAIN, s0, False),
        ("train.step", 20, 30, MAIN, s1, False),
        ("ops.phase_perm", 21, 22, MAIN, s1, True),
        ("ops.phase_perm", 23, 24, MAIN, s1, True),
        ("ops.phase_perm", 25, 26, MAIN, s1, True),
        ("ops.phase_perm", 27, 28, MAIN, s1, True),
        ("ops.phase_perm", 28, 29, MAIN, s1, True),
        ("serve.latents", 31, 32, MAIN, ("request", 0), True),  # no step's
        ("ops.phase_perm", 33, 34, MAIN, None, True),  # no step's
        ("ops.phase_perm", 35, None, MAIN, ("step", 2), True),  # still open
        ("train.step", 35, None, MAIN, ("step", 2), False),
    ])


def _serve():
    recs = []
    for rid in range(5):
        recs += [("serve.submit", rid, rid + 0.5, MAIN, ("request", rid), False),
                 ("serve.latents", rid + 0.1, rid + 0.2, MAIN, ("request", rid), True)]
    for i, (gen, end) in enumerate([(10, 15), (17, 22), (25, 30)]):
        d = ("dispatch", i)
        recs += [("serve.dispatch", gen - 1, end + 0.5, MAIN, d, False),
                 ("serve.generate", gen, gen + 2, MAIN, d, False), ("serve.sync", gen + 2, end, MAIN, d, True)]
    recs += [("serve.dispatch", 39, 41, MAIN, ("dispatch", 4), False),  # dispatch 3 unrecorded: no gap to 4
             ("serve.generate", 40, 40.5, MAIN, ("dispatch", 4), False),
             ("serve.sync", 40.5, 41, MAIN, ("dispatch", 4), True),
             ("ops.phase_perm", 42, 43, MAIN, ("step", 0), True)]  # no dispatch's
    return _session(recs)


@pytest.fixture
def session(monkeypatch):
    from repro_torch import tracing

    holder = []
    monkeypatch.setattr(tracing, "last_session", lambda: holder[0] if holder else None)
    return holder


def _read(name):
    return harness.reader(name)({})


def test_syncs_per_step_count_the_marks_each_closed_step_owns(session):
    session.append(_train())
    assert _read("host_syncs_per_step.train") == (3 + 5) / 2


def test_step_issue_time_leaves_out_the_union_of_its_waits(session):
    session.append(_train())
    # step 0: 10 ms less [1, 4] and [9, 10] (its mark clipped to the step) = 6; step 1: 10 less 5 x 1 ms = 5
    assert _read("step_issue_ms.train") == pytest.approx((6 + 5) / 2)


def test_syncs_per_dispatch_count_the_submits_and_dispatches_marks(session):
    session.append(_serve())
    assert _read("host_syncs_per_dispatch.serve") == (5 + 4) / 4


def test_generate_gap_runs_from_one_sync_to_the_next_generate(session):
    session.append(_serve())
    assert _read("generate_gap_ms_p50.serve") == pytest.approx((2 + 3) / 2)  # 15 -> 17, 22 -> 25


NAMES = ("host_syncs_per_step.train", "step_issue_ms.train", "host_syncs_per_dispatch.serve",
         "generate_gap_ms_p50.serve")


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_session_or_a_span_to_read(session, name):
    assert _read(name) is None
    session.append(_session([]))
    assert _read(name) is None
    session[0] = _serve() if name.endswith(".train") else _train()
    assert _read(name) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)  # as at a commit that has no tracer
    assert _read(name) is None


def test_every_new_metric_is_read_in_its_two_cells():
    sp = harness.spec()
    for cell, names in (("dcgan-train-b256", NAMES[:2]), ("artgan-train-b256", NAMES[:2]),
                        ("dcgan-serve-c64", NAMES[2:]), ("artgan-serve-c64", NAMES[2:])):
        read = {m["name"] for m in harness.layer_metrics(sp, cell)}
        assert set(names) <= read and not set(NAMES) - set(names) & read


Launch = collections.namedtuple("Launch", "kernel work")
K3 = "void (anonymous namespace)::fused_epi_mma_kernel<fwd::Core<2, 8, 2, 2, 9, 4, 1, 1> >(float const*)"


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_the_stretch_reads_the_same_with_the_programs_annotations():
    bench_only = [
        _x("bench.stretch", 1000.0, 1000.0, "user_annotation"),
        _x("bench.dispatch", 1000.0, 500.0, "user_annotation"),
        _x("bench.copy_out", 1500.0, 400.0, "user_annotation"),
        _x(K3, 1100.0, 200.0, "kernel"),
        _x("Memcpy DtoH (Device -> Pageable)", 1600.0, 50.0, "gpu_memcpy"),
        _x(K3, 1700.0, 100.0, "kernel"),
    ]
    program = [
        _x("repro_torch.clock", 1000.0, 0.0, "user_annotation"),
        _x("repro_torch.serve.dispatch", 1001.0, 500.0, "user_annotation"),
        _x("repro_torch.serve.generate", 1010.0, 80.0, "user_annotation"),
        _x("repro_torch.serve.sync", 1300.0, 1.0, "user_annotation"),  # opens where a gap begins
        _x("repro_torch.serve.submit", 1650.0, 40.0, "user_annotation"),
        _x("repro_torch.serve.generate", 1090.0, 300.0, "gpu_user_annotation"),
        _x("repro_torch.serve.sync", 1300.0, 300.0, "gpu_user_annotation"),  # over the device's idle time
    ]
    launches = [Launch("fused_engine", None)] * 2
    plain = profiling.read_events(bench_only, launches)
    mixed = profiling.read_events(bench_only[:3] + program + bench_only[3:], launches)
    assert plain.gaps and mixed == plain
    assert {name for _, name in mixed.gaps} == {"dispatch", "copy_out"}
    assert profiling.breakdown(mixed) == profiling.breakdown(plain)
