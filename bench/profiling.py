"""The traced run's short, early stretch under ``torch.profiler``.

``torch.profiler`` has been seen to drop kernel records late in a long
process, so a traced run profiles only a short stretch near the start of
its window, and holds the kernel records of each engine family against the
launches the port's ``engine.launch_log`` logged over the same stretch: a
family whose records fall short gives no roofline share.

The stretch's host spans are the benchmark's own ``record_function``
annotations (``bench.step``, ``bench.dispatch``, ...), so each idle gap of
the device is labelled with the span that was open on the host when it
began.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

from . import program

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler while it
    records (and costing next to nothing while it does not)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Stretch:
    """What one profiled stretch saw (times in seconds)."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> device seconds
    family_s: dict = field(default_factory=dict)  # engine family -> device seconds
    family_records: dict = field(default_factory=dict)  # engine family -> kernel records
    launches: list = field(default_factory=list)  # the port's engine.Launch records
    gaps: list = field(default_factory=list)  # (seconds, host span open at its start)

    def family_launches(self) -> dict:
        out: dict = {}
        for launch in self.launches:
            out[launch.kernel] = out.get(launch.kernel, 0) + 1
        return out

    def whole(self, family: str) -> bool:
        """Whether the trace holds a kernel record for every launch of
        ``family`` the port logged (and at least one)."""
        n = self.family_launches().get(family, 0)
        return n > 0 and self.family_records.get(family, 0) >= n


@contextlib.contextmanager
def stretch(device: str, out: list):
    """Profile the body: appends its profiler session to ``out`` on exit,
    to be read by ``finish`` once the window has closed (exporting and
    reading a trace takes seconds).  The body is timed from a synchronised
    start to a synchronised end, and the port logs every engine launch
    meanwhile."""
    from repro_torch.kernels import engine

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    engine.launch_log = []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with span("stretch"):
                yield
                if cuda:
                    torch.cuda.synchronize()
    finally:
        launches, engine.launch_log = engine.launch_log, None
    out.append((prof, launches))


def finish(sessions: list) -> list:
    """Each ``stretch`` session read into a ``Stretch``."""
    out = []
    for prof, launches in sessions:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        out.append(read_events(events, launches))
    return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read_events(events: list[dict], launches: list) -> Stretch:
    """A ``Stretch`` from a chrome trace's events (microseconds): the device
    operations inside the ``bench.stretch`` span, their busy union, and the
    gaps between them."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    win = [e for e in xs if e.get("name") == SPAN_PREFIX + "stretch" and e.get("cat") == "user_annotation"]
    if not win:
        return Stretch(launches=launches)
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and t0 <= float(e["ts"]) <= t1]
    st = Stretch(window_s=(t1 - t0) / 1e6, launches=launches)
    for e in dev:
        d = float(e["dur"]) / 1e6
        st.kernels[e["name"]] = st.kernels.get(e["name"], 0.0) + d
        fam = program.family_of(e["name"]) if e.get("cat") == "kernel" else None
        if fam:
            st.family_s[fam] = st.family_s.get(fam, 0.0) + d
            st.family_records[fam] = st.family_records.get(fam, 0) + 1
    busy = _union([(float(e["ts"]), min(t1, float(e["ts"]) + float(e["dur"]))) for e in dev])
    st.busy_s = sum(b - a for a, b in busy) / 1e6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(SPAN_PREFIX):]) for e in xs
                   if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)
                   and e["name"] != SPAN_PREFIX + "stretch")
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            st.gaps.append(((b - a) / 1e6, _open_span(spans, a)))
    return st


def _open_span(spans, t: float) -> str:
    """The innermost benchmark span open at host time ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best else "outside any span"


def breakdown(st: Stretch) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, and the ten longest idle gaps by the host span open when
    they began (seconds, as measured)."""
    ops = sorted(st.kernels.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(st.gaps, key=lambda g: -g[0])[:10]
    return {"device_ops": [[_short(k), v] for k, v in ops], "idle_gaps": [[name, s] for s, name in gaps]}


def _short(name: str) -> str:
    name = name.replace("void (anonymous namespace)::", "")
    return name if len(name) <= 120 else name[:117] + "..."
