"""SLO accounting per request on the GAN serve path, as the reference's.

Every ``GanRequest`` carries four monotonic-clock stamps (ms):

  t_submit   the caller handed the request to ``submit``
  t_admit    the request claimed slot rows in the engine's shared pool
  t_dispatch the shared batch holding it was handed to the generate
  t_done     its rows came back from the device (on CUDA after the
             generating thread's stream was synchronized)

from which the four SLO components derive:

  queue_wait = t_admit    - t_submit   (backpressure: time pending)
  batch_wait = t_dispatch - t_admit    (coalescing: time in the window)
  compute    = t_done     - t_dispatch (the bucketed generate)
  e2e        = t_done     - t_submit   (what the caller waits)

``summarize`` aggregates completed requests into rows per arch:
throughput (requests and images per second over the observed span) and
p50 / p95 / p99 end-to-end latency.
"""
from __future__ import annotations

from typing import Iterable, Optional

__all__ = ["percentile", "request_timing", "summarize"]


def percentile(xs: list[float], p: float) -> float:
    """Linearly interpolated percentile (p in [0, 100]) of a non-empty list."""
    if not xs:
        raise ValueError("percentile of empty list")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return s[lo] * (1 - frac) + s[hi] * frac


def request_timing(req) -> Optional[dict]:
    """The four SLO components of one completed request (ms), or None if a
    stamp is missing (rejected, or still in flight)."""
    ts = (req.t_submit, req.t_admit, req.t_dispatch, req.t_done)
    if any(t is None for t in ts):
        return None
    t_submit, t_admit, t_dispatch, t_done = ts
    return {
        "queue_wait_ms": t_admit - t_submit,
        "batch_wait_ms": t_dispatch - t_admit,
        "compute_ms": t_done - t_dispatch,
        "e2e_ms": t_done - t_submit,
    }


def _row(reqs: list, span_s: float) -> dict:
    timings = [t for t in (request_timing(r) for r in reqs) if t is not None]
    e2e = [t["e2e_ms"] for t in timings]
    n_img = sum(r.size for r in reqs)
    row = {
        "requests": len(reqs),
        "images": n_img,
        "span_s": span_s,
        "throughput_rps": len(reqs) / span_s if span_s > 0 else None,
        "images_per_s": n_img / span_s if span_s > 0 else None,
    }
    if e2e:
        row.update(
            p50_ms=percentile(e2e, 50),
            p95_ms=percentile(e2e, 95),
            p99_ms=percentile(e2e, 99),
            mean_queue_wait_ms=sum(t["queue_wait_ms"] for t in timings) / len(timings),
            mean_batch_wait_ms=sum(t["batch_wait_ms"] for t in timings) / len(timings),
            mean_compute_ms=sum(t["compute_ms"] for t in timings) / len(timings),
        )
    return row


def summarize(requests: Iterable, *, span_s: Optional[float] = None, counters: Optional[dict] = None) -> dict:
    """Aggregate completed requests into {"_all": row, <arch>: row, ...}.

    ``span_s`` is the wall-clock span the throughput figures are normalized
    by; when omitted it is (max t_done - min t_submit) over the completed
    requests.  Rejected and failed requests are counted (per arch, under
    "rejected" / "failed") but left out of the latency figures: a failed
    request carries a ``GanServeError`` and delivered no images.

    ``counters`` merges serve-health counters per arch into the rows: pass
    ``GanServeEngine.health()`` or ``AsyncGanServer.health()["archs"]``;
    numeric values also sum into ``_all``, and a ``counters["_server"]``
    entry (e.g. watchdog restarts) merges into ``_all`` directly."""
    requests = list(requests)
    done = [r for r in requests if r.done and not getattr(r, "rejected", False)]
    rejected = [r for r in requests if getattr(r, "rejected", False)]
    failed = [r for r in requests
              if getattr(r, "failed", False) and not r.done and not getattr(r, "rejected", False)]
    if span_s is None:
        stamps = [(r.t_submit, r.t_done) for r in done if r.t_submit is not None and r.t_done is not None]
        span_s = (max(t1 for _, t1 in stamps) - min(t0 for t0, _ in stamps)) / 1e3 if stamps else 0.0
    out = {"_all": _row(done, span_s)}
    out["_all"]["rejected"] = len(rejected)
    out["_all"]["failed"] = len(failed)
    archs = sorted({r.arch for r in done + failed + rejected if getattr(r, "arch", None) is not None})
    for arch in archs:
        row = _row([r for r in done if r.arch == arch], span_s)
        row["rejected"] = sum(1 for r in rejected if getattr(r, "arch", None) == arch)
        row["failed"] = sum(1 for r in failed if getattr(r, "arch", None) == arch)
        out[arch] = row
    if counters:
        totals: dict[str, float] = {}
        for arch, ctr in counters.items():
            if arch == "_server":
                continue
            out.setdefault(arch, {}).update(ctr)
            for k, v in ctr.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    totals[k] = totals.get(k, 0) + v
        out["_all"].update(totals)
        out["_all"].update(counters.get("_server", {}))
    return out
