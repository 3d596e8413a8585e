"""The host's own work a train step, ms: the median over the profiled
steps of the ``train.step`` span's duration less the union of its sync
marks' intervals, on any thread (``repro_torch.tracing``).  Nothing where
the program has no tracer or recorded no step."""
from bench.yardstick.stats import percentile


def _covered_ns(intervals: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    session = tracing.last_session()
    if session is None:
        return None
    recs = session.closed()
    own = []
    for step in (r for r in recs if r.name == "train.step"):
        waits = [(max(r.start_ns, step.start_ns), min(r.end_ns, step.end_ns)) for r in recs
                 if r.sync and r.owner == step.owner and r.end_ns > step.start_ns and r.start_ns < step.end_ns]
        own.append((step.end_ns - step.start_ns - _covered_ns(waits)) / 1e6)
    return percentile(own, 50) if own else None
