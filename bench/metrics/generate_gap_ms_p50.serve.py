"""The time in which the engine has nothing queued on the card, ms: the
median over consecutive profiled dispatches of the time from one
dispatch's ``serve.sync`` end to the next dispatch's ``serve.generate``
start (``repro_torch.tracing``).  Nothing where the program has no tracer
or recorded no two consecutive dispatches."""
from bench.yardstick.stats import percentile


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    session = tracing.last_session()
    if session is None:
        return None
    generated, synced = {}, {}
    for r in session.closed():
        if r.owner is None or r.owner[0] != "dispatch":
            continue
        i = r.owner[1]
        if r.name == "serve.generate":
            generated[i] = min(generated.get(i, r.start_ns), r.start_ns)
        elif r.name == "serve.sync":
            synced[i] = max(synced.get(i, r.end_ns), r.end_ns)
    gaps = [(generated[i + 1] - end) / 1e6 for i, end in synced.items() if i + 1 in generated]
    return percentile(gaps, 50) if gaps else None
