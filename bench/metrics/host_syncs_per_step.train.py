"""Host-device syncs a train step: the sync marks that the port's tracer
(``repro_torch.tracing``) recorded for the profiled steps, over the count
of ``train.step`` spans.  Nothing where the program has no tracer or
recorded no step."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    session = tracing.last_session()
    if session is None:
        return None
    recs = session.closed()
    steps = [r.owner for r in recs if r.name == "train.step"]
    if not steps:
        return None
    return sum(r.sync and r.owner in steps for r in recs) / len(steps)
