"""Host-device syncs a serve dispatch: the sync marks that the port's
tracer (``repro_torch.tracing``) recorded in ``serve.submit`` and
``serve.dispatch`` spans over the profiled stretch, over the count of
dispatches.  Nothing where the program has no tracer or recorded no
dispatch."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    session = tracing.last_session()
    if session is None:
        return None
    recs = session.closed()
    dispatches = sum(r.name == "serve.dispatch" for r in recs)
    if not dispatches:
        return None
    return sum(r.sync and r.owner is not None and r.owner[0] in ("request", "dispatch") for r in recs) / dispatches
