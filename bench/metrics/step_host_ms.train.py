"""The host's cost to enqueue one train step, ms: the median of a few step
calls, each started on an idle queue and not waited for."""


def read(ctx):
    return ctx.get("step_host_ms")
