"""Images served over the rows the engine dispatched (each dispatch's
bucket), %, from the engine's ``served`` and ``bucket_counts`` over the
window's unprofiled part."""


def read(ctx):
    rows = ctx["rows_dispatched"]
    return 100.0 * ctx["images_dispatched"] / rows if rows else None
