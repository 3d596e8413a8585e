"""A kernel family's share of its roofline over the profiled stretch:
the least time of every launch the port logged (``yardstick.work``, from
the configuration's layer shapes at the launch's batch) over the device
time of the family's kernel records.  Nothing where the trace holds fewer
records than the port logged launches, or a launch that is no layer of the
configuration."""
from __future__ import annotations

from bench.yardstick import work


def share(ctx: dict, families: tuple[str, ...]):
    st = ctx.get("stretch")
    if st is None or not all(st.whole(f) for f in families):
        return None
    peaks = work.peaks_for(ctx["device_name"])
    least = 0.0
    for launch in st.launches:
        if launch.kernel not in families:
            continue
        site = work.match(launch.kernel, launch.work or {},
                          work.launches(ctx["cfg"], (launch.work or {}).get("B"), training=ctx["training"]))
        if site is None:
            return None
        least += work.least_ms(work.work(site), peaks) / 1e3
    spent = sum(st.family_s.get(f, 0.0) for f in families)
    return 100.0 * least / spent if spent > 0 else None
