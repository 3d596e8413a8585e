"""The device's idle share of the profiled stretch, %: 1 - the union of
its operations' intervals over the stretch."""


def idle(ctx):
    st = ctx.get("stretch")
    if st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
