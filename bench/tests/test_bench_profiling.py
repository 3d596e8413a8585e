"""The traced stretch's reading of a chrome trace: the device's busy
union, idle gaps labelled by the benchmark's open host span, kernel
records per engine family against the launches the port logged, and the
roofline share given only where the records are whole."""
from __future__ import annotations

import collections

from bench import harness, profiling

Launch = collections.namedtuple("Launch", "kernel work")
K3 = "void (anonymous namespace)::fused_epi_mma_kernel<fwd::Core<2, 8, 2, 2, 9, 4, 1, 1> >(float const*)"
CONV6 = "void (anonymous namespace)::conv_bwd_x_kernel(float const*)"


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _events():
    return [
        _x("bench.stretch", 1000.0, 1000.0, "user_annotation"),
        _x("bench.dispatch", 1000.0, 500.0, "user_annotation"),
        _x("bench.copy_out", 1500.0, 400.0, "user_annotation"),
        _x(K3, 1100.0, 200.0, "kernel"),
        _x(K3, 1250.0, 100.0, "kernel"),  # overlaps the first: the union counts 250 us
        _x("Memcpy DtoH (Device -> Pageable)", 1600.0, 50.0, "gpu_memcpy"),
        _x(CONV6, 1700.0, 100.0, "kernel"),
        _x(K3, 5000.0, 100.0, "kernel"),  # after the stretch
    ]


def test_busy_union_gaps_and_families():
    st = profiling.read_events(_events(), [Launch("fused_engine", None)] * 2)
    assert abs(st.window_s - 1e-3) < 1e-12
    assert abs(st.busy_s - 400e-6) < 1e-12
    assert st.family_records == {"fused_engine": 2, "conv_fused_engine_bwd_x": 1}
    assert abs(st.family_s["fused_engine"] - 300e-6) < 1e-12
    gaps = sorted(st.gaps, reverse=True)
    assert abs(gaps[0][0] - 250e-6) < 1e-12 and gaps[0][1] == "dispatch"
    assert abs(gaps[1][0] - 200e-6) < 1e-12 and gaps[1][1] == "copy_out"
    assert {name for _, name in st.gaps} == {"dispatch", "copy_out"}
    assert st.whole("fused_engine") and not st.whole("fused_engine_bwd_x")
    bd = profiling.breakdown(st)
    assert bd["device_ops"][0][0].startswith("fused_epi_mma_kernel") and len(bd["idle_gaps"]) <= 10


def test_family_names_match_whole_kernel_names():
    from bench import program

    assert program.family_of(CONV6) == "conv_fused_engine_bwd_x"
    assert program.family_of("void (anonymous namespace)::bwd_x_kernel(float const*)") == "fused_engine_bwd_x"
    assert program.family_of("void at::native::elementwise_kernel<128, 2>()") is None


def test_the_roofline_share_needs_whole_records():
    import json

    _, cfg, tr = harness.load_cell(harness.spec(), "dcgan-serve-c64")
    read = harness.reader("deconv_engine_roofline.serve")
    b = 128
    from bench.yardstick import work

    sites = [s for s in work.launches(cfg, b, training=False) if s["kernel"] == "fused_engine"]
    launches = [Launch("fused_engine", {k: s[k] for k in ("B", "ty", "tx", "N", "M")}) for s in sites]
    events = [_x("bench.stretch", 0.0, 1e5, "user_annotation")] + [_x(K3, 10.0 + i, 1e3, "kernel")
                                                                    for i in range(len(sites))]
    ctx = {"cfg": cfg, "training": False, "device_name": "NVIDIA H100 80GB HBM3",
           "stretch": profiling.read_events(events, launches)}
    share = read(ctx)
    least = sum(work.least_ms(work.work(s), work.peaks_for("SXM")) for s in sites)
    assert abs(share - 100 * least / (len(sites) * 1.0)) < 1e-9
    ctx["stretch"] = profiling.read_events(events[:-1], launches)  # a record lost
    assert read(ctx) is None
    assert json.dumps(share)
