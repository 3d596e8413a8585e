"""The frozen yardstick against the program's own counts: each engine
launch's work at every layer shape of the four cells equals
``repro_torch.kernels.costs``'s; the direct-FLOP counts equal what
``FlopCounterMode`` counts over the plain reference on meta tensors; the
percentile equals ``serve/metrics.py``'s."""
from __future__ import annotations

import random

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import harness, inputs
from bench.reference import gan as R
from bench.yardstick import flops, stats, work

CELLS = [w["name"] for w in harness.spec()["workloads"]]


def _port_work(site: dict):
    from repro_torch.core.tdc import ConvDims, DeconvDims
    from repro_torch.kernels import costs, ops

    geo, k = site["geo"], site["kernel"]
    kw = {key: site[key] for key in ("B", "ty", "tx", "N", "M")}
    if k.startswith("conv_"):
        _, inv, _ = ops.conv_packed_layout(ConvDims(geo.kernel, geo.stride, geo.padding, geo.pad_hi))
        kw.update(inv=inv, s2=geo.stride ** 2)
    else:
        _, sub, inv, _ = ops.packed_layout(DeconvDims(geo.kernel, geo.stride, geo.padding, geo.output_padding))
        kw.update(inv=inv, sub_slices=sub)
    for key in ("cells", "out", "vectors", "gy", "gx"):
        if key in site:
            kw[key] = site[key]
    return getattr(costs, k)(**kw)


@pytest.mark.parametrize("workload", CELLS)
def test_counts_equal_the_ports_at_every_layer_shape(workload):
    sp = harness.spec()
    wl, cfg, tr = harness.load_cell(sp, workload)
    training = tr["kind"] == "train_steps"
    batches = [tr["batch"]] if training else [b for b in (tr["pool_rows"], tr["pool_rows"] // 2)]
    for b in batches:
        sites = work.launches(cfg, b, training=training)
        assert len(sites) == 3 * (len(cfg["deconvs"]) + len(cfg["disc_channels"]))
        for site in sites:
            assert tuple(work.work(site)) == tuple(_port_work(site)), (site["layer"], site["kernel"])
            assert work.least_ms(work.work(site), work.peaks_for("NVIDIA H100 80GB HBM3")) > 0


def test_a_launch_matches_its_site_by_shape():
    _, cfg, _ = harness.load_cell(harness.spec(), "dcgan-train-b256")
    sites = work.launches(cfg, 256, training=True)
    s = sites[3]
    shape = {k: s[k] for k in ("B", "ty", "tx", "N", "M")}
    assert work.match(s["kernel"], shape, sites) is s
    assert work.match(s["kernel"], {**shape, "N": s["N"] + 1}, sites) is None


def _meta_params(cfg: dict) -> tuple[dict, dict]:
    g, d = inputs.param_shapes(cfg)
    return ({k: torch.zeros(shape, device="meta") for k, (shape, _) in g.items()},
            {k: torch.zeros(shape, device="meta") for k, (shape, _) in d.items()})


@pytest.mark.parametrize("name", ["dcgan", "artgan"])
def test_direct_flops_equal_the_flop_counter_over_the_reference(name):
    sp = harness.spec()
    conf = next(c for c in sp["configs"] if c["name"] == name)
    cfg = __import__("json").loads((harness.ROOT / conf["file"]).read_text())
    gp, dp = _meta_params(cfg)
    B = 4
    z = torch.zeros(B, cfg["z_dim"], device="meta")
    real = torch.zeros(B, cfg["img_hw"], cfg["img_hw"], cfg["img_ch"], device="meta")
    with FlopCounterMode(display=False) as fc:
        R.generator(gp, cfg, z, training=False, packed=False)
    assert fc.get_total_flops() == flops.generate_flops(cfg, B)
    with FlopCounterMode(display=False) as fc:
        R.train_step(gp, dp, R.adam_init(gp), R.adam_init(dp), z, real, cfg, lr=2e-4, b1=0.5, packed=False)
    assert fc.get_total_flops() == flops.train_step_flops(cfg, B)


def test_percentile_equals_the_ports():
    from repro_torch.serve.metrics import percentile

    rng = random.Random(5)
    for n in (1, 2, 7, 100):
        xs = [rng.random() for _ in range(n)]
        for p in (0, 50, 95, 99, 100):
            assert stats.percentile(xs, p) == percentile(xs, p)
    assert stats.percentile([1.0, 2.0, float("inf")], 95) == float("inf")
    assert stats.percentile([1.0, 2.0, float("inf")], 25) == 1.5
