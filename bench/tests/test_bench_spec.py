"""``BENCHMARK.json`` against its contract: its keys, every name and unit,
and every cell resolving by name to its configuration, traffic mix,
driver, limits and per-layer readers."""
from __future__ import annotations

import json
import re

import pytest

from bench import correctness, harness, program

SP = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_bounds():
    assert set(SP) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SP["command"] == ["python3", "bench/run.py"] and SP["paths"] == ["bench"]
    assert isinstance(SP["run_seconds"], int) and 1 <= SP["run_seconds"] <= 51
    names = {m["name"] for m in SP["end_to_end"]}
    assert "setup_s" in names
    for m in SP["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SP["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(SP)) < 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SP[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in SP["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SP["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in SP[group]}) == len(SP[group])


@pytest.mark.parametrize("workload", [w["name"] for w in SP["workloads"]])
def test_every_cell_resolves_by_name(workload):
    wl, cfg, tr = harness.load_cell(SP, workload)
    assert cfg["name"] == wl["config"] and cfg["reduced"] == []
    assert harness.driver(tr["kind"]).run
    assert set(correctness.limits(workload)) <= {"loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
                                                 "change_gap", "change_gap_median", "update_gap", "image_gap"}
    reported = {m["name"] for m in harness.e2e_metrics(SP, workload)}
    assert "setup_s" in reported and len(reported) >= 2
    layers = harness.layer_metrics(SP, workload)
    assert layers
    for m in layers:
        assert m["moves"] in reported
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("conf", SP["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_the_ports_at_its_published_widths(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert cfg["source"] == conf["source"] and conf["file"].startswith("bench/")
    program.gan_config(cfg, deconv_impl="cuda_chained", conv_impl="cuda_chained")  # raises where they differ
    from repro_torch.models import gan as G
    from repro_torch.models import layers as L

    assert (cfg["disc_kernel"], cfg["disc_stride"]) == (G.DISC_KERNEL, G.DISC_STRIDE)
    assert cfg["leaky_slope"] == L.leaky_relu.__defaults__[0]
