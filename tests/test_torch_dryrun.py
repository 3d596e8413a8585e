"""The port's dry run (``launch/dryrun.py``) and ``launch/reanalyze.py``
on the CPU, as the reference's mini dry run
(``tests/test_parallel.py::test_mini_dryrun_through_real_machinery``)
shrinks its cell: llama3-8b at ``smoke_config``, train_4k cut to seq 32 and
batch 8, the production mesh swapped for a fake (4, 2) or (2, 2, 2) one.

* The cell traces through ``run_cell``: ``status == "ok"``, FLOPs > 0,
  ``wire_bytes_per_device`` present, and the op record saved.
* At world 1 in fp32 its f32 matmul FLOPs are within 2% of what the
  reference's ``hlo_costs`` reads off its own jitted step.  No gap to
  list: the two counts are equal (184549376 each on torch 2.13 / jax
  0.9.0), op by op the same matmuls forward, recomputed (remat) and
  backward.
* On (4, 2) a rank runs the world-1 matmul FLOPs / 8 plus its rows' share
  of the products that run whole on every model rank: the model axis
  splits the matmuls (tensor parallelism, ``launch/steps.py``), and at
  model extent 2 the smoke config splits every weight a product reads, so
  the share is 0.
* The same (4, 2) rank's f32 matmul FLOPs are within 5% of what the
  reference's ``hlo_costs`` reads off its own step compiled for 8 host
  devices (GSPMD's partition of the same specs), in a subprocess.
* ``reanalyze`` gives ``run_cell``'s totals back from the saved record.
* A host read on the step's path gives ``status: "error"``, not ``ok``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import configs as TCFG
from repro_torch.launch import dryrun as DR
from repro_torch.launch import reanalyze as RA
from repro_torch.launch import steps as TS

ARCH = "llama3-8b"
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


@pytest.fixture
def mini_cell(monkeypatch):
    """The shrunken cell in the port's registry (and the reference's, for the
    parity test)."""
    import repro.configs as RCFG
    from repro.configs.base import SHAPES as RSHAPES

    monkeypatch.setitem(TCFG.REGISTRY, ARCH, TCFG.smoke_config(ARCH))
    monkeypatch.setitem(TCFG.SHAPES, "train_4k", dataclasses.replace(TCFG.SHAPES["train_4k"], seq_len=32,
                                                                     global_batch=8))
    monkeypatch.setitem(RCFG.REGISTRY, ARCH, RCFG.smoke_config(ARCH))
    monkeypatch.setitem(RSHAPES, "train_4k", dataclasses.replace(RSHAPES["train_4k"], seq_len=32, global_batch=8))


def _matmul_flops(rec) -> float:
    c = rec["hlo_costs"]
    return c["f32_matmul_flops_per_device"] + c["bf16_matmul_flops_per_device"]


@pytest.mark.parametrize("mesh", ("4x2", "2x2x2"))
def test_mini_dryrun_through_real_machinery(mini_cell, tmp_path, mesh):
    rec = DR.run_cell(ARCH, "train_4k", mesh == "2x2x2", str(tmp_path), MESHES[mesh], device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 8 and rec["mesh"] == list(MESHES[mesh][0])
    assert rec["hlo_costs"]["flops_per_device"] > 0 and rec["hlo_costs"]["hbm_bytes_per_device"] > 0
    assert "wire_bytes_per_device" in rec["collectives"] and rec["collectives"]["wire_bytes_per_device"] > 0
    assert rec["memory"]["peak_live_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert os.path.exists(tmp_path / (DR.cell_name(ARCH, "train_4k", mesh == "2x2x2") + ".ops.jsonl.gz"))


def _reference_f32_matmul_flops() -> float:
    from repro.compat import make_mesh
    from repro.launch.hlo_costs import analyze_text
    from repro.launch.steps import build_step

    mesh = make_mesh((1, 1), ("data", "model"))
    fn, args, _ = build_step(ARCH, "train_4k", mesh)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32 if jnp.issubdtype(s.dtype, jnp.floating)
                                                      else s.dtype), args)
    with mesh:
        text = fn.lower(*f32).compile().as_text()
    return analyze_text(text, 1)["f32_matmul_flops_per_device"]


def _whole_on_every_model_rank(cfg, n: int) -> list:
    """The matmul weights (key paths) whose spec does not split over
    "model" at model extent ``n``: their products run whole on every
    model rank."""
    from _lm_pair import StandIn
    from repro_torch.parallel import sharding as TSH

    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif path[-1] in ("w", "table") and not any(p.startswith("conv_") for p in path) and "model" not in t:
            out.append("/".join(path))

    walk(TSH.lm_param_specs(cfg, StandIn((1, n), ("data", "model")))[0], ())
    return out


def test_world_one_fp32_matmul_flops_match_the_reference_and_the_model_axis_is_storage(mini_cell, tmp_path):
    one = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["1x1"], device="cpu", dtype=torch.float32)
    assert one["status"] == "ok", one.get("error")
    got, want = one["hlo_costs"]["f32_matmul_flops_per_device"], _reference_f32_matmul_flops()
    assert got > 0 and abs(got - want) <= 0.02 * want, (got, want)
    # per rank on (4, 2): the model axis splits the matmuls (no longer storage only): the world-1 figure / 8,
    # plus the rank's rows' share of the products on weights that stay whole, none here
    assert _whole_on_every_model_rank(TCFG.smoke_config(ARCH), 2) == []
    one_bf16 = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["1x1"], device="cpu")
    ranks = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["4x2"], device="cpu")
    assert _matmul_flops(one_bf16) == _matmul_flops(one) > 0
    assert _matmul_flops(ranks) == _matmul_flops(one_bf16) / 8


REFERENCE_4X2 = """
import dataclasses, json
import jax, jax.numpy as jnp
import repro.configs as RCFG
from repro.configs.base import SHAPES as RSHAPES
from repro.compat import make_mesh
from repro.launch.hlo_costs import analyze_text
from repro.launch.steps import build_step

RCFG.REGISTRY["llama3-8b"] = RCFG.smoke_config("llama3-8b")
RSHAPES["train_4k"] = dataclasses.replace(RSHAPES["train_4k"], seq_len=32, global_batch=8)
mesh = make_mesh((4, 2), ("data", "model"))
fn, args, _ = build_step("llama3-8b", "train_4k", mesh)
f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32 if jnp.issubdtype(s.dtype, jnp.floating)
                                                  else s.dtype), args)
with mesh:
    text = fn.lower(*f32).compile().as_text()
print(json.dumps(analyze_text(text, 8)["f32_matmul_flops_per_device"]))
"""


def test_4x2_rank_fp32_matmul_flops_match_the_references_gspmd_step(mini_cell, tmp_path):
    """One (4, 2) rank's f32 matmul FLOPs against the reference's step
    compiled for 8 forced host devices (its partitioned HLO read by
    ``hlo_costs.analyze_text``): within 5%."""
    import subprocess
    import sys

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_4X2], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    rank = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["4x2"], device="cpu", dtype=torch.float32)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    assert rank["status"] == "ok", rank.get("error")
    got, want = rank["hlo_costs"]["f32_matmul_flops_per_device"], float(out.strip().splitlines()[-1])
    assert got > 0 and abs(got - want) <= 0.05 * want, (got, want)


def test_reanalyze_reproduces_run_cell(mini_cell, tmp_path):
    rec = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["4x2"], device="cpu")
    path = tmp_path / (DR.cell_name(ARCH, "train_4k", False) + ".json")
    stale = dict(rec, hlo_costs={}, collectives={})
    path.write_text(json.dumps(stale))
    assert RA.reanalyze(str(tmp_path)) == [path.name]
    again = json.loads(path.read_text())
    assert again["hlo_costs"] == json.loads(json.dumps(rec["hlo_costs"]))
    assert again["collectives"] == json.loads(json.dumps(rec["collectives"]))


def test_a_host_read_on_the_path_is_an_error_not_ok(mini_cell, tmp_path, monkeypatch):
    """The train step's measurement mode reads the gradient norm on the
    host (``float(gn)``): on fake tensors that is an error with its reason."""
    monkeypatch.setattr(DR, "build_step", lambda arch, shape, mesh: TS.build_lm_step(
        TCFG.get_config(arch), TCFG.SHAPES[shape], mesh, readings=[]))
    rec = DR.run_cell(ARCH, "train_4k", False, str(tmp_path), MESHES["4x2"], device="cpu")
    assert rec["status"] == "error"
    assert "DataDependentOutputException" in rec["error"] and "hlo_costs" not in rec
    # main records it and fails, as the reference's sweep does for a failed compile
    monkeypatch.setattr(DR, "make_production_mesh", lambda multi_pod=False: MESHES["4x2"])
    with pytest.raises(SystemExit):
        DR.main(["--arch", ARCH, "--shape", "train_4k", "--out", str(tmp_path), "--force"])
    saved = json.loads((tmp_path / (DR.cell_name(ARCH, "train_4k", False) + ".json")).read_text())
    assert saved["status"] == "error" and "DataDependentOutputException" in saved["error"]


def test_fake_tensors_leave_the_real_constant_caches_alone(mini_cell, tmp_path):
    """A dry run's fake device constants are dropped with its trace: a real
    call after it builds (and caches) a real tensor."""
    from repro_torch.core import winograd_deconv as W

    W.clear_device_constants()
    rec = DR.run_cell("dcgan", "gan_train", False, str(tmp_path), MESHES["1x1"], device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    bt = W._bt_on(2, 3, torch.float32, "cpu")
    assert type(bt) is torch.Tensor and np.isfinite(bt.numpy()).all()
