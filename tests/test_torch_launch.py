"""The port's ``launch/steps.py``, ``launch/train.py`` and
``examples/torch_train_lm.py`` on the CPU.

* ``build_step`` dispatches each cell: an LM's train / prefill / decode
  step (sequence-sharded exactly at ``long_500k``) and a GAN's train step;
  its arg structs are meta tensors with the shapes and dtypes of the
  reference's ``ShapeDtypeStruct``s (``PARAM_DTYPE`` bf16), on a (1, 1)
  mesh against JAX's on a (1, 1) mesh (``lm_input_specs`` for an LM: the
  reference's ``build_step`` cannot place a ``long_500k`` cache on that
  mesh, whose batch axis and sequence axis are both "data";
  ``build_gan_step`` for a GAN).
* ``build_gan_step`` on world 2 is the step it maps to: one step from the
  same blocks gives the same bits as ``build_gan_mesh_step`` (default),
  ``build_gan_comm_step`` (``overlap``) and its int8 form (whose structs
  carry a ``CommState``).
* ``python -m repro_torch.launch.train --arch llama3-8b --smoke`` runs 2
  steps with a checkpoint a step, resumes from step 2 to step 3, and its
  step-3 checkpoint holds the bits of an unbroken 3-step run's.
* ``examples/torch_train_lm.py`` runs 2 steps."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import _parallel_ref as REF
import _torch_dist as TDist
from repro.compat import make_mesh as jmake_mesh
from repro.configs import SHAPES, get_config
from repro.launch.steps import build_gan_step as jbuild_gan_step
from repro.launch.steps import lm_input_specs as jlm_input_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("llama3-8b", "train_4k"), ("qwen2-vl-2b", "train_4k"), ("mamba2-780m", "prefill_32k"),
         ("mixtral-8x22b", "decode_32k"), ("gemma3-12b", "long_500k"), ("jamba-v0.1-52b", "long_500k"),
         ("dcgan", "train_4k"))
NAMES = {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}


def _jax_structs(x):
    if isinstance(x, dict):
        return {k: _jax_structs(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_jax_structs(v) for v in x)
    return tuple(x.shape), str(x.dtype)


def _same_structs(port, ref, path=""):
    if isinstance(port, int):  # AdamW's step count: a Python int in the port, a 0-d int32 struct in JAX
        assert ref == ((), "int32"), path
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _same_structs(port[k], ref[k], f"{path}.{k}")
        return
    if len(ref) == 2 and isinstance(ref[1], str):  # a leaf: (shape, dtype name)
        assert tuple(port) == tuple(ref), path
        return
    assert len(port) == len(ref), path
    for i, (a, b) in enumerate(zip(port, ref)):
        _same_structs(a, b, f"{path}[{i}]")


def _run(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _done(proc, timeout=240) -> str:
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:]
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    smoke = ["-m", "repro_torch.launch.train", "--arch", "llama3-8b", "--smoke", "--device", "cpu",
             "--ckpt-every", "1"]
    broken = _run(*smoke, "--steps", "2", "--ckpt-dir", str(tmp / "resumed"))
    whole = _run(*smoke, "--steps", "3", "--ckpt-dir", str(tmp / "whole"))
    example = _run("examples/torch_train_lm.py", "--steps", "2", "--device", "cpu")
    structs = TDist.spawn_ranks(TDist.launch_structs, 1, tmp, CELLS)
    jcfg, gp, dp = REF.start(("ref",))
    z, real = REF.batches(jcfg, 4, steps=1)[0]
    gan = TDist.spawn_ranks(TDist.gan_step_dispatch, 2, tmp, ("ref",), gp, dp, z, real)
    out = dict(first=_done(broken))
    out["resume"] = _done(_run(*smoke, "--steps", "3", "--ckpt-dir", str(tmp / "resumed")))
    out["whole"], out["example"] = _done(whole), _done(example)
    out["structs"], out["gan"] = TDist.collect(structs)[0], TDist.collect(gan)
    out["manifests"] = {run: json.load(open(tmp / run / "step_000000000003" / "manifest.json"))
                        for run in ("resumed", "whole")}
    return out


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_build_step_dispatches_and_its_structs_are_the_reference(launched, cell):
    mesh = jmake_mesh((1, 1), ("data", "model"))
    got = launched["structs"][cell]
    if cell[0] == "dcgan":
        _, jargs, jmeta = jbuild_gan_step(get_config(cell[0]), mesh)
        assert got["name"] == "step"
    else:
        jargs, _, _, jmeta = jlm_input_specs(get_config(cell[0]), SHAPES[cell[1]], mesh)
        assert got["name"] == NAMES[SHAPES[cell[1]].mode]
    _same_structs(got["args"], _jax_structs(jargs))
    assert got["seq_shard"] == jmeta.get("seq_shard")
    assert (cell[1] == "long_500k") == bool(got["seq_shard"])


@pytest.mark.parametrize("variant", ("mesh", "overlap", "int8"))
def test_build_gan_step_is_the_step_it_maps_to(launched, variant):
    for r in launched["gan"]:
        assert r[variant]["same"]
        assert r[variant]["n_args"] == (7 if variant == "int8" else 6)
    assert launched["gan"][0]["int8"]["comm"] == "CommState"


def test_launcher_smoke_resumes_to_the_bits_of_an_unbroken_run(launched):
    assert "step 1:" in launched["first"] and "step 2:" not in launched["first"]
    assert "resumed from step 2" in launched["resume"] and "step 2:" in launched["resume"]
    assert "step 0:" not in launched["resume"]
    shas = {run: [(leaf["key"], leaf["sha256"]) for leaf in m["leaves"]] for run, m in launched["manifests"].items()}
    assert len(shas["whole"]) > 10 and shas["resumed"] == shas["whole"]
    last = lambda out: [ln for ln in out.splitlines() if ln.startswith("step 2:")][0].split("(")[0]  # noqa: E731
    assert last(launched["resume"]) == last(launched["whole"])


def test_example_trains_two_steps(launched):
    lines = launched["example"].splitlines()
    assert lines[-1] == "done" and any(ln.strip().startswith("step    2  loss") for ln in lines)
    loss = float(next(ln for ln in lines if ln.strip().startswith("step    2")).split()[3])
    assert np.isfinite(loss)
