"""Elastic restore and ``train_gan`` on a mesh, on the CPU (gloo ranks from
``_torch_dist``, every spawn under a deadline).

* Elastic restore: a leaf saved from its blocks on a (2, 2) mesh
  (``P("data", "model")``, rank 0 writing the gathered leaf) restores onto
  a (2,) mesh under another spec (``shardings=``: each rank its block) and
  onto one device, bit for bit (the reference's
  ``test_elastic_checkpoint_across_meshes``).
* ``train_gan(mesh=...)``: ``tiny_dcgan`` per layer on packed weights (the
  port's ``cuda_prepacked`` on CPU tensors; JAX's ``prepacked_ref``), batch
  8 on a world-2 mesh, 4 steps checkpointing every 2, resuming a step-0
  checkpoint that JAX wrote from JAX's init (so the run also restores a
  reference checkpoint onto the mesh); the port's batches JAX's.  With one
  injected raise at step 3 it restores step 2 and replays: its metrics,
  params, counters and fault log against JAX's single-device ``train_gan``
  through the same fault (metrics 1e-3 relative, parameters 6·lr), and
  bit for bit against the port's own clean mesh run.  The same with
  ``grad_compression="int8"``, whose residuals ride in the checkpoint: the
  faulted run equals the clean one bit for bit, and tracks JAX within the
  compression tolerances (losses 2e-2, parameters 5e-3)."""
import shutil

import numpy as np
import pytest
import torch

import _parallel_ref as REF
import _torch_dist as TDist
from repro.train import resilience as JR
from repro.train import trainer as JT
from repro_torch.train import checkpoint as TC

STEPS, B, SEED = 4, 8, 0
KW = dict(steps=STEPS, batch=B, seed=SEED, ckpt_every=2, log_every=1, handle_signals=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tgm")
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    save = TDist.spawn_ranks(TDist.elastic_save, 4, root, (2, 2), ("data", "model"), str(root / "elastic"), x,
                             ("data", "model"))
    jcfg, _, _ = REF.start(("prepacked_ref",))
    REF.save_start(root / "start", jcfg, SEED)
    for name in ("jax", "clean", "fault", "int8_clean", "int8_fault"):
        shutil.copytree(root / "start", root / name)
    data = REF.batches(jcfg, B, steps=STEPS, seed=SEED)
    todo = [(n, str(root / n), 3 if "fault" in n else None, "int8" if "int8" in n else None)
            for n in ("clean", "fault", "int8_clean", "int8_fault")]
    loop = TDist.spawn_ranks(TDist.train_gan_runs, 2, root, (2,), ("data",), ("cuda_prepacked",), data, todo,
                             lr=REF.LR, **KW)
    blocks4 = TDist.collect(save)
    restore = TDist.spawn_ranks(TDist.elastic_restore, 2, root, (2,), ("data",), str(root / "elastic"), (8, 8),
                                (None, "data"))
    jout = JT.train_gan(jcfg, ckpt_dir=str(root / "jax"), settings=JT.StepSettings(lr=REF.LR, b1=0.5),
                        fault_plan=JR.TrainFaultPlan(kind="raise", at_step=3, max_faults=1), **KW)
    return dict(x=x, root=root, blocks4=blocks4, restored=TDist.collect(restore), jax=jout, port=TDist.collect(loop))


def test_elastic_restore_across_meshes(runs):
    x = runs["x"]
    for rank, block in enumerate(runs["blocks4"]):
        d, m = divmod(rank, 2)
        np.testing.assert_array_equal(block, x[4 * d:4 * d + 4, 4 * m:4 * m + 4])
    for rank, (block, full, opt_m) in enumerate(runs["restored"]):
        np.testing.assert_array_equal(block, x[:, 4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(full, x)
        np.testing.assert_array_equal(opt_m, 2 * x)
    like = {"w": torch.empty((8, 8), device="meta"), "opt": {"m": torch.empty((8, 8), device="meta")}}
    one = TC.restore_checkpoint(str(runs["root"] / "elastic"), 3, like, device="cpu")  # one device
    np.testing.assert_array_equal(one["w"].numpy(), x)
    np.testing.assert_array_equal(one["opt"]["m"].numpy(), 2 * x)


def _same(a, b):
    assert a["metrics"] == b["metrics"]
    for net in ("gp", "dp"):
        for k, leaf in a[net].items():
            for kk, v in leaf.items():
                np.testing.assert_array_equal(v, b[net][k][kk], err_msg=f"{net}.{k}.{kk}")


@pytest.mark.parametrize("name", ("fault", "int8_fault"))
def test_faulted_mesh_run_replays_the_clean_one_bit_for_bit(runs, name):
    for rank in runs["port"]:
        r = rank[name]
        assert r["final_step"] == STEPS and [e["step"] for e in r["metrics"]] == [1, 2, 3, 4]
        assert r["counters"]["restores"] == 1 and r["counters"]["injected_handled"] == {"raise": 1}
        assert [(e["step"], e["action"]) for e in r["fault_log"]] == [(3, "restore")]
        _same(r, rank[name.replace("fault", "clean")])
    _same(runs["port"][0][name], runs["port"][1][name])  # the ranks agree


def test_mesh_run_matches_the_reference_through_the_fault(runs):
    j = runs["jax"]
    for rank in runs["port"]:
        r = rank["fault"]
        assert r["counters"] == j["counters"] and r["fault_log"] == j["fault_log"]
        REF.check_metrics([{k: v for k, v in e.items() if k != "step"} for e in r["metrics"]],
                          [{k: v for k, v in e.items() if k != "step"} for e in j["metrics"]])
        REF.check_params(r["gp"], j["params"]["gp"])
        REF.check_params(r["dp"], j["params"]["dp"])


def test_compressed_mesh_run_tracks_the_reference(runs):
    j = runs["jax"]
    for rank in runs["port"]:
        r = rank["int8_fault"]
        assert r["counters"] == j["counters"]
        for a, b in zip(r["metrics"], j["metrics"]):
            assert abs(a["g_loss"] - b["g_loss"]) < 2e-2 and abs(a["d_loss"] - b["d_loss"]) < 2e-2, (a, b)
        for net in ("gp", "dp"):
            for k, leaf in r[net].items():
                for kk, v in leaf.items():
                    np.testing.assert_allclose(v, np.asarray(j["params"][net][k][kk]), atol=5e-3, rtol=5e-3,
                                               err_msg=f"{net}.{k}.{kk}")
