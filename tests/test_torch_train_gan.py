"""The port's ``train_gan`` loop: a clean run against the reference's, and
the loop's own contract on the CPU.

Clean run: ``tiny_dcgan("chained_ref", "chained_ref")`` through JAX's
``train_gan`` and ``tiny_dcgan("cuda_chained", "cuda_chained")`` through the
port's (both nets on the kernels' plain versions), 3 steps from one step-0
checkpoint that JAX's ``save_checkpoint`` wrote from JAX's init, the port's
batches JAX's (its ``latent_batch`` / ``gan_batch`` patched; nothing of the
reference is).  Metrics within 1e-3 relative every step, parameters within
6·lr and batchnorm running statistics within 1e-3 after 3 steps (the train
step tests' tolerances); the port resumes JAX's step-2 checkpoint
directory and lands on JAX's step 3.

The port alone (``tiny_dcgan()``, ref / lax, batch 2): preemption then
resume, programmatic and by SIGTERM, bit-exact against an uninterrupted
run; replayed log boundaries replace, never double-append; a fault before
the first checkpoint restarts from init; the sentinel off reads the same
metrics at log boundaries; the reference's legacy kwargs; no card, no run.
"""
import dataclasses
import json
import os
import shutil
import signal
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import gan_zoo as jzoo
from repro.train import trainer as JT
from repro_torch import data as TD
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.train import checkpoint as TC
from repro_torch.train import resilience as TR
from repro_torch.train import trainer as TT
from test_torch_train_resilience import _kw, jax_batches, jax_start

LR, B, STEPS, SEED = 2e-4, 4, 3, 0


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    root = tmp_path_factory.mktemp("clean")
    jcfg = jzoo.tiny_dcgan("chained_ref", "chained_ref")
    tcfg = tzoo.tiny_dcgan("cuda_chained", "cuda_chained")
    jax_start(root / "start", jcfg, SEED)
    for name in ("jax", "port"):
        shutil.copytree(root / "start", root / name)
    kw = dict(steps=STEPS, batch=B, seed=SEED, ckpt_every=2, log_every=1, handle_signals=False)
    jout = JT.train_gan(jcfg, ckpt_dir=str(root / "jax"), settings=JT.StepSettings(lr=LR, b1=0.5), **kw)
    shutil.copytree(root / "jax", root / "resume")  # JAX's checkpoints of steps 0 and 2
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in jax_batches().items():
            mp.setattr(TD, name, fn)
        tout = TT.train_gan(tcfg, ckpt_dir=str(root / "port"), settings=TT.StepSettings(lr=LR, b1=0.5),
                            device="cpu", **kw)
        resumed = TT.train_gan(tcfg, ckpt_dir=str(root / "resume"), settings=TT.StepSettings(lr=LR, b1=0.5),
                               device="cpu", **kw)
    return dict(jax=jout, port=tout, resumed=resumed, root=root)


def _close_metrics(port, ref):
    assert [e["step"] for e in port] == [e["step"] for e in ref]
    for a, b in zip(port, ref):
        for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-3 * abs(b[k]), (a["step"], k, a[k], b[k])
        assert a["nonfinite"] == b["nonfinite"] == 0.0


def test_clean_run_metrics_match_the_reference(clean):
    assert [e["step"] for e in clean["port"]["metrics"]] == [1, 2, 3]
    _close_metrics(clean["port"]["metrics"], clean["jax"]["metrics"])
    assert (clean["port"]["final_step"], clean["port"]["preempted"]) == (STEPS, False)
    assert clean["port"]["counters"] == clean["jax"]["counters"]


def test_clean_run_params_match_the_reference(clean):
    flat_j, _ = jax.tree_util.tree_flatten_with_path(clean["jax"]["params"])
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat_j}
    got = dict(TC._flatten(clean["port"]["params"]))
    assert set(got) == set(want)
    for key, t in got.items():
        tol = 1e-3 if key.endswith(("['mean']", "['var']")) else 6 * LR
        assert np.abs(t.numpy() - want[key]).max() <= tol, key


def test_clean_run_checkpoints_read_as_the_references(clean):
    """The port's step-2 checkpoint has the reference's manifest keys,
    shapes and dtypes (the values differ by fp32 noise, so the sha256 do),
    and the loop-state sidecar the same keys."""
    def manifest(name):
        path = os.path.join(str(clean["root"] / name), "step_000000000002")
        with open(os.path.join(path, TC.MANIFEST)) as f:
            m = json.load(f)
        return [(r["key"], r["file"], r["shape"], r["dtype"]) for r in m["leaves"]], set(
            TC.load_loop_state(str(clean["root"] / name), 2))

    assert manifest("port") == manifest("jax")


def test_port_resumes_a_jax_checkpoint_directory(clean):
    """Resumed from JAX's step-2 checkpoint: JAX's history of steps 1-2 as
    JAX wrote it, then the port's step 3 within tolerance of JAX's."""
    hist = clean["resumed"]["metrics"]
    assert hist[:2] == clean["jax"]["metrics"][:2]
    _close_metrics(hist, clean["jax"]["metrics"])


# ------------------------------------------------------------ the loop's own contract
@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return TT.train_gan(tzoo.tiny_dcgan(), **_kw(tmp_path_factory.mktemp("u"), "clean"))


def test_programmatic_preempt_then_resume_is_bit_exact(tmp_path, uninterrupted):
    cfg = tzoo.tiny_dcgan()
    plan = TR.TrainFaultPlan(kind="preempt", at_step=5, max_faults=1)
    pre = TT.train_gan(cfg, fault_plan=plan, **_kw(tmp_path, "pre"))
    # honored at the next step boundary: step 5 finishes, the final checkpoint lands at 6
    assert pre["preempted"] is True and pre["final_step"] == 6
    assert [e["step"] for e in pre["metrics"]] == [1, 2, 3, 4, 5, 6]
    assert TC.available_steps(str(tmp_path / "pre")) == [4, 6]
    res = TT.train_gan(cfg, **_kw(tmp_path, "pre"))
    assert res["preempted"] is False and res["final_step"] == 8
    assert res["metrics"] == uninterrupted["metrics"]  # bit-exact, the whole history
    for a, b in zip(TC._flatten(res["params"]), TC._flatten(uninterrupted["params"])):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


def test_sigterm_preempt_then_resume_is_bit_exact(tmp_path, uninterrupted):
    cfg = tzoo.tiny_dcgan()
    prev = signal.getsignal(signal.SIGTERM)

    def kill_at_5(step, m):
        if step == 5:
            signal.raise_signal(signal.SIGTERM)

    pre = TT.train_gan(cfg, hooks=TT.TrainHooks(on_step=kill_at_5), **_kw(tmp_path, "pre", handle_signals=True))
    assert pre["preempted"] is True and pre["final_step"] == 5
    assert signal.getsignal(signal.SIGTERM) is prev  # the guard put the handler back
    res = TT.train_gan(cfg, **_kw(tmp_path, "pre"))
    assert res["final_step"] == 8 and res["metrics"] == uninterrupted["metrics"]


def test_metrics_dedupe_across_replay(tmp_path):
    """A fault at 6 restores step 4 and replays 5-6: their log entries are
    replaced, not appended twice."""
    out = TT.train_gan(tzoo.tiny_dcgan(), hooks=TT.TrainHooks(inject_fault_at=6), **_kw(tmp_path, "dedupe"))
    assert [e["step"] for e in out["metrics"]] == list(range(1, 9))
    assert out["counters"]["restores"] == 1 and out["fault_log"][0]["error"] == "RuntimeError: injected fault at step 6"


def test_metrics_reset_on_restart_from_init(tmp_path):
    """A fault before the first checkpoint restarts from init (a pure
    function of the seed): the pre-fault metrics go, and the replay matches
    a clean run exactly."""
    cfg = tzoo.tiny_dcgan()
    kw = dict(steps=4, ckpt_every=10)
    clean_run = TT.train_gan(cfg, **_kw(tmp_path, "clean", **kw))
    faulty = TT.train_gan(cfg, hooks=TT.TrainHooks(inject_fault_at=2), **_kw(tmp_path, "faulty", **kw))
    assert [e["step"] for e in faulty["metrics"]] == [1, 2, 3, 4]
    assert faulty["metrics"] == clean_run["metrics"]


def test_trainer_resumes_past_a_corrupt_latest(tmp_path, uninterrupted):
    """The latest checkpoint truncated on disk: the relaunch and a later
    fault restore both walk back to the next-older one, and the run lands on
    the uninterrupted run's metrics."""
    cfg = tzoo.tiny_dcgan()
    TT.train_gan(cfg, **_kw(tmp_path, "faulty", steps=4, ckpt_every=2))
    assert TC.available_steps(str(tmp_path / "faulty")) == [2, 4]
    assert TR.corrupt_latest_checkpoint(str(tmp_path / "faulty")) == 4
    with pytest.warns(RuntimeWarning, match="failed integrity"):
        out = TT.train_gan(cfg, hooks=TT.TrainHooks(inject_fault_at=5), **_kw(tmp_path, "faulty", ckpt_every=10))
    assert out["final_step"] == 8 and out["counters"]["ckpt_fallbacks"] == 2
    assert out["metrics"][-1] == uninterrupted["metrics"][-1]


def test_sentinel_off_reads_the_same_metrics_at_log_boundaries(tmp_path, uninterrupted):
    out = TT.train_gan(tzoo.tiny_dcgan(), policy=TR.FaultPolicy(sentinel=False), **_kw(tmp_path, log_every=4))
    assert out["metrics"] == [e for e in uninterrupted["metrics"] if e["step"] in (4, 8)]


def test_host_metrics_read_as_float_per_key():
    m = {"g_loss": torch.tensor(0.1, dtype=torch.float32), "nonfinite": torch.tensor(0.0),
         "d_grad_norm": torch.tensor(float("inf"))}
    assert TT._host_metrics(m) == {k: float(v) for k, v in m.items()}
    assert list(TT._host_metrics(m)) == list(m)


def test_legacy_kwargs_warn_and_multi_device_ones_raise():
    cfg = tzoo.tiny_dcgan()
    with pytest.warns(DeprecationWarning, match="deprecated"):
        step = TT.make_gan_step(cfg, 1e-3, 0.9, donate=False)
    assert callable(step)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="needs mesh and batch"):
        TT.make_gan_step(cfg, mesh=object())  # the mesh step needs the global batch
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="require mesh"):
        TT.train_gan(cfg, steps=1, batch=2, device="cpu", overlap=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # settings= alone: no warning
        TT.make_gan_step(cfg, settings=TT.StepSettings(lr=1e-3, batch=8, donate=False))
    st = TT._merge_legacy(TT.StepSettings(lr=1.0), {"lr": TT._UNSET, "b1": 0.25}, "here")
    assert (st.lr, st.b1, st.comm) == (1.0, 0.25, False)
    assert dataclasses.replace(st, batch=4).batch == 4


def test_legacy_impl_kwargs_pick_the_impl(tmp_path):
    with pytest.warns(DeprecationWarning, match="deconv_impl"):
        out = TT.train_gan(tzoo.tiny_dcgan(), deconv_impl="prepacked_ref", **_kw(tmp_path, steps=1))
    assert "ww" in out["params"]["gp"]["deconv0"]  # packed: the prepacked impl ran


def test_no_card_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train_gan(tzoo.tiny_dcgan(), steps=1, batch=2)
