"""The port's train resilience against the reference's ``train/resilience.py``
and ``train_gan``: the divergence detector's verdicts on scripted metric
sequences, ``TrainFaultPlan.draw`` sequences for one seed, ``FaultPolicy``
validation and backoff, ``PreemptionGuard``, ``nonfinite_flag`` and the
checkpoint-corruption helper; then ``chip_smoke.TRAIN_GAN_PLAN`` through
both packages' ``train_gan`` on an 8-channel DiscoGAN (``z_dim == 0``: the
image-to-image branch) with ``ref`` / ``lax`` on both sides.  Both start
from one step-0 checkpoint that JAX's ``save_checkpoint`` wrote from JAX's
init, the port's batches are JAX's (its ``latent_batch`` / ``gan_batch``
patched; nothing of the reference is), and the resumes cross over: JAX
resumes the port's checkpoint directory and the port JAX's.  The fault
accounting (counters, fault log, injected faults, final step, preempted) is
identical in both packages and equal to the smoke's ``TRAIN_GAN_EXPECTED``,
which the card's run is held to; the metrics agree within 1e-3 relative."""
import dataclasses
import math
import shutil
import signal
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro import data as JD
from repro.configs import gan_zoo as jzoo
from repro.models import gan as JG
from repro.optim import adamw_init as jadamw_init
from repro.train import checkpoint as JC
from repro.train import resilience as JR
from repro.train import trainer as JT
from repro_torch import data as TD
from repro_torch.configs import gan_zoo as tzoo
from repro_torch.train import checkpoint as TC
from repro_torch.train import resilience as TR
from repro_torch.train import trainer as TT

SEED, BATCH = 3, 2


# ------------------------------------------------------------ the detector
def _metric_sequence(seed: int, n: int = 60) -> list[dict]:
    """Healthy metrics with spikes (x1e2 .. x1e5), NaNs, infs and a raised
    flag sprinkled in, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = {"g_loss": float(0.7 + 0.1 * rng.standard_normal()), "d_loss": float(0.7 + 0.1 * rng.standard_normal()),
             "g_grad_norm": float(1 + rng.random()), "d_grad_norm": float(1 + rng.random()), "nonfinite": 0.0}
        u = rng.random()
        key = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")[int(rng.integers(4))]
        if u < 0.05:
            m[key] = float("nan")
            m["nonfinite"] = 1.0
        elif u < 0.08:
            m[key] = float("inf") * (1 if rng.random() < 0.5 else -1)
        elif u < 0.10:
            m["nonfinite"] = 1.0
        elif u < 0.20:
            m[key] *= float(10 ** rng.integers(2, 6))
        out.append(m)
    return out


@pytest.mark.parametrize("policy", [{}, dict(window=8, loss_factor=10.0, grad_factor=10.0),
                                    dict(loss_cap=2.0, window=4), dict(window=40, grad_factor=50.0)])
def test_detector_verdicts_match_the_reference(policy):
    for seed in range(4):
        seq = _metric_sequence(seed)
        dets = (JR.DivergenceDetector(JR.FaultPolicy(**policy)), TR.DivergenceDetector(TR.FaultPolicy(**policy)))
        verdicts = ([], [])
        for s, m in enumerate(seq):
            for det, out in zip(dets, verdicts):
                if s == 30:
                    det.reset()
                out.append(det.observe(s, dict(m)))
        assert verdicts[1] == verdicts[0]
        assert any(v for v in verdicts[1]), "the sequence trips the detector"


def test_detector_windowed_blowup_and_reset():
    """The reference's own case: a blown value does not enter the window,
    and after a reset there is no history to call a blow-up against."""
    det = TR.DivergenceDetector(TR.FaultPolicy(window=8, loss_factor=10.0, grad_factor=10.0))
    m = {"g_loss": 1.0, "d_loss": 1.0, "g_grad_norm": 1.0, "d_grad_norm": 1.0}
    for s in range(6):
        assert det.observe(s, m) is None
    assert det.observe(6, dict(m, d_grad_norm=1e4)) == "grad_explosion:d_grad_norm"
    assert det.observe(7, m) is None
    det.reset()
    assert det.observe(8, dict(m, d_grad_norm=1e4)) is None
    assert det.observe(9, dict(m, nonfinite=1.0)) == "nonfinite:metrics"


# ------------------------------------------------------------ fault plans, policies, the guard
PLANS = [
    dict(kind="raise", rate=0.3, seed=5),
    dict(kind="mix", rate=0.5, seed=1, max_faults=7),
    dict(kind="nan_grad", every_n=3, persistent=True, max_faults=4),
    dict(kind="preempt", at_step=4),
    dict(kind="corrupt_ckpt", rate=0.7, every_n=2, persistent=True, seed=11),
    dict(kind="mix", every_n=1, max_faults=3),
]


@pytest.mark.parametrize("spec", PLANS, ids=[f"{p['kind']}-{i}" for i, p in enumerate(PLANS)])
def test_fault_plan_draws_match_the_reference(spec):
    """One seed fires the same faults on the same attempts in both packages
    (the port keeps the reference's numpy generator)."""
    jp, tp = JR.TrainFaultPlan(**spec), TR.TrainFaultPlan(**spec)
    draws = [[p.draw(step=s, attempt=a) for s in range(24) for a in range(3)] for p in (jp, tp)]
    assert draws[1] == draws[0] and any(draws[1])
    assert (tp.fired, tp.totals()) == (jp.fired, jp.totals())
    assert TR.plan_totals([tp, TR.TrainFaultPlan(kind="raise", at_step=1)]) == JR.plan_totals([jp])


def test_fault_plan_and_policy_refuse_what_the_reference_refuses():
    for mod in (JR, TR):
        with pytest.raises(ValueError):
            mod.TrainFaultPlan(kind="meteor")
        with pytest.raises(ValueError):
            mod.FaultPolicy(on_divergence="retry")


def test_policy_defaults_and_backoff_match_the_reference():
    assert dataclasses.asdict(TR.FaultPolicy()) == dataclasses.asdict(JR.FaultPolicy())
    for kw in (dict(backoff_s=1.0, backoff_cap_s=5.0), dict(backoff_s=0.25), dict(backoff_s=0.0)):
        assert [TR.FaultPolicy(**kw).backoff(a) for a in range(8)] == [JR.FaultPolicy(**kw).backoff(a)
                                                                        for a in range(8)]
    assert [TR.FaultPolicy(backoff_s=1.0, backoff_cap_s=5.0).backoff(a) for a in range(4)] == [1.0, 2.0, 4.0, 5.0]


def test_preemption_guard_restores_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    with TR.PreemptionGuard() as g:
        assert g.installed and not g.requested
        g.request()
        assert g.requested
    assert signal.getsignal(signal.SIGTERM) is prev
    with TR.PreemptionGuard(install=False) as g:
        assert not g.installed
    assert signal.getsignal(signal.SIGTERM) is prev


def test_preemption_guard_off_main_thread_stays_uninstalled():
    out = {}

    def body():
        with TR.PreemptionGuard() as g:
            out["installed"] = g.installed
            g.request()
            out["requested"] = g.requested

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"installed": False, "requested": True}


def test_nonfinite_flag_values():
    ok = {k: torch.tensor(1.0) for k in TR.METRIC_KEYS}
    assert float(TR.nonfinite_flag(ok)) == 0.0
    assert float(TR.nonfinite_flag(dict(ok, d_grad_norm=torch.tensor(float("inf"))))) == 1.0
    assert float(TR.nonfinite_flag(dict(ok, g_loss=torch.tensor(float("nan"))))) == 1.0
    assert TT.nonfinite_flag is TR.nonfinite_flag  # the trainer's import path still works


def test_corrupt_latest_checkpoint_truncates_the_newest_first_leaf(tmp_path):
    TC.save_checkpoint(str(tmp_path), 3, {"a": torch.ones((4, 4)), "b": torch.zeros(2)})
    TC.save_checkpoint(str(tmp_path), 5, {"a": torch.ones((4, 4)), "b": torch.zeros(2)})
    assert TR.corrupt_latest_checkpoint(str(tmp_path)) == 5
    with pytest.raises(TC.CheckpointCorruptError):
        TC.verify_checkpoint(str(tmp_path), 5)
    with pytest.raises(JC.CheckpointCorruptError):  # the reference sees the same damage
        JC.verify_checkpoint(str(tmp_path), 5)
    TC.verify_checkpoint(str(tmp_path), 3)
    assert TR.corrupt_latest_checkpoint(str(tmp_path / "empty")) is None


# ------------------------------------------------------------ TRAIN_GAN_PLAN through both train_gan loops
def _discogan(zoo):
    """DiscoGAN at 8 channels (its 5 convs, the last K4S1, into 4 K4S2
    deconvs), ref / lax on both nets."""
    full = zoo.DISCOGAN
    enc = [(3, 8)] + [(8, 8)] * (len(full.encoder) - 1)
    dec = [(8, 8), (8, 8), (8, 8), (8, 3)]
    return dataclasses.replace(
        full, encoder=tuple(dataclasses.replace(e, c_in=a, c_out=b) for e, (a, b) in zip(full.encoder, enc)),
        deconvs=tuple(dataclasses.replace(d, c_in=a, c_out=b) for d, (a, b) in zip(full.deconvs, dec)),
        disc_channels=(8, 8, 8, 8), deconv_impl="ref", conv_impl="lax")


def jax_batches(calls=None):
    """The port's data functions, returning JAX's batches for the same
    (seed, step) on the requested device (recording the steps in ``calls``)."""
    def latent_batch(seed, step, batch, z_dim, *, device="cuda"):
        return torch.from_numpy(np.array(JD.latent_batch(seed, step, batch, z_dim))).to(device)

    def gan_batch(seed, step, batch, hw, ch=3, *, device="cuda"):
        if calls is not None:
            calls.append(step)
        return torch.from_numpy(np.array(JD.gan_batch(seed, step, batch, hw, ch))).to(device)

    return {"latent_batch": latent_batch, "gan_batch": gan_batch}


def jax_start(directory, cfg, seed):
    """A step-0 checkpoint of JAX train_gan's own init for ``seed``."""
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    gp, dp = JG.generator_init(kg, cfg), JG.discriminator_init(kd, cfg)
    JC.save_checkpoint(str(directory), 0, {"gp": gp, "dp": dp, "g_opt": jadamw_init(gp), "d_opt": jadamw_init(dp)})


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos")
    jcfg, tcfg = _discogan(jzoo), _discogan(tzoo)
    jax_start(root / "start", jcfg, SEED)
    for name in ("jax", "port"):
        shutil.copytree(root / "start", root / name)
    kw = dict(steps=chip_smoke.TRAIN_GAN_STEPS, batch=BATCH, seed=SEED, ckpt_every=chip_smoke.TRAIN_GAN_CKPT_EVERY,
              log_every=1, handle_signals=False)
    calls = []
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore", RuntimeWarning)  # the fallback past the truncated step 8
        for name, fn in jax_batches(calls).items():
            mp.setattr(TD, name, fn)
        jb = JT.train_gan(jcfg, ckpt_dir=str(root / "jax"), fault_plan=chip_smoke.train_gan_plans(JR), **kw)
        tb = TT.train_gan(tcfg, ckpt_dir=str(root / "port"), fault_plan=chip_smoke.train_gan_plans(TR),
                          device="cpu", **kw)
        # the resumes cross over: each package resumes the other's checkpoint directory
        jc = JT.train_gan(jcfg, ckpt_dir=str(root / "port"), **kw)
        tc = TT.train_gan(tcfg, ckpt_dir=str(root / "jax"), device="cpu", **kw)
    return dict(jax=dict(chaos=jb, resume=jc), port=dict(chaos=tb, resume=tc), tcfg=tcfg, calls=calls)


@pytest.mark.parametrize("run", ["chaos", "resume"])
def test_train_gan_plan_accounting_matches_the_reference_and_the_smoke(chaos, run):
    port, ref = chip_smoke.accounting(chaos["port"][run]), chip_smoke.accounting(chaos["jax"][run])
    assert port == ref
    assert port == chip_smoke.TRAIN_GAN_EXPECTED[run]


@pytest.mark.parametrize("run", ["chaos", "resume"])
def test_train_gan_plan_metrics_match_the_reference(chaos, run):
    """The same trajectory in both packages (the resumed runs each continue
    the other package's history), within 1e-3 relative, the NaN step
    rolled back out of both."""
    port, ref = chaos["port"][run]["metrics"], chaos["jax"][run]["metrics"]
    assert [e["step"] for e in port] == [e["step"] for e in ref] == list(range(1, chaos["port"][run]["final_step"] + 1))
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            assert math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-3 * abs(b[k]), (a["step"], k, a[k], b[k])
        assert a["nonfinite"] == b["nonfinite"] == 0.0


def test_train_gan_plan_runs_the_image_to_image_branch(chaos):
    """DiscoGAN has no latent: the generator's input is the image batch of
    step 1_000_000 + s (``trainer.py``'s ``z_dim == 0`` branch)."""
    assert chaos["tcfg"].z_dim == 0
    fakes = sorted({s - 1_000_000 for s in chaos["calls"] if s >= 1_000_000})
    assert fakes == list(range(chip_smoke.TRAIN_GAN_STEPS))
    gp = chaos["port"]["resume"]["params"]["gp"]
    assert {f"enc{i}" for i in range(5)} <= set(gp) and "stem" not in gp


# ------------------------------------------------------------ the policies on the port's loop (tiny_dcgan, ref / lax)
def _kw(tmp_path, name=None, **over):
    kw = dict(steps=8, batch=2, seed=3, ckpt_every=4, log_every=1, handle_signals=False, device="cpu")
    if name is not None:
        kw["ckpt_dir"] = str(tmp_path / name)
    kw.update(over)
    return kw


def test_persistent_fault_escalates_instead_of_looping(tmp_path):
    """A fault that re-fires at the same step escalates into a carried
    TrainFaultError after the per-step budget instead of replaying forever."""
    plan = TR.TrainFaultPlan(kind="raise", at_step=2, persistent=True)
    with pytest.raises(TR.TrainFaultError) as ei:
        TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan, policy=TR.FaultPolicy(max_restores_per_step=2),
                     **_kw(tmp_path, "loop", steps=6, ckpt_every=2))
    assert (ei.value.kind, ei.value.step, ei.value.attempts) == ("crashloop", 2, 3)
    assert isinstance(ei.value.cause, TR.InjectedTrainFault)


def test_run_wide_restore_budget(tmp_path):
    plan = TR.TrainFaultPlan(kind="raise", every_n=1, persistent=True)
    with pytest.raises(TR.TrainFaultError) as ei:
        TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan,
                     policy=TR.FaultPolicy(max_restores_per_step=100, max_total_restores=3),
                     **_kw(tmp_path, "budget", steps=6, ckpt_every=2))
    assert ei.value.attempts == 4 and plan.fired == 4  # three restores, then the budget


def test_nan_grad_skip_policy(tmp_path):
    """skip: the poisoned update is discarded (the pre-step trees kept) and
    the run goes on without a checkpoint directory."""
    plan = TR.TrainFaultPlan(kind="nan_grad", at_step=2, max_faults=1)
    out = TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan, policy=TR.FaultPolicy(on_divergence="skip"),
                       **_kw(tmp_path, steps=5))
    assert out["final_step"] == 5 and out["counters"]["skips"] == 1
    assert out["fault_log"] == [{"step": 2, "kind": "divergence", "verdict": "nonfinite:g_loss", "action": "skip",
                                 "injected": True, "attempt": 0, "error": None}]
    assert [e["step"] for e in out["metrics"]] == [1, 2, 4, 5]
    assert all(math.isfinite(v) for e in out["metrics"] for v in e.values())


def test_abort_policy_and_rollback_without_a_directory_raise_divergence(tmp_path):
    plan = lambda: TR.TrainFaultPlan(kind="nan_grad", at_step=1, max_faults=1)  # noqa: E731
    with pytest.raises(TR.TrainDivergenceError) as ei:
        TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan(), policy=TR.FaultPolicy(on_divergence="abort"),
                     **_kw(tmp_path, "abort", steps=4))
    assert ei.value.verdict.startswith("nonfinite") and ei.value.step == 1
    with pytest.raises(TR.TrainDivergenceError, match="no ckpt_dir"):
        TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan(), **_kw(tmp_path, steps=4))


def test_lr_scale_applied_per_rollback(tmp_path):
    plan = TR.TrainFaultPlan(kind="nan_grad", at_step=5, max_faults=1)
    out = TT.train_gan(tzoo.tiny_dcgan(), fault_plan=plan, policy=TR.FaultPolicy(lr_scale=0.5), **_kw(tmp_path, "lrs"))
    assert out["lr_scale"] == 0.5 and out["final_step"] == 8
    assert TC.load_loop_state(str(tmp_path / "lrs"), 8)["lr_scale"] == 0.5
    assert out["counters"]["rollbacks"] == 1 and out["counters"]["injected_handled"] == {"nan_grad": 1}
