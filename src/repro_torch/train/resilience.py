"""Resilient training: step sentinels, fault policies, preemption-safe
exit, and train-side chaos injection (the reference's
``train/resilience.py``, on torch tensors).

The train loop's contract, built here and enforced by
``trainer.train_gan``:

  * **no silent garbage**: a step sentinel (a finiteness flag the step
    computes over its losses and grad norms, plus a host-side windowed
    divergence detector) catches a NaN loss or a blown-up trajectory the
    step it happens;
  * **no infinite replay**: the fault-restore path is budgeted by a
    ``FaultPolicy`` (restores per step, restores per run, capped
    exponential backoff); a fault that re-fires deterministically at the
    same step escalates into a carried ``TrainFaultError``;
  * **no lost work on preemption**: ``PreemptionGuard`` turns
    SIGTERM/SIGINT into a flag the loop checks at step boundaries; the
    trainer writes one final atomic checkpoint (params, optimizer state and
    the loop state) and returns cleanly, and the resumed run is bit-exact
    against an uninterrupted one;
  * **first-class chaos**: ``TrainFaultPlan`` injects raising steps, NaN
    gradients, on-disk checkpoint corruption and simulated preemption.  It
    draws from a seeded numpy generator as the reference's does, so one
    seed fires the same faults on the same attempts in both packages.

Everything here is host-side control plane except ``nonfinite_flag``,
which the step computes on its device.
"""
from __future__ import annotations

import dataclasses
import math
import os
import signal
import statistics
import threading
from collections import deque
from typing import Optional

import numpy as np
import torch

__all__ = ["METRIC_KEYS", "LOSS_KEYS", "GRAD_KEYS", "TrainFaultError", "TrainDivergenceError", "InjectedTrainFault",
           "nonfinite_flag", "FaultPolicy", "DivergenceDetector", "TrainFaultPlan", "plan_totals", "PreemptionGuard",
           "corrupt_latest_checkpoint"]

#: the step metrics the sentinel watches (every GAN step emits them)
METRIC_KEYS = ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")
LOSS_KEYS = ("g_loss", "d_loss")
GRAD_KEYS = ("g_grad_norm", "d_grad_norm")


class TrainFaultError(RuntimeError):
    """A training failure carried OUT of the loop: the fault at ``step``
    exhausted its replay budget (crashloop), or the policy said abort.
    ``kind`` names the mode ("crashloop", "budget", "divergence", ...);
    ``attempts`` counts how many times the step was tried; ``cause`` keeps
    the original exception when there was one."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 kind: str = "crashloop", attempts: int = 1,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.step = step
        self.kind = kind
        self.attempts = attempts
        self.cause = cause


class TrainDivergenceError(TrainFaultError):
    """The sentinel flagged a bad step and the ``FaultPolicy`` escalated
    (``on_divergence="abort"``, skip/rollback budget exhausted, or
    rollback requested with no checkpoint directory to roll back to).
    ``verdict`` carries the sentinel's reason string."""

    def __init__(self, message: str, *, verdict: str = "", **kw):
        kw.setdefault("kind", "divergence")
        super().__init__(message, **kw)
        self.verdict = verdict


class InjectedTrainFault(RuntimeError):
    """The exception a ``TrainFaultPlan(kind="raise")`` throws inside the
    train loop — distinguishable from organic failures, so the chaos
    harness can reconcile injected vs handled counts."""


def nonfinite_flag(metrics: dict) -> torch.Tensor:
    """Sentinel bit, computed with the step: 1.0 when any watched step
    metric is non-finite (a NaN loss, an inf grad norm: the signatures of a
    poisoned update), else 0.0.  One reduction over four scalars on their
    device; the host reads it with the metrics it already fetches."""
    vals = torch.stack([torch.as_tensor(metrics[k]).float() for k in METRIC_KEYS if k in metrics])
    return (~torch.isfinite(vals).all()).float()


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """What the train loop does when a step goes bad, in one bundle.

    Two failure classes share the restore budget:

      * a **raised** step (device error, injected fault, straggler
        deadline) always restores the newest valid checkpoint and
        replays, within the budgets below;
      * a **diverged** step (sentinel verdict: non-finite metrics, loss
        blow-up, grad-norm explosion) is handled per ``on_divergence``:

        ``"skip"``      discard the update (revert to the pre-step
                        params, which the port's step leaves intact) and
                        move on to the next batch; bounded by
                        ``max_skips``.
        ``"rollback"``  restore the newest valid checkpoint and replay,
                        optionally shrinking the learning rate by
                        ``lr_scale`` per rollback so the replayed
                        trajectory actually changes; shares the restore
                        budget with the raised-step path.
        ``"abort"``     raise ``TrainDivergenceError`` immediately.

    Budgets: ``max_restores_per_step`` bounds replays of the SAME step
    (crashloop detection — a deterministic fault escalates after this
    many restores instead of spinning forever); ``max_total_restores``
    bounds the whole run.  ``backoff_s`` doubles per consecutive attempt
    at the same step, capped at ``backoff_cap_s`` (transient
    infrastructure faults get breathing room; tests set it to 0).

    Sentinel knobs: ``sentinel=False`` turns the per-step host read of
    the metrics scalars off entirely (pure-throughput runs keep the old
    only-sync-at-log-boundaries behavior); ``window`` is the divergence
    detector's history length, ``loss_factor``/``grad_factor`` flag a
    value beyond that multiple of the windowed median, ``loss_cap`` is an
    absolute guard that needs no history.
    """

    on_divergence: str = "rollback"
    max_restores_per_step: int = 3
    max_total_restores: int = 50
    backoff_s: float = 0.0
    backoff_cap_s: float = 30.0
    lr_scale: float = 1.0
    max_skips: int = 25
    sentinel: bool = True
    window: int = 25
    loss_factor: float = 100.0
    grad_factor: float = 1000.0
    loss_cap: float = 1e6

    def __post_init__(self):
        if self.on_divergence not in ("skip", "rollback", "abort"):
            raise ValueError(
                f"on_divergence must be skip|rollback|abort, "
                f"got {self.on_divergence!r}"
            )

    def backoff(self, attempt: int) -> float:
        """Sleep before restore ``attempt`` (0-based) at one step: capped
        exponential, 0 when backoff is disabled."""
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)


class DivergenceDetector:
    """Host-side windowed divergence detector over the step metrics.

    ``observe(step, metrics)`` returns a verdict string — e.g.
    ``"nonfinite:g_loss"``, ``"loss_blowup:d_loss"``,
    ``"grad_explosion:g_grad_norm"`` — or None for a healthy step.  Only
    healthy values enter the window, so one blown step cannot poison the
    reference the next steps are judged against; ``reset()`` clears the
    window after a rollback (the restored trajectory starts a fresh
    reference)."""

    def __init__(self, policy: FaultPolicy):
        self.policy = policy
        self._hist: dict[str, deque] = {
            k: deque(maxlen=policy.window) for k in METRIC_KEYS
        }

    def reset(self) -> None:
        for d in self._hist.values():
            d.clear()

    def _windowed(self, key: str, value: float, factor: float) -> bool:
        h = self._hist[key]
        if len(h) < max(4, self.policy.window // 4):
            return False  # not enough history to call a blow-up
        med = statistics.median(h)
        return abs(value) > factor * max(abs(med), 1e-8)

    def observe(self, step: int, metrics: dict) -> Optional[str]:
        p = self.policy
        vals = {k: float(metrics[k]) for k in METRIC_KEYS if k in metrics}
        if float(metrics.get("nonfinite", 0.0)):
            bad = [k for k, v in vals.items() if not math.isfinite(v)]
            return "nonfinite:" + (bad[0] if bad else "metrics")
        for k, v in vals.items():
            if not math.isfinite(v):
                return f"nonfinite:{k}"
        for k in LOSS_KEYS:
            if k in vals:
                if abs(vals[k]) > p.loss_cap:
                    return f"loss_blowup:{k}"
                if self._windowed(k, vals[k], p.loss_factor):
                    return f"loss_blowup:{k}"
        for k in GRAD_KEYS:
            if k in vals and self._windowed(k, vals[k], p.grad_factor):
                return f"grad_explosion:{k}"
        for k, v in vals.items():
            self._hist[k].append(v)
        return None


@dataclasses.dataclass
class TrainFaultPlan:
    """Declarative fault injection for the train loop (the mirror of
    ``serve.FaultPlan``; ``train_gan(fault_plan=...)`` takes one plan or a
    sequence of them, each consulted once per step attempt).

    ``kind``:
      "raise"         throw ``InjectedTrainFault`` before the step runs
                      (the generic infrastructure fault: exercises the
                      restore-and-replay path)
      "nan_grad"      NaN-poison the latent batch, so the step computes
                      NaN losses/grads and the update writes NaN params —
                      exactly what a bad kernel or an fp overflow does;
                      caught by the sentinel
      "corrupt_ckpt"  truncate a leaf of the newest on-disk checkpoint
                      (torn write / disk fault: the next restore must
                      fall back past it)
      "preempt"       request preemption as if SIGTERM had arrived — the
                      loop checkpoints and returns at the next boundary
      "mix"           rotate raise/nan_grad/corrupt_ckpt per firing

    Targeting (constraints AND together): ``at_step`` (only this step),
    ``every_n`` (steps that are a multiple of n), ``rate`` (i.i.d. per
    attempt, seeded).  ``persistent=False`` fires only on a step's FIRST
    attempt, so a restore-and-replay recovers; ``persistent=True`` makes
    the fault re-fire on replay (crashloop drills).  ``max_faults`` bounds
    total firings; ``fired``/``fired_by_kind`` are the accounting the
    chaos gate reconciles against the trainer's handled counts.
    """

    kind: str = "raise"
    at_step: Optional[int] = None
    every_n: Optional[int] = None
    rate: float = 1.0
    persistent: bool = False
    max_faults: Optional[int] = None
    seed: int = 0
    fired: int = dataclasses.field(default=0)
    fired_by_kind: dict = dataclasses.field(default_factory=dict)

    _KINDS = ("raise", "nan_grad", "corrupt_ckpt", "preempt")

    def __post_init__(self):
        if self.kind not in self._KINDS + ("mix",):
            raise ValueError(f"unknown train fault kind {self.kind!r}")
        self._rng = np.random.default_rng(self.seed)

    def draw(self, *, step: int, attempt: int = 0) -> Optional[str]:
        """The fault kind to inject for this step attempt, or None."""
        if self.max_faults is not None and self.fired >= self.max_faults:
            return None
        if attempt > 0 and not self.persistent:
            return None
        if self.at_step is not None and step != self.at_step:
            return None
        if self.every_n is not None and step % self.every_n != 0:
            return None
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            return None
        kind = self.kind if self.kind != "mix" else \
            self._KINDS[self.fired % 3]  # rotate raise/nan_grad/corrupt_ckpt
        self.fired += 1
        self.fired_by_kind[kind] = self.fired_by_kind.get(kind, 0) + 1
        return kind

    def totals(self) -> dict:
        return dict(self.fired_by_kind)


def plan_totals(plans) -> dict:
    """Summed ``fired_by_kind`` across a plan sequence (the "injected"
    side of the chaos accounting)."""
    out: dict = {}
    for p in plans or ():
        for k, v in p.fired_by_kind.items():
            out[k] = out.get(k, 0) + v
    return out


class PreemptionGuard:
    """SIGTERM/SIGINT → a flag the train loop polls at step boundaries.

    Installed as a context manager around the loop; the handler only sets
    ``requested`` (async-signal-safe), and the loop does the actual work —
    one final atomic checkpoint, then a clean return.  Previous handlers
    are restored on exit.  Installation is skipped (``installed=False``)
    off the main thread, where Python forbids ``signal.signal``;
    ``request()`` is the programmatic path (chaos ``"preempt"`` faults,
    cluster-manager callbacks) and works anywhere."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *,
                 install: bool = True):
        self.signals = tuple(signals)
        self.install = install
        self.requested = False
        self.installed = False
        self._prev: dict = {}

    def request(self) -> None:
        self.requested = True

    def _handler(self, signum, frame) -> None:
        self.requested = True

    def __enter__(self) -> "PreemptionGuard":
        if self.install and threading.current_thread() is threading.main_thread():
            try:
                for s in self.signals:
                    self._prev[s] = signal.signal(s, self._handler)
                self.installed = True
            except (ValueError, OSError):  # exotic embedding: stay uninstalled
                self._prev.clear()
        return self

    def __exit__(self, *exc) -> None:
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self.installed = False
        return None


def corrupt_latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """Chaos helper: truncate the first leaf of the newest on-disk
    checkpoint (a torn write a power loss could leave behind if fsync is
    broken).  Returns the corrupted step, or None when there is nothing
    to corrupt.  Test/injection use only."""
    from . import checkpoint as C

    steps = C.available_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1]
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    leaves = sorted(f for f in os.listdir(path) if f.startswith("leaf_"))
    if not leaves:
        return None
    victim = os.path.join(path, leaves[0])
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(max(1, size // 2))
    return step
