"""Failure semantics of the GAN serve path: carried errors, circuit
breakers and fault injection, as the reference's.

  ``GanServeError``    a failure carried into the future: a request whose
                       dispatch failed (an exception in the generate, a
                       NaN-poisoned batch, a retry budget cut by the
                       deadline) resolves by raising this from
                       ``GanFuture.result()``; futures never hang on a
                       failure.
  ``CircuitBreaker``   quarantine per resident arch: K consecutive dispatch
                       failures open it (new submits fast-reject with a
                       reasoned ``GanServeRejected``); after a cooldown it
                       half-opens and one successful probe re-admits the
                       arch.
  ``FaultPlan``        declarative fault injection for tests and chaos
                       drills: raise / NaN-poison / delay a per-arch
                       generate, targeted by arch, rid, every n-th dispatch
                       or an i.i.d. rate drawn from a seeded numpy
                       generator, so one seed fires the same faults on the
                       same attempts in both packages.

Everything here is host-side control plane: no tensor is touched.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

__all__ = ["GanServeError", "InjectedFault", "CircuitBreaker", "FaultPlan"]


class GanServeError(RuntimeError):
    """A serve-path failure carried by the request: the dispatch that held
    it failed (after any retries) and the future resolves by raising this.
    ``kind`` names the failure mode ("exception", "nan", "deadline",
    "weights", "loop_dead", "stop_wedged"); ``cause`` keeps the original
    exception when there was one."""

    def __init__(self, message: str, *, arch: Optional[str] = None, kind: str = "exception", attempts: int = 1,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.arch = arch
        self.kind = kind
        self.attempts = attempts
        self.cause = cause


class InjectedFault(RuntimeError):
    """What a ``FaultPlan(kind="raise")`` throws inside a per-arch generate:
    told apart from organic failures in logs and tests."""


def _now_ms(now: Optional[float] = None) -> float:
    return time.monotonic() * 1e3 if now is None else now


class CircuitBreaker:
    """Quarantine state machine per arch: closed -> open -> half_open.

    ``on_failure`` / ``on_success`` record final outcomes per dispatch (a
    retry that recovers is a success).  After ``threshold`` consecutive
    failures the breaker opens: ``allow_submit`` fast-rejects until
    ``cooldown_ms`` has passed, then the breaker half-opens; submits are
    admitted again as probe traffic, and the first probe's outcome decides:
    success closes the breaker, failure opens it again (the cooldown
    restarts)."""

    def __init__(self, *, threshold: int = 3, cooldown_ms: float = 250.0):
        self.threshold = int(threshold)
        self.cooldown_ms = float(cooldown_ms)
        self.state = "closed"
        self.consecutive_failures = 0
        self.trips = 0  # closed/half_open -> open transitions
        self.recoveries = 0  # half_open -> closed transitions
        self._opened_at_ms: Optional[float] = None

    def _open(self, now_ms: float) -> None:
        if self.state != "open":
            self.trips += 1
        self.state = "open"
        self._opened_at_ms = now_ms

    def on_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == "half_open":
            self.recoveries += 1
        self.state = "closed"

    def on_failure(self, now: Optional[float] = None) -> None:
        t = _now_ms(now)
        self.consecutive_failures += 1
        if self.state == "half_open" or self.consecutive_failures >= self.threshold:
            self._open(t)  # a failed probe quarantines again, and the cooldown restarts

    def allow_submit(self, now: Optional[float] = None) -> tuple[bool, str]:
        """(admit?, reason).  An expired cooldown moves open -> half_open as
        a side effect, so the next submit is the probe."""
        if self.state == "closed":
            return True, ""
        t = _now_ms(now)
        if self.state == "open":
            if self._opened_at_ms is not None and t - self._opened_at_ms >= self.cooldown_ms:
                self.state = "half_open"
            else:
                wait = 0.0 if self._opened_at_ms is None else self.cooldown_ms - (t - self._opened_at_ms)
                return False, (f"quarantined after {self.consecutive_failures} consecutive failures "
                               f"(half-open probe in {wait:.0f}ms)")
        return True, ""  # half_open: admit probe traffic

    def counters(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "breaker_trips": self.trips,
            "breaker_recoveries": self.recoveries,
        }


@dataclasses.dataclass
class FaultPlan:
    """Declarative fault injection for the engine's dispatch path.

    One plan is installed on the engine (``GanServeEngine(fault_plan=...)``
    or ``engine.fault_plan = ...``) and consulted once per per-arch
    generate attempt.  Targeting, all constraints ANDed:

      arch       only this resident arch (None = any)
      rids       only dispatches holding one of these request ids
      every_n    only dispatches whose index is a multiple of ``every_n``
      rate       i.i.d. probability per attempt (seeded; 1.0 = always)

    ``kind`` is "raise" (throw ``InjectedFault``), "nan" (poison the batch
    with NaN, which the engine's NaN guard catches when on), "delay" (sleep
    ``delay_ms``: tail latency, not a failure) or "mix" (raise, nan, delay
    in turn per firing).  ``persistent=False`` fires only on a request's
    first attempt, so a retry recovers; ``persistent=True`` survives
    retries (quarantine drills).  ``max_faults`` bounds the firings."""

    kind: str = "raise"
    rate: float = 1.0
    arch: Optional[str] = None
    rids: Optional[frozenset] = None
    every_n: Optional[int] = None
    delay_ms: float = 25.0
    persistent: bool = False
    max_faults: Optional[int] = None
    seed: int = 0
    fired: int = dataclasses.field(default=0)
    fired_by_kind: dict = dataclasses.field(default_factory=dict)

    _KINDS = ("raise", "nan", "delay")

    def __post_init__(self):
        if self.kind not in self._KINDS + ("mix",):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        self._rng = np.random.default_rng(self.seed)

    def draw(self, *, arch: str, rids: tuple[int, ...], dispatch_idx: int, attempt: int = 0) -> Optional[str]:
        """The fault kind to inject for this generate attempt, or None."""
        if self.max_faults is not None and self.fired >= self.max_faults:
            return None
        if attempt > 0 and not self.persistent:
            return None
        if self.arch is not None and arch != self.arch:
            return None
        if self.rids is not None and not (set(rids) & set(self.rids)):
            return None
        if self.every_n is not None and dispatch_idx % self.every_n != 0:
            return None
        if self.rate < 1.0 and self._rng.random() >= self.rate:
            return None
        kind = self.kind if self.kind != "mix" else self._KINDS[self.fired % len(self._KINDS)]
        self.fired += 1
        self.fired_by_kind[kind] = self.fired_by_kind.get(kind, 0) + 1
        return kind
