"""Async serving loop: an admission thread and a generate thread over one
engine, supervised by a watchdog, as the reference's.

``AsyncGanServer`` turns the synchronous ``GanServeEngine`` core into an
open-loop service.  ``submit`` does not block: it enqueues the request
into the engine's shared FIFO, or rejects it at once (the bounded in-flight
queue is full, the target arch is quarantined, or the server has failed);
backpressure reaches the caller as a reasoned ``GanServeRejected`` from
``GanFuture.result()``.  Three daemon threads drive the engine:

  admission  moves pending requests into free slot rows (strict FIFO),
             refilling the pool while the device works: ``_dispatch``
             frees the rows under the lock before it runs the generates
  generate   dispatches the shared batch whenever its window closes; the
             only thread that launches kernels while the server runs
  watchdog   supervises the other two: a dead loop thread (an exception
             escaped the engine's isolation boundary: a bug, not a request
             failure) fails the affected futures with ``GanServeError`` and
             restarts the loop, up to ``max_restarts`` times; past that the
             server marks itself failed and resolves everything queued

Completion is by event: the generate thread stamps the SLO times and sets
each request's event after its stream was synchronized, so a caller on
another thread reads finished images.  ``torch.inference_mode`` is
thread-local; each generate enters it (``_Resident.generate``).  While a
server is attached (``engine._driver``) futures never drive the engine
themselves: there is one dispatch path.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .engine import GanFuture, GanRequest, GanServeEngine, _now_ms
from .faults import GanServeError

__all__ = ["AsyncGanServer"]


class AsyncGanServer:
    """Threaded server over a ``GanServeEngine``.

    ``max_queue`` bounds the in-flight population (pending + admitted);
    submissions past it are rejected at once.  ``poll_interval_ms`` is the
    idle sleep of both loops.  ``watchdog`` (on by default) restarts a dead
    loop thread up to ``max_restarts`` times, failing the futures whose
    dispatch state died with it.  Use as a context manager, or ``start()`` /
    ``stop()``."""

    def __init__(self, engine: GanServeEngine, *, max_queue: int = 64, poll_interval_ms: float = 1.0,
                 watchdog: bool = True, watchdog_interval_ms: float = 20.0, max_restarts: int = 3):
        self.engine = engine
        self.max_queue = int(max_queue)
        self.poll_interval_s = poll_interval_ms / 1e3
        self.watchdog_enabled = bool(watchdog)
        self.watchdog_interval_s = watchdog_interval_ms / 1e3
        self.max_restarts = int(max_restarts)
        self.rejected_count = 0
        self.restart_count = 0
        self.wedged: list[str] = []
        self._failed = False
        self._stop = threading.Event()
        self._draining = True
        self._workers: dict[str, threading.Thread] = {}
        self._watchdog_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def _spawn_worker(self, name: str) -> None:
        target = {"admission": self._admission_loop, "generate": self._generate_loop}[name]
        t = threading.Thread(target=target, name=f"gan-serve-{name}", daemon=True)
        self._workers[name] = t
        t.start()

    def start(self) -> "AsyncGanServer":
        if self._workers:
            raise RuntimeError("server already started")
        self.engine._driver = self
        self._stop.clear()
        self._failed = False
        for name in ("admission", "generate"):
            self._spawn_worker(name)
        if self.watchdog_enabled:
            self._watchdog_thread = threading.Thread(target=self._watchdog_loop, name="gan-serve-watchdog",
                                                     daemon=True)
            self._watchdog_thread.start()
        return self

    def _take_all(self, *, inflight: bool) -> list[GanRequest]:
        """Empty the engine's queue, pool (and in-flight snapshot), under its
        lock; the unresolved requests they held."""
        eng = self.engine
        with eng._lock:
            leftovers = (list(eng._inflight) if inflight else []) + list(eng.active) + list(eng._pending)
            if inflight:
                eng._inflight = []
            eng._pending.clear()
            eng.active, eng.rows_used = [], 0
            eng._window_deadline, eng._immediate = None, False
        return [r for r in leftovers if not r.resolved]

    def stop(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the loops.  ``drain=True`` serves everything submitted
        first; ``drain=False`` rejects the requests in flight (their futures
        raise ``GanServeRejected``).

        A loop thread still alive after ``timeout`` (wedged, e.g. in a hung
        generate) is not papered over: the in-flight futures fail with
        ``GanServeError`` (kind "stop_wedged"), the thread names land in
        ``self.wedged``, and ``RuntimeError`` is raised."""
        self._draining = drain
        self._stop.set()
        for t in self._workers.values():
            t.join(timeout)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout)
            self._watchdog_thread = None
        wedged = [n for n, t in self._workers.items() if t.is_alive()]
        self._workers = {}
        eng = self.engine
        if wedged:
            self.wedged = wedged
            self._failed = True
            stranded = self._take_all(inflight=True)
            eng._fail_requests(stranded, GanServeError(
                f"server stopped with wedged thread(s) {wedged}; request state unknown", kind="stop_wedged"))
            eng._driver = None
            raise RuntimeError(f"AsyncGanServer.stop(): thread(s) {wedged} still alive after {timeout}s join; "
                               f"{len(stranded)} in-flight future(s) failed instead of stranded")
        if not drain:
            dropped = self._take_all(inflight=False)
            for req in dropped:
                req.rejected = True
                req.reject_reason = "server stopped without drain"
                req.event.set()
            self.rejected_count += len(dropped)
        eng._driver = None

    def __enter__(self) -> "AsyncGanServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # ------------------------------------------------------------- frontend
    def submit(self, z: torch.Tensor, *, arch: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> GanFuture:
        """Non-blocking submit.  An oversized request raises ValueError (a
        caller error); a full in-flight queue, a quarantined arch or a
        failed server rejects the request: the returned future is already
        done and ``result()`` raises a reasoned ``GanServeRejected``."""
        eng = self.engine
        arch_r = eng._resolve_arch(arch)
        if int(z.shape[0]) > eng.batch:
            raise ValueError(f"request batch {int(z.shape[0])} > engine max bucket {eng.batch}")
        req = GanRequest(rid=next(eng._rid), z=z.to(eng.device, torch.float32), arch=arch_r,
                         deadline_ms=deadline_ms, t_submit=_now_ms())
        ok, reason = eng.archs[arch_r].breaker.allow_submit()
        if not ok:
            req.rejected = True
            req.reject_reason = f"arch {arch_r!r}: {reason}"
        elif self._failed:
            req.rejected = True
            req.reject_reason = "server failed (restart budget exhausted)"
        else:
            with eng._lock:
                if len(eng._pending) + len(eng.active) >= self.max_queue:
                    req.rejected = True
                    req.reject_reason = f"inbound queue full (max_queue={self.max_queue})"
                else:
                    eng._pending.append(req)
        if req.rejected:
            self.rejected_count += 1
            req.event.set()
        return GanFuture(req, eng)

    # --------------------------------------------------------------- health
    def healthy(self) -> bool:
        """True while submitted work can still complete: the loop threads
        are alive, or a live watchdog will restart any that died."""
        if self._failed:
            return False
        wd = self._watchdog_thread
        if wd is not None and wd.is_alive():
            return True
        return all(t.is_alive() for t in self._workers.values())

    def health(self) -> dict:
        """Thread liveness, restart and wedge accounting, and the engine's
        circuit-breaker counters per arch."""
        return {
            "threads": {n: t.is_alive() for n, t in self._workers.items()},
            "restarts": self.restart_count,
            "wedged": list(self.wedged),
            "failed": self._failed,
            "rejected": self.rejected_count,
            "archs": self.engine.health(),
        }

    # ---------------------------------------------------------------- loops
    def _idle(self) -> bool:
        eng = self.engine
        with eng._lock:
            return not eng._pending and not eng.active

    def _admission_loop(self) -> None:
        eng = self.engine
        while True:
            with eng._lock:
                eng._admit_pending()
            if self._stop.is_set() and (not self._draining or self._idle()):
                return
            time.sleep(self.poll_interval_s)

    def _generate_loop(self) -> None:
        eng = self.engine
        while True:
            drain_now = self._stop.is_set() and self._draining
            with eng._lock:
                ready = bool(eng.active) and (drain_now or not eng.window_open())
            if ready:
                eng._dispatch()
                continue
            if self._stop.is_set() and (not self._draining or self._idle()):
                return
            time.sleep(self.poll_interval_s)

    # ------------------------------------------------------------- watchdog
    def _on_worker_death(self, name: str) -> None:
        """A loop thread died.  Fail every request whose dispatch state died
        with it (the in-flight snapshot and the admitted batch), then restart
        the loop; past ``max_restarts`` mark the server failed and resolve
        the pending queue too."""
        eng = self.engine
        self.restart_count += 1
        exhausted = self.restart_count > self.max_restarts
        with eng._lock:
            affected = list(eng._inflight) + list(eng.active)
            eng._inflight = []
            eng.active, eng.rows_used = [], 0
            eng._window_deadline, eng._immediate = None, False
            dead_pending = []
            if exhausted:
                dead_pending = list(eng._pending)
                eng._pending.clear()
        eng._fail_requests([r for r in affected if not r.resolved], GanServeError(
            f"serve {name} loop died; in-flight request state discarded", kind="loop_dead"))
        if exhausted:
            eng._fail_requests([r for r in dead_pending if not r.resolved], GanServeError(
                f"serve {name} loop died and the restart budget ({self.max_restarts}) is exhausted",
                kind="loop_dead"))
            self._failed = True
            return
        self._spawn_worker(name)

    def _watchdog_loop(self) -> None:
        while not self._stop.wait(self.watchdog_interval_s):
            for name in ("admission", "generate"):
                t = self._workers.get(name)
                if t is None or t.is_alive() or self._stop.is_set():
                    continue
                self._on_worker_death(name)
                if self._failed:
                    return
