"""Spans and host-sync marks inside the port, on the profiler's clock.

The tracer records while a ``torch.profiler`` session records, and at no
other time: a span site first reads torch's own flag
(``torch.autograd.profiler._is_profiler_enabled``).  While it is off the
site notes that (one store, so the next session starts a fresh record) and
returns a shared no-op context: it enters no ``record_function``.  While it
is on, a span enters ``torch.profiler.record_function("repro_torch.<name>")``,
which puts it in the profiler's trace on the timeline of the device's
kernels and copies, and appends a ``Record`` to the tracer's session.

A sync mark (``sync``) is a span around a call that blocks the host on the
device; its record names the call's ``site``.

Owners.  A ``scope`` (a train step, a serve dispatch) names the owner of
every span opened inside it, on any thread: on its own thread through the
open spans, on another (autograd's device thread during a pull) through the
process-wide scope, whose innermost open span is then the parent; one scope
is open at a time.  A span may also name its own owner (a submit, by the
request's ``rid``) for itself and the spans it opens on its thread; opened
on a thread with no span open, it is a root.  Owners are ``(kind, index)`` pairs:
``("step", i)``, ``("dispatch", i)``, ``("request", rid)``.

Sessions.  The first span that finds the profiler on after a span site found
it off opens a new ``Session``; the newest ``KEEP`` are kept and
``last_session()`` returns the newest.  Two profiler sessions with no span
site run between them are one session here.

Clock.  A session's first span writes a zero-length ``repro_torch.clock``
marker and keeps its own stamp of it (``Session.clock_ns``), so one offset
(``Session.trace_offset_us``) puts every record on the exported chrome
trace's ``ts``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["PREFIX", "CLOCK", "KEEP", "Record", "Session", "span", "scope", "sync", "last_session"]

PREFIX = "repro_torch."
CLOCK = PREFIX + "clock"
KEEP = 4  # sessions kept; older ones are dropped


@dataclasses.dataclass
class Record:
    """One span: its name (without ``PREFIX``), start and end on
    ``time.perf_counter_ns()`` (``end_ns`` None while it is open), the
    thread it ran on, its parent's index in the session's ``records`` (None
    at a root), its owner, and a sync mark's site (None for a plain
    span)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    thread: int
    parent: Optional[int]
    owner: Optional[tuple]
    site: Optional[str] = None

    @property
    def sync(self) -> bool:
        """Whether the span is a sync mark."""
        return self.site is not None


class Session:
    """The records of one profiler session, in the order their spans
    opened."""

    def __init__(self):
        self.records: list[Record] = []
        self.clock_ns = 0
        self._lock = threading.Lock()

    def _add(self, rec: Record) -> int:
        with self._lock:
            self.records.append(rec)
            return len(self.records) - 1

    def closed(self) -> list[Record]:
        """The records whose spans have ended."""
        return [r for r in self.records if r.end_ns is not None]

    def trace_offset_us(self, events: list[dict]) -> Optional[float]:
        """Microseconds to add to a stamp / 1e3 to get the chrome trace's
        ``ts`` of the same instant, from the clock marker among ``events``
        (None where the trace lacks it)."""
        for e in events:
            if e.get("name") == CLOCK and e.get("cat") == "user_annotation":
                return float(e["ts"]) + float(e.get("dur", 0.0)) / 2 - self.clock_ns / 1e3
        return None


_sessions: collections.deque = collections.deque(maxlen=KEEP)
_live: Optional[Session] = None  # the session being recorded; None once a site found the profiler off
_scope: Optional[tuple] = None  # (owner, the open spans of the scope's thread)
_open_lock = threading.Lock()
_local = threading.local()


_OFF = contextlib.nullcontext()  # what every span site returns while the profiler is off


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _session() -> Session:
    global _live
    with _open_lock:
        if _live is None:
            s = Session()
            t0 = time.perf_counter_ns()
            with torch.profiler.record_function(CLOCK):
                pass
            s.clock_ns = (t0 + time.perf_counter_ns()) // 2
            _sessions.append(s)
            _live = s
        return _live


class _Span:
    __slots__ = ("name", "owner", "site", "sets_scope", "rf", "session", "index", "rec", "prev_scope", "stack")

    def __init__(self, name: str, owner, site: Optional[str], sets_scope: bool):
        self.name, self.owner, self.site, self.sets_scope = name, owner, site, sets_scope

    def __enter__(self):
        global _scope
        session = _live or _session()
        stack = _stack()
        parent, owner = None, None
        if stack:
            parent, owner = stack[-1], stack[-1].rec.owner
        elif self.owner is None and _scope is not None:
            owner, scope_stack = _scope
            try:
                parent = scope_stack[-1]
            except IndexError:  # the scope closed meanwhile
                parent = None
        if self.owner is not None:
            owner = self.owner
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.rec = Record(self.name, time.perf_counter_ns(), None, threading.get_ident(),
                          parent.index if parent is not None and parent.session is session else None, owner,
                          self.site)
        self.session, self.index, self.stack = session, session._add(self.rec), stack
        stack.append(self)
        if self.sets_scope:
            self.prev_scope, _scope = _scope, (owner, stack)
        return self

    def __exit__(self, *exc):
        global _scope
        self.rec.end_ns = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.stack.pop()
        if self.sets_scope:
            _scope = self.prev_scope
        return False


def span(name: str, owner: Optional[tuple] = None):
    """A span named ``PREFIX + name`` while the profiler records; a no-op
    context otherwise.  ``owner`` names the owner of this span and of the
    spans it opens on its thread."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = None
        return _OFF
    return _Span(name, owner, None, False)


def scope(name: str, owner: tuple):
    """A span whose ``owner`` every span opened inside it takes, on any
    thread: a train step or a serve dispatch."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = None
        return _OFF
    return _Span(name, owner, None, True)


def sync(name: str, site: str, when: bool = True):
    """A sync mark: a span around a call at ``site`` that blocks the host
    on the device (``when`` False: the call does not block, as on the CPU,
    and nothing is recorded)."""
    global _live
    if not _profiler._is_profiler_enabled:
        _live = None
        return _OFF
    return _Span(name, None, site, False) if when else _OFF


def last_session() -> Optional[Session]:
    """The newest session, or None where no span has recorded."""
    return _sessions[-1] if _sessions else None
