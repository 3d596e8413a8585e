"""Serving: the LM ``ServeEngine``, ``GanServeEngine`` with its failure
semantics, the threaded ``AsyncGanServer`` and the SLO metrics, under the
reference's names."""
from . import metrics
from .engine import GanFuture, GanRequest, GanServeEngine, GanServeRejected, Request, ServeEngine
from .faults import CircuitBreaker, FaultPlan, GanServeError, InjectedFault
from .loop import AsyncGanServer

__all__ = [
    "AsyncGanServer",
    "CircuitBreaker",
    "FaultPlan",
    "GanFuture",
    "GanRequest",
    "GanServeEngine",
    "GanServeError",
    "GanServeRejected",
    "InjectedFault",
    "metrics",
    "Request",
    "ServeEngine",
]
