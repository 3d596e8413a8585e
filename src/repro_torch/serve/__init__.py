"""Serving: ``GanServeEngine``."""
from .engine import GanFuture, GanRequest, GanServeEngine

__all__ = ["GanFuture", "GanRequest", "GanServeEngine"]
