"""Structured event log: countable warnings and operational events.

``warnings.warn`` is for humans reading stderr; an operator needs the same
facts as *countable series*. :func:`event` records a named event into a
bounded in-memory ring and bumps ``obs_events_total{event=,level=}`` in
the metrics registry; :func:`warn` does that AND still emits the
``warnings.warn`` (the satellite contract: torn-checkpoint skips and
block-overflow regrows stay visible to ``-W error`` test rigs while
becoming queryable in the registry).

Zero-dependency and import-light on purpose: :mod:`repro.ckpt.checkpoint`
calls into here from its corruption-fallback paths.
"""
from __future__ import annotations

import threading
import time
import warnings as _warnings
from collections import deque

from . import metrics

__all__ = ["event", "warn", "recent", "clear"]

_LOCK = threading.Lock()
_EVENTS: deque[dict] = deque(maxlen=2048)


def event(name: str, message: str = "", *, level: str = "info",
          **fields) -> dict:
    """Record one structured event; returns the record."""
    rec = dict(name=str(name), level=str(level), message=str(message),
               wall_time=time.time(), **fields)
    with _LOCK:
        _EVENTS.append(rec)
    metrics.counter("obs_events_total",
                    "structured events by name and level",
                    labelnames=("event", "level")) \
        .labels(event=name, level=level).inc()
    return rec


def warn(name: str, message: str, *, category=RuntimeWarning,
         stacklevel: int = 3, **fields) -> dict:
    """A structured warning: counted + ringed via :func:`event`, then
    emitted through ``warnings.warn`` exactly as before (``stacklevel``
    defaults to 3 so the warning points at the caller of the caller —
    the site that used to call ``warnings.warn(..., stacklevel=2)``)."""
    rec = event(name, message, level="warning", **fields)
    _warnings.warn(message, category, stacklevel=stacklevel)
    return rec


def recent(n: int | None = None, *, name: str | None = None) -> list[dict]:
    """The newest events (filtered by name), oldest first."""
    with _LOCK:
        events = list(_EVENTS)
    if name is not None:
        events = [e for e in events if e["name"] == name]
    return events if n is None else events[-n:]


def clear() -> None:
    with _LOCK:
        _EVENTS.clear()
