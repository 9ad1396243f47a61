"""Per-resolve gap/certificate trajectory recorder.

Answers "is the certificate bound tightening?" without adding host syncs:
only gaps a layer *already* reads on the host are recorded — chunk-loop
gaps (``distributed`` engine, the sync/async drivers), the push solver's
per-round raw gap and Neumann-tail certificate, and every resolve's final
(iterations, gap, converged) endpoint. Fully on-device loops (reference /
pallas ``lax.while_loop``) contribute their endpoint only: forcing their
intermediate gaps to the host would change the execution being measured.

One :class:`ResolveRecord` is opened per resolve (engine ``run``, driver
``run``, fleet ``solve``) on a per-thread stack, so nested resolves (a
supervisor's sync-sweep rung inside a supervised resolve) attribute their
points to the innermost record. Completed records land in per-tenant ring
buffers, queryable as a time series via :meth:`ConvergenceTracker.series`
and exported inside ``repro.obs.dump()``.

Each finish also feeds the metrics registry (``psi_resolves_total``,
``psi_resolve_seconds``, ``psi_resolve_iterations``, ``psi_resolve_gap``),
and Aitken jump accept/reject lands in ``psi_aitken_jumps_total{outcome=}``
— so the registry dump alone answers the coarse questions and the
trajectory answers the per-resolve one.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque

from . import metrics

__all__ = ["ResolveRecord", "ConvergenceTracker", "get_tracker",
           "set_tracker", "begin", "finish", "record_gap", "record_aitken",
           "record_push", "current"]

_TLS = threading.local()


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class ResolveRecord:
    """One resolve's trajectory (see module docstring)."""

    __slots__ = ("backend", "tenant", "index", "wall_start", "points",
                 "points_dropped", "aitken_accepted", "aitken_rejected",
                 "push", "iterations", "gap", "converged", "duration_s",
                 "psi_error_bound", "_max_points")

    def __init__(self, backend: str, tenant, index: int, max_points: int):
        self.backend = backend
        self.tenant = tenant
        self.index = index
        self.wall_start = time.time()
        self.points: list[dict] = []
        self.points_dropped = 0
        self.aitken_accepted = 0
        self.aitken_rejected = 0
        self.push: dict | None = None
        self.iterations = 0
        self.gap = math.nan
        self.converged: bool | None = None
        self.duration_s = 0.0
        self.psi_error_bound: float | None = None
        self._max_points = max_points

    def add_point(self, t: int, raw=None, certified=None) -> None:
        if len(self.points) >= self._max_points:
            self.points_dropped += 1
            return
        p: dict = {"t": int(t)}
        if raw is not None:
            p["raw"] = float(raw)
        if certified is not None:
            p["certified"] = float(certified)
        self.points.append(p)

    def to_json(self) -> dict:
        out = dict(backend=self.backend, tenant=self.tenant,
                   index=self.index, wall_start=self.wall_start,
                   iterations=self.iterations, gap=self.gap,
                   converged=self.converged, duration_s=self.duration_s,
                   points=self.points)
        if self.points_dropped:
            out["points_dropped"] = self.points_dropped
        if self.aitken_accepted or self.aitken_rejected:
            out["aitken_accepted"] = self.aitken_accepted
            out["aitken_rejected"] = self.aitken_rejected
        if self.push is not None:
            out["push"] = self.push
        if self.psi_error_bound is not None:
            out["psi_error_bound"] = self.psi_error_bound
        return out


class ConvergenceTracker:
    """Per-tenant ring buffers of completed :class:`ResolveRecord`\\ s."""

    enabled = True

    def __init__(self, *, keep: int = 256, max_points: int = 4096):
        self._lock = threading.Lock()
        self._series: dict = {}
        self.keep = int(keep)
        self.max_points = int(max_points)
        self._count = 0
        self._subscribers: list = []

    def subscribe(self, fn):
        """Call ``fn(record)`` after every finished resolve — the hook
        :class:`repro.obs.watch.ConvergenceWatch` rides on. Returns
        ``fn`` so it can be passed back to :meth:`unsubscribe`."""
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def begin(self, backend: str, tenant=None) -> ResolveRecord:
        with self._lock:
            self._count += 1
            idx = self._count
        rec = ResolveRecord(backend, tenant, idx, self.max_points)
        _stack().append(rec)
        return rec

    def finish(self, rec: ResolveRecord, *, iterations=None, gap=None,
               converged=None, duration_s=None,
               psi_error_bound=None) -> ResolveRecord:
        st = _stack()
        if rec in st:
            st.remove(rec)
        if iterations is not None:
            rec.iterations = int(iterations)
        if gap is not None:
            rec.gap = float(gap)
        if converged is not None:
            rec.converged = bool(converged)
        if duration_s is not None:
            rec.duration_s = float(duration_s)
        if psi_error_bound is not None:
            rec.psi_error_bound = float(psi_error_bound)
        key = rec.tenant if rec.tenant is not None else "_default"
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = deque(maxlen=self.keep)
            ring.append(rec)
        metrics.counter("psi_resolves_total", "resolves by backend",
                        labelnames=("backend",)) \
            .labels(backend=rec.backend).inc()
        metrics.histogram("psi_resolve_seconds", "resolve wall seconds",
                          labelnames=("backend",)) \
            .labels(backend=rec.backend).observe(rec.duration_s)
        metrics.histogram(
            "psi_resolve_iterations", "iterations per resolve",
            labelnames=("backend",),
            buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500,
                     1000, 2000, 5000)) \
            .labels(backend=rec.backend).observe(rec.iterations)
        if math.isfinite(rec.gap):
            metrics.gauge("psi_resolve_gap",
                          "final Eq. 19 gap of the last resolve",
                          labelnames=("backend",)) \
                .labels(backend=rec.backend).set(rec.gap)
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(rec)
            except Exception as exc:   # a broken observer must not fail
                from . import log     # the resolve it observes
                log.event("convergence_subscriber_error", str(exc),
                          level="error", backend=rec.backend)
        return rec

    def series(self, tenant=None) -> list[ResolveRecord]:
        key = tenant if tenant is not None else "_default"
        with self._lock:
            return list(self._series.get(key, ()))

    def tenants(self) -> list:
        with self._lock:
            return sorted(self._series, key=str)

    def to_json(self) -> dict:
        with self._lock:
            items = {str(k): [r.to_json() for r in ring]
                     for k, ring in self._series.items()}
        return items

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._count = 0


class _NullTracker:
    enabled = False

    def begin(self, backend, tenant=None):
        return None

    def finish(self, rec, **kw):
        return rec

    def subscribe(self, fn):
        return fn

    def unsubscribe(self, fn):
        pass

    def series(self, tenant=None):
        return []

    def tenants(self):
        return []

    def to_json(self):
        return {}

    def reset(self):
        pass


NULL_TRACKER = _NullTracker()
_TRACKER = ConvergenceTracker()


def get_tracker():
    return _TRACKER


def set_tracker(tracker):
    """Install the process tracker (NULL_TRACKER disables); returns the
    previous one."""
    global _TRACKER
    prev, _TRACKER = _TRACKER, tracker
    return prev


# -- instrumentation-site API (cheap no-ops when nothing is active) ----- #
def begin(backend: str, tenant=None):
    return _TRACKER.begin(backend, tenant)


def finish(rec, **kw):
    if rec is not None:
        _TRACKER.finish(rec, **kw)
    return rec


def current() -> ResolveRecord | None:
    """The innermost open resolve record on this thread, if any."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def record_gap(t: int, raw=None, certified=None) -> None:
    """Attach one host-visible gap sample to the current resolve."""
    st = getattr(_TLS, "stack", None)
    if st:
        st[-1].add_point(t, raw=raw, certified=certified)


def record_aitken(accepted: bool) -> None:
    """Count one Aitken jump decision (chunk-level extrapolation)."""
    st = getattr(_TLS, "stack", None)
    if st:
        rec = st[-1]
        if accepted:
            rec.aitken_accepted += 1
        else:
            rec.aitken_rejected += 1
    metrics.counter("psi_aitken_jumps_total",
                    "chunk-level Aitken jumps by outcome",
                    labelnames=("outcome",)) \
        .labels(outcome="accepted" if accepted else "rejected").inc()


def record_push(**stats) -> None:
    """Attach the push solver's run stats (edge_work, cert_edge_work, ...)
    to the current resolve and mirror the work counters to the registry."""
    st = getattr(_TLS, "stack", None)
    if st:
        st[-1].push = {k: (float(v) if isinstance(v, float) else v)
                       for k, v in stats.items()}
    for key in ("edge_work", "cert_edge_work"):
        if stats.get(key):
            metrics.counter(f"psi_push_{key}_total",
                            f"cumulative push {key}").inc(float(stats[key]))
