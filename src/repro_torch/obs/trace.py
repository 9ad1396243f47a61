"""Pipeline spans, the shared span clock, and the retrace guard.

Every duration the stack reports — chunk deadlines, query latencies,
resolve walls — is measured on ONE clock: :func:`now` (``perf_counter``),
read through :class:`Span`. A :class:`Span` always measures (two ``now()``
reads), and *emits* only when a live :class:`Tracer` is installed, so
``DriverReport.chunk_durations`` and the trace file can never disagree
about the same chunk: they are the same measurement.

Device-aware timing: CUDA work is queued asynchronously, so the wall
around a launch conflates host dispatch with device compute. Calling
:meth:`Span.sync` on the result splits them — host time up to the sync
point (``dispatch_s``) vs the wait for the CUDA streams of the result's
tensors (``sync_s``) — and guarantees the span's total duration covers the
compute. CPU tensors need no wait.

One timeline with the device: while a ``torch.profiler`` records, every
:class:`Span` also opens a profiler range of its name for its lifetime (a
CPU op in kineto's trace), so the profile's device operations and the
program's spans share one trace. Sites on the hot path (a solver
step, a kernel launch) open their span through :func:`hot_span`, which
makes one only while :func:`recording` — a live tracer or a recording
profiler; otherwise the site costs one test, creates no :class:`Span` and
reads no clock.

Spans nest through a per-thread stack (each records its parent id + depth)
and are thread-safe: the async scheduler's workers each carry their own
stack, and completed spans funnel through one writer lock into a
replayable JSONL log plus an in-memory ring for the Chrome
``trace_event`` export (:meth:`Tracer.export_chrome` →
chrome://tracing / Perfetto).

:func:`retrace_guard` wraps an entry point and counts the calls that a
``jit`` would recompile for: PyTorch runs eagerly and compiles nothing, so
the guard counts each *new input signature* after the first — the shapes
and dtypes of the tensor arguments, which is what ``jit`` keys its cache
on (e.g. the known ``patch_edges`` format rebuild). It surfaces them as the
``psi_retraces_total`` counter and a structured ``retrace`` event, under
the JAX package's names.

The port of the JAX package's ``repro.obs.trace``; ``Span.sync``, the
profiler ranges, :func:`hot_span` and the guard's signature count are new.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _profiler

from . import metrics

__all__ = ["now", "Span", "Tracer", "NULL_TRACER", "get_tracer",
           "set_tracer", "span", "recording", "hot_span", "NO_SPAN",
           "retrace_guard", "RetraceGuard", "signature"]

#: the shared span clock — monotonic seconds; every instrumented duration
#: in the repo is a difference of two now() reads
now = time.perf_counter

#: the profiler range a span opens: the C++ record function, without the
#: dispatcher op that ``record_function`` enters and leaves through, whose
#: host time under the profiler would lengthen the idle gaps it names
_RANGE = torch._C._profiler._RecordFunctionFast

_TLS = threading.local()
_IDS = itertools.count(1)


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class Span:
    """One timed region. Always measures; emits only when ``tracer`` is a
    live :class:`Tracer`; while a ``torch.profiler`` records, it is also a
    profiler range of its name. Use as a context manager:

        with span("resolve", tenant="acme") as sp:
            out = solve()
            sp.sync(out)          # dispatch/compute split (optional)
        sp.duration_s             # total, on the shared clock
    """

    __slots__ = ("name", "attrs", "tracer", "t0", "t1", "dispatch_s",
                 "sync_s", "span_id", "parent_id", "depth", "thread",
                 "_range")

    def __init__(self, name: str, tracer, attrs: dict):
        self.name = name
        self.tracer = tracer
        self.attrs = attrs
        self.t0 = self.t1 = None
        self.dispatch_s = None
        self.sync_s = None
        self.span_id = next(_IDS)
        self.parent_id = None
        self.depth = 0
        self.thread = threading.current_thread().name
        self._range = None

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            self.parent_id = st[-1].span_id
            self.depth = len(st)
        st.append(self)
        if _profiler._is_profiler_enabled:
            self._range = _RANGE(self.name)
            self._range.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = now()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:                  # unbalanced exit (exception path)
            st.remove(self)
        if self.tracer is not None:
            self.tracer._finish(self, error=exc_type is not None)
        return False

    def sync(self, value):
        """Wait until the work queued for ``value``'s CUDA tensors is done
        (their devices' current streams; tensors nested in tuples, lists,
        dicts and dataclasses count; CPU tensors need no wait), recording
        the dispatch/compute split; returns ``value`` unchanged."""
        t_sync = now()
        for dev in {t.device for t in _tensors(value) if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        self.dispatch_s = t_sync - self.t0
        self.sync_s = now() - t_sync
        return value

    @property
    def duration_s(self) -> float:
        """Elapsed seconds on the shared clock (live if not yet exited)."""
        return (now() if self.t1 is None else self.t1) - self.t0


class Tracer:
    """Span sink: JSONL writer + bounded in-memory ring.

    Args:
      jsonl_path: append each completed span as one JSON line (replayable;
        None keeps spans in memory only).
      keep: ring size for :attr:`spans` / :meth:`export_chrome`.
    """

    enabled = True

    def __init__(self, jsonl_path: str | None = None, *, keep: int = 8192):
        self._lock = threading.Lock()
        self.jsonl_path = jsonl_path
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self.spans: deque[dict] = deque(maxlen=keep)
        self.t_origin = now()
        self.dropped = 0

    def span(self, name: str, **attrs) -> Span:
        return Span(name, self, attrs)

    def _finish(self, sp: Span, *, error: bool = False) -> None:
        rec = dict(name=sp.name, id=sp.span_id, parent=sp.parent_id,
                   depth=sp.depth, thread=sp.thread,
                   ts=sp.t0 - self.t_origin, dur=sp.t1 - sp.t0)
        if sp.dispatch_s is not None:
            rec["dispatch_s"] = sp.dispatch_s
            rec["sync_s"] = sp.sync_s
        if error:
            rec["error"] = True
        if sp.attrs:
            rec["attrs"] = sp.attrs
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(rec)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(rec, default=str) + "\n")
                except (TypeError, ValueError):    # unserializable attr
                    rec.pop("attrs", None)
                    self._file.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def export_chrome(self, path: str) -> str:
        """Write the retained spans as a Chrome ``trace_event`` file
        (load in chrome://tracing or https://ui.perfetto.dev)."""
        pid = os.getpid()
        with self._lock:
            spans = list(self.spans)
        events = []
        tids = {}
        for rec in spans:
            tid = tids.setdefault(rec["thread"], len(tids) + 1)
            events.append(dict(
                name=rec["name"], ph="X", pid=pid, tid=tid,
                ts=rec["ts"] * 1e6, dur=rec["dur"] * 1e6,
                args={**rec.get("attrs", {}),
                      **({"dispatch_s": rec["dispatch_s"],
                          "sync_s": rec["sync_s"]}
                         if "dispatch_s" in rec else {})}))
        meta = [dict(name="thread_name", ph="M", pid=pid, tid=t,
                     args={"name": thread}) for thread, t in tids.items()]
        with open(path, "w") as f:
            json.dump(dict(traceEvents=meta + events,
                           displayTimeUnit="ms"), f, default=str)
        return path


class _NullTracer:
    """Spans still measure (drivers consume ``duration_s``) but nothing is
    recorded — the tracing-disabled default."""

    enabled = False

    def span(self, name: str, **attrs) -> Span:
        return Span(name, None, attrs)


NULL_TRACER = _NullTracer()
_TRACER = NULL_TRACER


def get_tracer():
    return _TRACER


def set_tracer(tracer):
    """Install the process tracer (NULL_TRACER disables); returns the
    previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def span(name: str, **attrs) -> Span:
    """A span on the process tracer — the one instrumentation entry point."""
    return _TRACER.span(name, **attrs)


def recording() -> bool:
    """Whether a span would be seen: a live :class:`Tracer` is installed,
    or a ``torch.profiler`` is recording (the span's range)."""
    return _TRACER.enabled or _profiler._is_profiler_enabled


class _NoSpan:
    """What :func:`hot_span` gives while nothing records: a context that
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


NO_SPAN = _NoSpan()


def hot_span(name: str):
    """A span on the process tracer while :func:`recording`, else
    :data:`NO_SPAN`: for sites on the hot path that read nothing back from
    their span (it is ``None`` inside the ``with`` when off)."""
    return _TRACER.span(name) if recording() else NO_SPAN


def _tensors(value):
    """Every tensor in ``value``: itself, or nested in tuples, lists, dict
    values and dataclass fields, in order."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


def signature(args: tuple, kwargs: dict | None = None) -> tuple:
    """The input signature a ``jit`` cache keys on, here: the shape and
    dtype of every tensor among the arguments, in order."""
    return tuple((tuple(t.shape), t.dtype)
                 for t in _tensors((args, kwargs or {})))


# --------------------------------------------------------------------- #
# Retrace guard
# --------------------------------------------------------------------- #
class RetraceGuard:
    """Callable wrapper counting the calls a ``jit`` would recompile for.

    The first call's signature (:func:`signature`) is expected; each call
    with a signature not seen before is a retrace — typically a shape
    change from a format rebuild (the known ``patch_edges`` retrace) or a
    bucket's first solve in a loop that several buckets share. Each one
    increments ``psi_retraces_total{fn=...}`` and logs a structured
    ``retrace`` event (:mod:`repro_torch.obs.log`); a signature seen
    before counts nothing, as a ``jit`` cache hit compiles nothing.
    """

    def __init__(self, fn, name: str | None = None, *, warn: bool = True):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.warn = warn
        self.retraces = 0
        self._seen: set[tuple] = set()
        self.__name__ = f"retrace_guard({self.name})"

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        sig = signature(args, kwargs)
        if sig not in self._seen:
            self._seen.add(sig)
            size = len(self._seen)
            if size > 1:
                self.retraces += 1
                metrics.counter(
                    "psi_retraces_total",
                    "silent jit recompiles caught by retrace_guard",
                    labelnames=("fn",)).labels(fn=self.name).inc()
                from . import log
                log.event("retrace",
                          f"{self.name} called with a new input signature "
                          f"({size} seen)",
                          level="warning" if self.warn else "info",
                          fn=self.name, cache_size=size)
        return out

    def __getattr__(self, item):                   # passthrough
        return getattr(self.fn, item)


def retrace_guard(fn, name: str | None = None, *,
                  warn: bool = True) -> RetraceGuard:
    """Wrap an entry point; see :class:`RetraceGuard`."""
    return RetraceGuard(fn, name, warn=warn)
