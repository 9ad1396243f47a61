"""Process-wide metrics registry: counters, gauges, histograms.

Zero-dependency (stdlib only) so every layer of the stack can import it —
including :mod:`repro.ckpt`, which must not drag jax into its error paths.
One :class:`MetricsRegistry` holds named metric *families*; a family plus a
label set yields a *child* carrying the actual value. All mutation goes
through one registry lock, so the async scheduler's worker threads and the
main serving thread can increment concurrently (the lock is held for a few
instructions per op; see tests/test_obs.py's thread-safety case).

Exposition:

* :meth:`MetricsRegistry.to_prometheus` — the Prometheus text format
  (``# HELP`` / ``# TYPE`` + one sample line per child; histograms expand
  to cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``).
* :meth:`MetricsRegistry.to_json` — a structured dump including histogram
  quantile estimates (p50/p90/p99 by linear interpolation inside the
  bucket the quantile falls in).
* :func:`start_http_server` — a stdlib ``http.server`` thread exposing
  ``/metrics`` (text) and ``/metrics.json`` for ``serve --metrics-port``.

Disabling: :func:`set_registry(NULL_REGISTRY)` swaps in a
:class:`NullRegistry` whose families and children are shared no-op
singletons — an instrumented hot path then costs one attribute access and
one no-op call per sample, and (critically) touches no locks and allocates
nothing, which is what the bitwise-parity contract of the observability
plane rests on (instrumentation only ever *reads* host-side values).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time

__all__ = ["MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
           "get_registry", "set_registry", "counter", "gauge", "histogram",
           "enabled", "start_http_server", "set_slo_provider",
           "DEFAULT_BUCKETS"]

#: log-spaced seconds buckets: 10 µs → 60 s (query latencies through
#: full chaos-drill resolves land inside the measurable range)
DEFAULT_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
                   1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


# --------------------------------------------------------------------- #
# The disabled path: shared no-op singletons
# --------------------------------------------------------------------- #
class _Null:
    """Both the no-op family and the no-op child (labels() returns self)."""

    __slots__ = ()

    def labels(self, **kw):
        return self

    def inc(self, amount=1.0):
        pass

    def dec(self, amount=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0.0

    def quantile(self, q):
        return 0.0


_NULL = _Null()


class NullRegistry:
    """API-compatible no-op registry (see module docstring)."""

    null = True

    def counter(self, name, help="", labelnames=()):
        return _NULL

    def gauge(self, name, help="", labelnames=()):
        return _NULL

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return _NULL

    def get(self, name):
        return None

    def value(self, name, **labels):
        return None

    def to_prometheus(self) -> str:
        return ""

    def to_json(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_REGISTRY = NullRegistry()


# --------------------------------------------------------------------- #
# Live children
# --------------------------------------------------------------------- #
class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0; got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount=1.0):
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "_min", "_max")

    def __init__(self, lock, bounds):
        self._lock = lock
        self.bounds = bounds                       # sorted finite uppers
        self.counts = [0] * (len(bounds) + 1)      # + the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value):
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        """Histograms expose their observation count as the scalar value."""
        return float(self.count)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile: linear interpolation inside the bucket the
        quantile falls in (exact min/max tighten the edge buckets)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            target = q * total
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= target and c:
                    hi = (self._max if i == len(self.bounds)
                          else min(self.bounds[i], self._max))
                    lo = (self._min if i == 0
                          else max(self.bounds[i - 1], self._min))
                    frac = (target - (cum - c)) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return self._max


# --------------------------------------------------------------------- #
# Families
# --------------------------------------------------------------------- #
class _Family:
    kind = "untyped"

    def __init__(self, name, help, labelnames, lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple, object] = {}

    def _make_child(self):                         # pragma: no cover
        raise NotImplementedError

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}; "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    # label-less families act as their own single child
    def inc(self, amount=1.0):
        self.labels().inc(amount)

    def dec(self, amount=1.0):
        self.labels().dec(amount)

    def set(self, value):
        self.labels().set(value)

    def observe(self, value):
        self.labels().observe(value)

    def quantile(self, q):
        return self.labels().quantile(q)

    @property
    def value(self):
        return self.labels().value

    def children(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterFamily(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)


class _GaugeFamily(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)


class _HistogramFamily(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def merged(self) -> _HistogramChild:
        """One child pooling every label combination — for summary readouts
        (e.g. query p99 across all ops). Children share bucket bounds, so
        pooling is exact at bucket resolution."""
        pooled = _HistogramChild(self._lock, self.buckets)
        with self._lock:
            for ch in self._children.values():
                pooled.counts = [a + b for a, b
                                 in zip(pooled.counts, ch.counts)]
                pooled.sum += ch.sum
                pooled.count += ch.count
                pooled._min = min(pooled._min, ch._min)
                pooled._max = max(pooled._max, ch._max)
        return pooled


# --------------------------------------------------------------------- #
# The registry
# --------------------------------------------------------------------- #
def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral values render without a
    decimal point, everything else via repr (shortest round-trip)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labelnames, key, extra=()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(labelnames, key)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


class MetricsRegistry:
    """One process-wide namespace of metric families (see module docstring).

    Families are created on first use and idempotent thereafter:
    re-declaring a name with the same kind + labelnames returns the
    existing family; a conflicting re-declaration raises.
    """

    null = False

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _family(self, cls, name, help, labelnames, **kw):
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = cls(name, help, labelnames, self._lock, **kw)
                    self._families[name] = fam
        if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}; cannot re-register as "
                f"{cls.kind} with labels {tuple(labelnames)}")
        return fam

    def counter(self, name, help="", labelnames=()):
        return self._family(_CounterFamily, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._family(_GaugeFamily, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS):
        return self._family(_HistogramFamily, name, help, labelnames,
                            buckets=buckets)

    def get(self, name):
        return self._families.get(name)

    def value(self, name, **labels):
        """Scalar read for tests / self-checks; None when absent."""
        fam = self._families.get(name)
        if fam is None:
            return None
        try:
            return fam.labels(**labels).value
        except (ValueError, KeyError):
            return None

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exposition ----------------------------------------------------- #
    def to_prometheus(self) -> str:
        lines = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.children():
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(fam.buckets, child.counts):
                        cum += c
                        lab = _label_str(fam.labelnames, key,
                                         extra=[("le", _fmt(b))])
                        lines.append(f"{name}_bucket{lab} {cum}")
                    cum += child.counts[-1]
                    lab = _label_str(fam.labelnames, key,
                                     extra=[("le", "+Inf")])
                    lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _label_str(fam.labelnames, key)
                    lines.append(f"{name}_sum{lab} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{lab} {child.count}")
                else:
                    lab = _label_str(fam.labelnames, key)
                    lines.append(f"{name}{lab} {_fmt(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        out = {}
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            series = []
            for key, child in fam.children():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    series.append(dict(
                        labels=labels, count=child.count, sum=child.sum,
                        min=(None if child.count == 0 else child._min),
                        max=(None if child.count == 0 else child._max),
                        p50=child.quantile(0.50), p90=child.quantile(0.90),
                        p99=child.quantile(0.99),
                        buckets={_fmt(b): c for b, c in
                                 zip(fam.buckets, child.counts)},
                        overflow=child.counts[-1]))
                else:
                    series.append(dict(labels=labels, value=child.value))
            out[name] = dict(kind=fam.kind, help=fam.help, series=series)
        return out


# --------------------------------------------------------------------- #
# Process default + module-level convenience (the instrumentation API)
# --------------------------------------------------------------------- #
_REGISTRY = MetricsRegistry()


def get_registry():
    return _REGISTRY


def set_registry(registry):
    """Swap the process default (e.g. for NULL_REGISTRY); returns the
    previous one so callers can restore it."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, registry
    return prev


def enabled() -> bool:
    return not getattr(_REGISTRY, "null", False)


def counter(name, help="", labelnames=()):
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return _REGISTRY.histogram(name, help, labelnames, buckets=buckets)


# --------------------------------------------------------------------- #
# /metrics over HTTP (serve --metrics-port)
# --------------------------------------------------------------------- #
_START_TIME = time.time()
_SLO_PROVIDER = None


def set_slo_provider(fn):
    """Install the callable the HTTP ``/slo`` endpoint serves (an
    ``SLOEngine.report``); None uninstalls. Returns the previous one."""
    global _SLO_PROVIDER
    prev, _SLO_PROVIDER = _SLO_PROVIDER, fn
    return prev


def start_http_server(port: int, registry=None, host: str = "127.0.0.1"):
    """Expose ``/metrics`` (Prometheus text), ``/metrics.json``,
    ``/healthz`` (cheap liveness for fleet probes) and ``/slo`` (verdicts
    of the installed :class:`repro.obs.slo.SLOEngine`) on a daemon
    thread; returns the server (``.shutdown()`` to stop; pass port 0 for
    an ephemeral port, read back via ``server.server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            r = reg if reg is not None else get_registry()
            if self.path.rstrip("/") in ("", "/metrics"):
                body = r.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path == "/metrics.json":
                body = json.dumps(r.to_json(), indent=1).encode()
                ctype = "application/json"
            elif self.path.rstrip("/") == "/healthz":
                body = json.dumps(dict(
                    status="ok",
                    uptime_s=round(time.time() - _START_TIME, 3),
                    metrics_enabled=not getattr(r, "null", False),
                    slo_installed=_SLO_PROVIDER is not None)).encode()
                ctype = "application/json"
            elif self.path.rstrip("/") == "/slo":
                if _SLO_PROVIDER is None:
                    body = json.dumps(
                        dict(error="no SLO engine installed")).encode()
                    self.send_response(404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = json.dumps(_SLO_PROVIDER(), indent=1).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                 # quiet
            pass

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    t = threading.Thread(target=server.serve_forever,
                         name="obs-metrics-http", daemon=True)
    t.start()
    return server
