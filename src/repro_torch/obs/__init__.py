"""repro_torch.obs — the telemetry plane: metrics, spans, convergence
records, the planner's decisions and its calibration store, behind one
switchboard.

Copies of the JAX package's jax-free ``obs`` modules, which import only the
standard library and each other: :mod:`metrics` (counters, gauges,
histograms; ``NullRegistry`` when disabled), :mod:`log` (structured
events), :mod:`convergence` (per-resolve records), :mod:`explain` (the
planner's decision records) and :mod:`calibrate` (the self-calibrating cost
model's store, keyed here by the engine's device and dtype). :mod:`env` is
written anew from torch, and :mod:`trace` (spans on one clock, the JSONL /
Chrome export and the retrace guard) is ported with a CUDA-stream
``Span.sync`` and a guard that counts new input signatures.

The analysis-and-control layer on top, also copies: :mod:`slo`
(declarative SLOs, error budgets, multi-window burn-rate alerts, served at
``/slo``), :mod:`profile` (folded stacks, the dispatch/sync split,
the async critical path), :mod:`watch` (online convergence anomaly
detection feeding pre-emptive advice into the resilience ladder) and
:mod:`regress` (the noise-aware gate over ``BENCH_power_psi.json``;
``python -m repro_torch.obs.regress``). ``python -m repro_torch.obs.check``
self-tests the plane end to end.

Instrumentation sites call the cheap module-level helpers
(``metrics.counter(...)``, ``trace.span(...)``, ``convergence``'s tracker);
:func:`configure` swaps the process sinks behind them. The default state is
the JAX package's: metrics ON (host-side Python, no device syncs), the
convergence tracker ON in its bounded in-memory form, the tracer null —
:func:`disable` swaps every sink for its null twin so the hot path costs
one attribute read and a no-op call.
"""
from __future__ import annotations

import json as _json

from . import (calibrate, convergence, env, explain, log, metrics, profile,
               slo, trace, watch)
from .calibrate import CalibrationStore, env_key
from .convergence import NULL_TRACKER, ConvergenceTracker
from .env import device_fingerprint, environment_fingerprint
from .explain import NULL_DECISIONS, DecisionLog, DecisionRecord
from .metrics import MetricsRegistry, NullRegistry, start_http_server
from .profile import Profile
from .slo import SLO, SLOEngine, default_slos
from .trace import NULL_TRACER, Span, Tracer, retrace_guard, span
from .watch import ConvergenceWatch

__all__ = ["calibrate", "convergence", "env", "explain", "log", "metrics",
           "trace", "CalibrationStore", "env_key", "ConvergenceTracker",
           "NULL_TRACKER", "device_fingerprint", "environment_fingerprint",
           "DecisionLog", "DecisionRecord", "NULL_DECISIONS",
           "MetricsRegistry", "NullRegistry", "start_http_server",
           "NULL_TRACER", "Span", "Tracer", "retrace_guard", "span",
           "slo", "profile", "watch", "regress", "SLO", "SLOEngine",
           "default_slos", "Profile", "ConvergenceWatch",
           "configure", "disable", "restore", "enabled", "dump"]


def __getattr__(name):
    # lazy: regress is a CLI module; importing it eagerly would trip the
    # runpy double-import warning under `python -m repro_torch.obs.regress`
    # (``importlib``, not ``from . import regress``: that form asks this
    # hook for the name again and recurses, as the JAX package's does)
    if name == "regress":
        import importlib
        return importlib.import_module(f"{__name__}.regress")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enabled() -> bool:
    """True when the metrics plane is live (not the NullRegistry)."""
    return metrics.enabled()


def configure(*, registry: MetricsRegistry | None = None,
              trace_out: str | None = None,
              tracer: Tracer | None = None,
              tracker: ConvergenceTracker | None = None,
              decisions: DecisionLog | None = None) -> dict:
    """Install fresh sinks; returns the previous ones (for restoring).

    ``trace_out`` is a convenience: a path builds ``Tracer(trace_out)``.
    """
    prev = {"registry": metrics.get_registry(),
            "tracer": trace.get_tracer(),
            "tracker": convergence.get_tracker(),
            "decisions": explain.get_log()}
    if registry is not None:
        metrics.set_registry(registry)
    if tracer is None and trace_out is not None:
        tracer = Tracer(trace_out)
    if tracer is not None:
        trace.set_tracer(tracer)
    if tracker is not None:
        convergence.set_tracker(tracker)
    if decisions is not None:
        explain.set_log(decisions)
    return prev


def disable() -> dict:
    """Swap every sink for its null twin (one-branch hot path); returns
    the previous sinks so callers can restore them.

    The calibration store is *not* a sink: it is a planner input, so the
    plan chosen with observability disabled matches the instrumented one.
    """
    return configure(registry=NullRegistry(), tracer=NULL_TRACER,
                     tracker=NULL_TRACKER, decisions=NULL_DECISIONS)


def restore(prev: dict) -> None:
    """Undo a :func:`configure`/:func:`disable` using its return value."""
    metrics.set_registry(prev["registry"])
    trace.set_tracer(prev["tracer"])
    convergence.set_tracker(prev["tracker"])
    if "decisions" in prev:
        explain.set_log(prev["decisions"])


def dump(path: str | None = None, *, device=None, dtype=None) -> dict:
    """One self-describing snapshot: fingerprint + metrics + convergence
    trajectories (+ recent structured events, decisions, calibration).
    Optionally written to ``path`` as JSON.

    The fingerprint is the port's :func:`environment_fingerprint` of
    ``device`` (default: the card when one is present, else the CPU), with
    the working ``dtype`` beside it when given (the JAX package records
    its x64 flag there)."""
    fingerprint = environment_fingerprint(device)
    if dtype is not None:
        fingerprint["dtype"] = str(dtype).replace("torch.", "")
    snap = {
        "fingerprint": fingerprint,
        "metrics": metrics.get_registry().to_json(),
        "convergence": convergence.get_tracker().to_json(),
        "events": log.recent(200),
        "decisions": explain.get_log().to_json(),
        "calibration": calibrate.get_store().to_json(),
    }
    if path is not None:
        with open(path, "w") as f:
            _json.dump(snap, f, indent=1, default=str)
    return snap
