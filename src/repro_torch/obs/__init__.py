"""repro_torch.obs — the planner's telemetry and calibration modules.

Copies of the JAX package's jax-free ``obs`` modules, which import only the
standard library and each other: :mod:`metrics` (counters, gauges,
histograms), :mod:`log` (structured events), :mod:`convergence` (per-resolve
records), :mod:`explain` (the planner's decision records) and
:mod:`calibrate` (the self-calibrating cost model's store, keyed here by the
engine's device and dtype). :mod:`env` is written anew from torch, and
:mod:`trace` (spans on one clock, the JSONL / Chrome export and the retrace
guard) is ported with a CUDA-stream ``Span.sync`` and a guard that counts
new input signatures. The rest of the JAX package's plane (the
``configure`` / ``disable`` / ``dump`` switchboard, slo, watch, profile,
regress, check) is not ported yet.
"""
from __future__ import annotations

from . import calibrate, convergence, env, explain, log, metrics, trace
from .calibrate import CalibrationStore, env_key
from .env import device_fingerprint, environment_fingerprint
from .trace import NULL_TRACER, Span, Tracer, retrace_guard, span

__all__ = ["calibrate", "convergence", "env", "explain", "log", "metrics",
           "trace", "CalibrationStore", "env_key", "device_fingerprint",
           "environment_fingerprint", "NULL_TRACER", "Span", "Tracer",
           "retrace_guard", "span"]
