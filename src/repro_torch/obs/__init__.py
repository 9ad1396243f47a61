"""repro_torch.obs — the planner's telemetry and calibration modules.

Copies of the JAX package's jax-free ``obs`` modules, which import only the
standard library and each other: :mod:`metrics` (counters, gauges,
histograms), :mod:`log` (structured events), :mod:`convergence` (per-resolve
records), :mod:`explain` (the planner's decision records) and
:mod:`calibrate` (the self-calibrating cost model's store, keyed here by the
engine's device and dtype). :mod:`env` is written anew from torch. The rest
of the JAX package's plane (trace, slo, watch, profile, regress, check) is
not ported yet.
"""
from __future__ import annotations

from . import calibrate, convergence, env, explain, log, metrics
from .calibrate import CalibrationStore, env_key
from .env import device_fingerprint, environment_fingerprint

__all__ = ["calibrate", "convergence", "env", "explain", "log", "metrics",
           "CalibrationStore", "env_key", "device_fingerprint",
           "environment_fingerprint"]
