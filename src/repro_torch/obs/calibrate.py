"""Self-calibrating cost model: measured correction factors per regime.

The PR 2 planner ranks kernel regimes by modeled HBM bytes
(``RegimePlan.est_bytes``); its constants are TPU-HBM oriented and the
benchmark trajectory proves they mis-rank on other platforms (edge-tile
1.1s vs reference 0.13s on clustered; BSR a pathological 34s on
hyper-sparse).  This module closes the loop: every measured step timing —
microbench candidates, the auto engine's per-step wall time — is recorded
as a ``measured_us / est_bytes`` ratio ("µs per modeled byte") keyed by
``(environment, regime)``.  The per-regime **median** ratio is a
correction factor: ``est_bytes × factor(regime)`` is a calibrated µs
estimate whose *relative* ordering reflects this machine rather than the
model's constants; the **MAD** around it is the confidence band.  A
factor only participates in planning once it has ``min_samples``
observations, and regimes without a confident factor inherit the median
of the confident ones — so partial calibration can never flip a ranking
it has no evidence about.

The store is deliberately independent of :func:`repro.obs.disable`: it is
a *planner input* (control plane), not telemetry, so arming or disarming
observability can never change which plan is chosen — the bitwise-ψ
parity contract of docs/OBSERVABILITY.md survives calibration.

Persistence lives alongside the benchmark trajectory:
:meth:`CalibrationStore.save` / :meth:`CalibrationStore.load` read and
write ``CALIB_power_psi.json`` (same directory convention as
``BENCH_power_psi.json``), keyed by a reduced environment fingerprint so
a store learned on CPU never corrects a TPU plan.

In this package the environment key names the device the engine runs on and
the engine's dtype (:func:`env_key`), so a sample taken on the CPU path or
at float64 never lands under the card's float32 key. There is no implicit
default: a caller names the environment, by ``env=`` on the store or on
each call.
"""
from __future__ import annotations

import json
import statistics
import threading
from collections import deque

__all__ = ["CalibrationStore", "DEFAULT_PATH", "env_key", "get_store",
           "set_store"]

DEFAULT_PATH = "CALIB_power_psi.json"

# Median drift (relative) that republishes a factor and bumps the store
# generation — the plan cache keys on the generation, so only *material*
# recalibrations invalidate memoized plans, not every single sample.
_REPUBLISH_REL = 0.10


def env_key(device, dtype) -> str:
    """Reduced environment key: device platform / device kind / dtype.

    ``device`` is where the engine runs (``"cuda"``, ``"cuda:0"``, ``"cpu"``
    or a ``torch.device``) and ``dtype`` its working float type. Correction
    factors are per-machine-class facts, so the volatile fingerprint fields
    (timestamp, git sha) stay out of the key.
    """
    from .env import device_fingerprint
    fp = device_fingerprint(device)
    return "|".join((str(fp["device_platform"]), str(fp["device_kind"]),
                     str(dtype).removeprefix("torch.")))


class CalibrationStore:
    """Per-(environment, regime) µs-per-modeled-byte correction factors."""

    def __init__(self, *, keep: int = 64, min_samples: int = 2,
                 env: str | None = None):
        self._lock = threading.Lock()
        self._samples: dict[tuple[str, str], deque] = {}
        self._published: dict[tuple[str, str], float] = {}
        self.keep = int(keep)
        self.min_samples = int(min_samples)
        self.generation = 0
        self._env = env

    @property
    def env(self) -> str:
        if self._env is None:
            raise ValueError("no calibration environment: pass env=env_key("
                             "device, dtype) to the store or to the call")
        return self._env

    # -- feeding ------------------------------------------------------- #
    def observe(self, regime: str, est_bytes: float, measured_us: float,
                *, env: str | None = None,
                source: str = "run") -> float | None:
        """Record one (modeled bytes, measured µs) pair; returns the ratio.

        Samples with a non-positive model estimate or measurement carry no
        information and are dropped.
        """
        est_bytes = float(est_bytes)
        measured_us = float(measured_us)
        if est_bytes <= 0.0 or measured_us <= 0.0:
            return None
        ratio = measured_us / est_bytes
        key = (env or self.env, str(regime))
        with self._lock:
            ring = self._samples.get(key)
            if ring is None:
                ring = self._samples[key] = deque(maxlen=self.keep)
            ring.append(ratio)
            if len(ring) >= self.min_samples:
                med = statistics.median(ring)
                old = self._published.get(key)
                if old is None or abs(med / old - 1.0) > _REPUBLISH_REL:
                    self._published[key] = med
                    self.generation += 1
        return ratio

    # -- querying ------------------------------------------------------ #
    def factor(self, regime: str, *, env: str | None = None) -> dict | None:
        """``{"median", "mad", "count"}`` for one regime, or ``None``
        until ``min_samples`` observations exist."""
        key = (env or self.env, str(regime))
        with self._lock:
            ring = self._samples.get(key)
            if ring is None or len(ring) < self.min_samples:
                return None
            xs = list(ring)
        med = statistics.median(xs)
        mad = statistics.median(abs(x - med) for x in xs)
        return {"median": med, "mad": mad, "count": len(xs)}

    def factors(self, *, env: str | None = None) -> dict[str, dict]:
        """Every confident regime factor for one environment."""
        env = env or self.env
        with self._lock:
            regimes = sorted({r for (e, r) in self._samples if e == env})
        out = {}
        for regime in regimes:
            f = self.factor(regime, env=env)
            if f is not None:
                out[regime] = f
        return out

    def multipliers(self, regimes, *, env: str | None = None) -> dict:
        """Cost multipliers for a candidate-regime set.

        Empty when no regime is confident (plain ``est_bytes`` ranking).
        Otherwise every requested regime gets its own median factor if
        confident, else the median of the confident factors — a uniform
        default that cannot flip rankings between uncalibrated regimes.
        """
        known = self.factors(env=env)
        if not known:
            return {}
        default = statistics.median(f["median"] for f in known.values())
        return {r: known[r]["median"] if r in known else default
                for r in regimes}

    def corrected_us(self, regime: str, est_bytes: float,
                     *, env: str | None = None) -> float | None:
        """Calibrated µs estimate for one plan, or ``None`` if unknown."""
        f = self.factor(regime, env=env)
        return None if f is None else float(est_bytes) * f["median"]

    # -- persistence --------------------------------------------------- #
    def to_json(self) -> dict:
        with self._lock:
            keys = sorted(self._samples)
            samples = {k: list(self._samples[k]) for k in keys}
        entries = []
        for (env, regime) in keys:
            xs = samples[(env, regime)]
            med = statistics.median(xs)
            entries.append({
                "env": env, "regime": regime, "samples": xs,
                "median": med,
                "mad": statistics.median(abs(x - med) for x in xs),
                "count": len(xs),
            })
        return {"version": 1, "keep": self.keep,
                "min_samples": self.min_samples, "entries": entries}

    def save(self, path: str = DEFAULT_PATH) -> dict:
        snap = self.to_json()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1)
        return snap

    def load(self, path: str = DEFAULT_PATH) -> int:
        """Merge persisted samples into this store; returns entries read.

        Missing files are not an error — a fresh machine simply starts
        uncalibrated.
        """
        try:
            with open(path) as f:
                snap = json.load(f)
        except FileNotFoundError:
            return 0
        n = 0
        for e in snap.get("entries", ()):
            key = (str(e["env"]), str(e["regime"]))
            with self._lock:
                ring = self._samples.get(key)
                if ring is None:
                    ring = self._samples[key] = deque(maxlen=self.keep)
                for x in e.get("samples", ()):
                    ring.append(float(x))
                if len(ring) >= self.min_samples:
                    self._published[key] = statistics.median(ring)
                self.generation += 1
            n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._samples.clear()
            self._published.clear()
            self.generation += 1

    def __len__(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._samples.values())


_STORE = CalibrationStore()


def get_store() -> CalibrationStore:
    return _STORE


def set_store(store: CalibrationStore) -> CalibrationStore:
    """Install the process store; returns the previous one."""
    global _STORE
    prev, _STORE = _STORE, store
    return prev
