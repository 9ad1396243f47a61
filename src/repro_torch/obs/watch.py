"""Online convergence anomaly detection — the pre-emptive control signal.

The resilience sentinels (:mod:`repro_torch.resilience.health`) are *tripwires*:
they fire when a run has already gone wrong (α ≥ 1, gap growing, a
certificate storm in a finished report). :class:`ConvergenceWatch` sits
upstream, watching the same host-visible evidence as it accumulates —
finished :class:`~repro_torch.obs.convergence.ResolveRecord` trajectories, async
driver reports, contraction-modulus readings — and projects *trends*, so
the :class:`~repro_torch.resilience.supervisor.ResilientResolver` can tighten τ
or schedule a verification sweep **before** a sentinel trips.

Detectors (each emits a :class:`WatchSignal`, counts
``psi_watch_signals_total{kind}`` and logs a ``watch_anomaly`` event):

* ``rho_drift`` — the per-resolve contraction estimate (median ratio of
  consecutive gap samples) drifting above its baseline, or past
  ``rho_cap``: convergence is stalling geometrically.
* ``gap_plateau`` — a large fraction of non-decreasing steps inside one
  trajectory: the iteration is treading water.
* ``aitken_shift`` — the chunk extrapolator's rejection rate jumping
  over its baseline: the iterate sequence stopped looking geometric.
* ``cert_storm_onset`` — rejected stale-corrected certificates in one
  async run reaching ``storm_frac`` of the sentinel's storm threshold:
  τ is too loose for the current epoch spread. Advice: tighten τ.
* ``alpha_drift`` — α measurements trending toward ``alpha_max``; the
  linear projection crosses the wall within ``alpha_horizon`` steps.
* ``attempt_failure`` — a timeout/fault observed by the supervisor;
  repeated attempts are unlikely to behave differently. Advice: sweep.

Advice is *latched*: :meth:`ConvergenceWatch.consume_advice` hands the
pending recommendation to the resolver exactly once and re-arms, so one
anomaly causes one pre-emption, not a pre-emption per resolve forever.
"""
from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from collections import deque
from typing import Optional

from . import convergence as obs_convergence
from . import log as obs_log
from . import metrics as obs_metrics

__all__ = ["ConvergenceWatch", "WatchSignal", "WatchAdvice"]

#: signal kinds that recommend tightening τ (re-chunk to synchronous
#: epochs) vs scheduling a full verification sweep
_TIGHTEN_TAU = frozenset({"cert_storm_onset"})
_SYNC_SWEEP = frozenset({"rho_drift", "gap_plateau", "aitken_shift",
                         "alpha_drift", "attempt_failure"})


@dataclasses.dataclass(frozen=True)
class WatchSignal:
    kind: str
    value: float
    detail: str
    wall_time: float


@dataclasses.dataclass(frozen=True)
class WatchAdvice:
    """What the ladder should do before its next attempt."""
    tighten_tau: bool
    sync_sweep: bool
    reasons: tuple

    def __bool__(self) -> bool:
        return self.tighten_tau or self.sync_sweep


class ConvergenceWatch:
    """Online anomaly detector over the convergence stream (see module
    docstring). Thread-safe: resolves may finish on worker threads."""

    def __init__(self, *,
                 baseline: int = 5,
                 rho_drift: float = 0.05,
                 rho_cap: float = 0.985,
                 plateau_frac: float = 0.6,
                 plateau_min_points: int = 6,
                 aitken_shift: float = 0.35,
                 aitken_min_jumps: int = 4,
                 storm_frac: float = 0.5,
                 cert_storm: int = 50,
                 alpha_max: float = 1.0,
                 alpha_horizon: int = 3,
                 history: int = 128):
        self.baseline = int(baseline)
        self.rho_drift = float(rho_drift)
        self.rho_cap = float(rho_cap)
        self.plateau_frac = float(plateau_frac)
        self.plateau_min_points = int(plateau_min_points)
        self.aitken_shift = float(aitken_shift)
        self.aitken_min_jumps = int(aitken_min_jumps)
        self.storm_frac = float(storm_frac)
        self.cert_storm = int(cert_storm)
        self.alpha_max = float(alpha_max)
        self.alpha_horizon = int(alpha_horizon)

        self._lock = threading.Lock()
        self._rho_baseline: list = []
        self._aitken_baseline: list = []
        self._alphas: deque = deque(maxlen=16)
        self.signals: deque = deque(maxlen=history)
        self._pending: dict = {"tighten_tau": False, "sync_sweep": False,
                               "reasons": []}
        self._tracker = None
        self._hook = None

    # -- attach to the convergence stream -------------------------------- #
    def attach(self, tracker=None) -> "ConvergenceWatch":
        """Subscribe to finished resolves on ``tracker`` (default: the
        process tracker). Idempotent per tracker."""
        self.detach()
        self._tracker = (tracker if tracker is not None
                         else obs_convergence.get_tracker())
        self._hook = self._tracker.subscribe(self.observe_record)
        return self

    def detach(self) -> None:
        if self._tracker is not None and self._hook is not None:
            self._tracker.unsubscribe(self._hook)
        self._tracker = self._hook = None

    # -- detectors -------------------------------------------------------- #
    def observe_record(self, rec) -> None:
        """Digest one finished resolve trajectory."""
        values = [p.get("raw", p.get("certified"))
                  for p in getattr(rec, "points", ())]
        values = [v for v in values if v is not None and v > 0.0]
        self._check_rho(values, rec)
        self._check_plateau(values, rec)
        self._check_aitken(rec)

    def _check_rho(self, values, rec) -> None:
        if len(values) < 3:
            return
        ratios = [b / a for a, b in zip(values, values[1:])
                  if a > 0.0 and 0.0 < b / a < 10.0]
        if not ratios:
            return
        rho = min(max(statistics.median(ratios), 0.0), 10.0)
        with self._lock:
            if len(self._rho_baseline) < self.baseline:
                self._rho_baseline.append(rho)
                return
            base = statistics.median(self._rho_baseline)
        if rho >= self.rho_cap or rho - base > self.rho_drift:
            self._signal(
                "rho_drift", rho,
                f"contraction estimate {rho:.4f} vs baseline {base:.4f} "
                f"(backend {rec.backend})")

    def _check_plateau(self, values, rec) -> None:
        if len(values) < self.plateau_min_points:
            return
        flat = sum(1 for a, b in zip(values, values[1:]) if b >= a)
        frac = flat / (len(values) - 1)
        if frac >= self.plateau_frac:
            self._signal(
                "gap_plateau", frac,
                f"{flat}/{len(values) - 1} non-decreasing gap steps "
                f"(backend {rec.backend})")

    def _check_aitken(self, rec) -> None:
        acc = getattr(rec, "aitken_accepted", 0)
        rej = getattr(rec, "aitken_rejected", 0)
        total = acc + rej
        if total < self.aitken_min_jumps:
            return
        rate = rej / total
        with self._lock:
            if len(self._aitken_baseline) < self.baseline:
                self._aitken_baseline.append(rate)
                return
            base = statistics.median(self._aitken_baseline)
        if rate - base > self.aitken_shift:
            self._signal(
                "aitken_shift", rate,
                f"Aitken rejection rate {rate:.2f} vs baseline {base:.2f}")

    def observe_report(self, report) -> None:
        """Digest one async driver report (certificate-storm onset)."""
        rejected = getattr(report, "rejected_certificates", 0) or 0
        threshold = self.storm_frac * self.cert_storm
        if rejected >= max(threshold, 1):
            self._signal(
                "cert_storm_onset", float(rejected),
                f"{rejected} rejected certificates in one run "
                f"(sentinel storms at {self.cert_storm})")

    def observe_alpha(self, alpha: float) -> None:
        """Digest one contraction-modulus measurement; projects the recent
        trend ``alpha_horizon`` steps forward against ``alpha_max``."""
        a = float(alpha)
        with self._lock:
            self._alphas.append(a)
            recent = list(self._alphas)[-4:]
        if a >= self.alpha_max:
            self._signal("alpha_drift", a,
                         f"alpha {a:.5f} at/over the wall {self.alpha_max}")
            return
        if len(recent) < 3:
            return
        diffs = [b - x for x, b in zip(recent, recent[1:])]
        step = statistics.mean(diffs)
        if step <= 0:
            return
        projected = a + self.alpha_horizon * step
        if projected >= self.alpha_max:
            self._signal(
                "alpha_drift", a,
                f"alpha {a:.5f} rising {step:.5f}/step; projected "
                f"{projected:.5f} >= {self.alpha_max} within "
                f"{self.alpha_horizon} steps")

    def observe_failure(self, kind: str, detail: str = "") -> None:
        """Digest a supervised-attempt failure (timeout, fault, ...)."""
        self._signal("attempt_failure", 1.0,
                     f"{kind}: {detail}" if detail else kind)

    # -- signal plumbing --------------------------------------------------#
    def _signal(self, kind: str, value: float, detail: str) -> None:
        sig = WatchSignal(kind, value, detail, time.time())
        with self._lock:
            self.signals.append(sig)
            if kind in _TIGHTEN_TAU:
                self._pending["tighten_tau"] = True
            if kind in _SYNC_SWEEP:
                self._pending["sync_sweep"] = True
            if kind not in self._pending["reasons"]:
                self._pending["reasons"].append(kind)
        obs_metrics.counter(
            "psi_watch_signals_total",
            "convergence anomalies detected by the watch", ("kind",)
        ).labels(kind=kind).inc()
        obs_log.event("watch_anomaly", detail, level="warning",
                      kind=kind, value=value)

    def advice(self) -> WatchAdvice:
        """Peek at the pending recommendation without consuming it."""
        with self._lock:
            return WatchAdvice(self._pending["tighten_tau"],
                               self._pending["sync_sweep"],
                               tuple(self._pending["reasons"]))

    def consume_advice(self) -> WatchAdvice:
        """Hand the pending recommendation to the ladder and re-arm."""
        with self._lock:
            adv = WatchAdvice(self._pending["tighten_tau"],
                              self._pending["sync_sweep"],
                              tuple(self._pending["reasons"]))
            self._pending = {"tighten_tau": False, "sync_sweep": False,
                             "reasons": []}
        return adv

    def summary(self) -> dict:
        with self._lock:
            kinds: dict = {}
            for s in self.signals:
                kinds[s.kind] = kinds.get(s.kind, 0) + 1
            return dict(signals=len(self.signals), by_kind=kinds,
                        pending=dict(self._pending))
