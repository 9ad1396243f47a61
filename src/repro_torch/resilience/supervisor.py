"""Self-healing resolve supervision: deadlines, retries, escalation,
degraded serving.

:class:`ResilientResolver` wraps an :class:`~repro_torch.asyncexec.executor
.AsyncPsiDriver`'s resolve path so that *no single fault makes a query
unanswerable*. Each resolve climbs an escalation ladder, stopping at the
first rung that produces a healthy converged fixed point:

1. **retry** — up to ``1 + max_retries`` async attempts, each under a
   per-attempt wall-clock deadline (a ``threading.Timer`` cooperatively
   cancels the scheduler — a hung chunk cannot hold the deadline hostage)
   with bounded exponential backoff between attempts.
2. **rechunk / τ-tighten** — rebuild the pipeline with ``tau = 0`` (the
   barriered schedule: no staleness, no certificate rejections; the board
   carries over warm through ``rechunk``'s exact host sharing).
3. **async → sync sweep** — abandon overlap entirely: one synchronous
   ``reference``-engine solve from the current host operators, on the
   driver's device and in its dtype. No thread pool, no staleness — the
   most boring possible execution.
4. **serve degraded** — give up on *this* resolve and serve the last known
   good fixed point, honestly tagged: the outcome's freshness report
   carries the wall-clock staleness and the last good solve's certified
   ``psi_error_bound`` (:func:`~repro_torch.resilience.health.psi_residual_bound`),
   flowing through the same :class:`~repro_torch.core.incremental.RankingCache` /
   ``FreshnessReport.certify`` machinery every fresh answer uses. A
   degraded answer is never silently passed off as fresh.

Every resolve's health is sentinel-checked (non-finite ψ/gap, runaway gap,
certificate storms) before it is accepted — a fast wrong answer is a
failure, not a success. The resolver accumulates a
:class:`ResilienceReport`; ``launch/serve.py --chaos`` prints one.

The JAX package's ``repro.resilience.supervisor`` on the port's driver.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.incremental import RankingCache
from ..obs import log as obs_log
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..stream.freshness import FreshnessReport
from .health import Sentinels, psi_residual_bound

__all__ = ["ResilientResolver", "ResolveOutcome", "ResilienceReport",
           "ResolveFailure", "AttemptTimeout", "SentinelFailure"]


class ResolveFailure(RuntimeError):
    """One resolve attempt failed (did not converge within its budget)."""


class AttemptTimeout(ResolveFailure):
    """The per-attempt deadline cancelled the scheduler."""


class SentinelFailure(ResolveFailure):
    """The attempt produced a result a health sentinel refused."""


@dataclasses.dataclass
class ResolveOutcome:
    """What one supervised resolve actually served."""

    ranking: RankingCache            # the served fixed point (+ err_bound)
    degraded: bool                   # True ⇒ last-known-good, not fresh
    escalation: str                  # 'none'|'retry'|'rechunk'|'sync'|'degraded'
    attempts: int                    # attempts consumed (all rungs)
    psi_error_bound: float | None    # certified |ψ_exact − ψ_served| bound
    freshness: FreshnessReport | None = None   # staleness tag (degraded ⇒ set)
    report: object | None = None     # the winning attempt's driver report

    @property
    def psi(self) -> np.ndarray:
        return self.ranking.psi


@dataclasses.dataclass
class ResilienceReport:
    """Fleet-level chaos accounting: what was injected, what survived, and
    what surviving cost. ``injected``/``survived`` are per-fault-class
    counters (usually a :class:`~repro_torch.resilience.faults.FaultClock`'s);
    the rest is the supervisor's own ledger."""

    injected: dict = dataclasses.field(default_factory=dict)
    survived: dict = dataclasses.field(default_factory=dict)
    retries: int = 0
    escalations: list = dataclasses.field(default_factory=list)
    preemptions: list = dataclasses.field(default_factory=list)
    degraded_served: int = 0
    recoveries: int = 0
    mttr_samples: list = dataclasses.field(default_factory=list)

    @property
    def mttr_s(self) -> float:
        """Mean time-to-recovery over incidents that recovered (0 if none)."""
        return (float(np.mean(self.mttr_samples))
                if self.mttr_samples else 0.0)

    @property
    def unsurvived(self) -> dict:
        """Fault classes with injected > survived — must be empty for a
        passing chaos run."""
        out = {}
        for kind, n in dict(self.injected).items():
            missing = int(n) - int(self.survived.get(kind, 0))
            if missing > 0:
                out[kind] = missing
        return out

    def merge_clock(self, clock) -> "ResilienceReport":
        """Fold a FaultClock's counters into this report (additive)."""
        for k, v in clock.injected.items():
            self.injected[k] = self.injected.get(k, 0) + int(v)
        for k, v in clock.survived.items():
            self.survived[k] = self.survived.get(k, 0) + int(v)
        return self

    def summary(self) -> str:
        lines = ["ResilienceReport"]
        kinds = sorted(set(self.injected) | set(self.survived))
        for kind in kinds:
            i = int(self.injected.get(kind, 0))
            s = int(self.survived.get(kind, 0))
            mark = "ok" if s >= i else f"UNSURVIVED x{i - s}"
            lines.append(f"  {kind:<12} injected={i:<4d} survived={s:<4d} "
                         f"[{mark}]")
        lines.append(f"  retries={self.retries} "
                     f"escalations={self.escalations or '[]'} "
                     f"preemptions={self.preemptions or '[]'} "
                     f"degraded_served={self.degraded_served} "
                     f"recoveries={self.recoveries} "
                     f"mttr={self.mttr_s * 1e3:.1f}ms")
        return "\n".join(lines)


class ResilientResolver:
    """Supervised resolve path over an ``AsyncPsiDriver`` (see module doc).

    Args:
      driver: the async driver to supervise (replaced in place when the
        rechunk rung fires — read it back via ``.driver``).
      tol / max_iter: the convergence contract each attempt must meet.
      attempt_deadline_s: per-attempt wall-clock budget (None = no
        deadline; attempts are then bounded only by ``max_iter``).
      max_retries: extra same-configuration attempts before escalating.
      backoff_s / backoff_factor: exponential backoff between retries.
      allow_rechunk / allow_sync: enable ladder rungs 2 and 3.
      sentinels: health checks applied to every candidate result.
      freshness_fn: optional ``() -> FreshnessReport`` (e.g. a
        ``StreamIngestor.freshness``) used to tag degraded answers with
        real stream staleness; without it a wall-clock-staleness report is
        synthesized.
      watch: optional :class:`~repro_torch.obs.watch.ConvergenceWatch` — its
        latched advice is consumed at the top of every resolve and can
        *pre-empt* the ladder: ``tighten_tau`` re-chunks to τ = 0 before
        the first attempt (ahead of a certificate storm tripping the
        sentinel), ``sync_sweep`` goes straight to the synchronous rung
        (ahead of an α-drift / plateau trip). The watch also digests
        every attempt's driver report and failures, closing the loop.
    """

    def __init__(self, driver, *, tol: float = 1e-8, max_iter: int = 2000,
                 attempt_deadline_s: float | None = 30.0,
                 max_retries: int = 2, backoff_s: float = 0.05,
                 backoff_factor: float = 2.0, allow_rechunk: bool = True,
                 allow_sync: bool = True,
                 sentinels: Sentinels | None = None,
                 freshness_fn=None, watch=None):
        self.driver = driver
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self.attempt_deadline_s = attempt_deadline_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.allow_rechunk = allow_rechunk
        self.allow_sync = allow_sync
        self.sentinels = sentinels or Sentinels()
        self.freshness_fn = freshness_fn
        self.watch = watch
        self.report = ResilienceReport()
        self._last_good: RankingCache | None = None
        self._last_good_wall: float = time.time()

    # -- one supervised resolve ------------------------------------------ #
    def resolve(self, *, warm: bool = True) -> ResolveOutcome:
        obs_metrics.counter(
            "psi_resilience_resolves_total",
            "supervised resolves (degraded-ratio denominator)").inc()
        with obs_trace.span("resilience.resolve"):
            return self._resolve(warm=warm)

    def _resolve(self, *, warm: bool) -> ResolveOutcome:
        attempts = 0
        first_failure: float | None = None
        failures: list[str] = []

        # rung 0: pre-emptive action the watch advised before anything
        # has failed — act while the run is still healthy, not after
        advice = (self.watch.consume_advice()
                  if self.watch is not None else None)
        if advice:
            if (advice.tighten_tau and self.allow_rechunk
                    and getattr(self.driver, "tau", 0) > 0):
                self._note_preemption("rechunk", advice.reasons)
                self.driver = self.driver.rechunk(
                    self.driver.num_chunks, tau=0)
            elif advice.sync_sweep and self.allow_sync:
                self._note_preemption("sync", advice.reasons)
                attempts += 1
                try:
                    rep = self._attempt_sync()
                    return self._accept(rep, attempts, None, "none")
                except ResolveFailure as e:
                    failures.append(f"preemptive sync: {e}")
                    first_failure = obs_trace.now()

        # rung 1: retry with backoff
        for i in range(1 + self.max_retries):
            if i:
                self.report.retries += 1
                obs_metrics.counter(
                    "psi_resilience_retries_total",
                    "same-configuration resolve retries (ladder rung 1)",
                ).inc()
                time.sleep(self.backoff_s * self.backoff_factor ** (i - 1))
            attempts += 1
            try:
                rep = self._attempt_async(warm=warm)
                return self._accept(rep, attempts, first_failure,
                                    "none" if not failures else "retry")
            except ResolveFailure as e:
                failures.append(f"attempt {attempts}: {e}")
                first_failure = first_failure or obs_trace.now()

        # rung 2: rechunk with τ = 0 (barriered — no staleness to certify)
        if self.allow_rechunk:
            self._note_escalation("rechunk")
            self.driver = self.driver.rechunk(self.driver.num_chunks, tau=0)
            attempts += 1
            try:
                rep = self._attempt_async(warm=True)   # board carried over
                return self._accept(rep, attempts, first_failure, "rechunk")
            except ResolveFailure as e:
                failures.append(f"rechunk: {e}")

        # rung 3: synchronous sweep (no pool, no staleness, no overlap)
        if self.allow_sync:
            self._note_escalation("sync")
            attempts += 1
            try:
                rep = self._attempt_sync()
                return self._accept(rep, attempts, first_failure, "sync")
            except ResolveFailure as e:
                failures.append(f"sync: {e}")

        # rung 4: serve degraded from the last known good fixed point
        return self._degrade(attempts, failures)

    def _note_escalation(self, rung: str) -> None:
        self.report.escalations.append(rung)
        obs_metrics.counter(
            "psi_resilience_escalations_total",
            "ladder escalations past the retry rung", ["rung"],
        ).labels(rung=rung).inc()
        obs_log.event("resolve_escalation",
                      f"resolve escalated to the {rung} rung",
                      level="warning", rung=rung)

    def _note_preemption(self, action: str, reasons: tuple) -> None:
        self.report.preemptions.append(action)
        obs_metrics.counter(
            "psi_resilience_preemptions_total",
            "watch-advised actions taken before any failure", ["action"],
        ).labels(action=action).inc()
        obs_log.event("resolve_preempted",
                      f"watch advice pre-empted the ladder: {action} "
                      f"(reasons: {', '.join(reasons) or 'unspecified'})",
                      action=action, reasons=list(reasons))

    # -- attempts --------------------------------------------------------- #
    def _attempt_async(self, *, warm: bool):
        sched = self.driver.sched
        timer = None
        if self.attempt_deadline_s is not None:
            timer = threading.Timer(self.attempt_deadline_s, sched.cancel)
            timer.daemon = True
            timer.start()
        try:
            rep = self.driver.run(tol=self.tol, max_iter=self.max_iter,
                                  warm=warm)
        finally:
            if timer is not None:
                timer.cancel()
        if self.watch is not None:
            self.watch.observe_report(rep)
        if not rep.converged and sched.cancelled:
            if self.watch is not None:
                self.watch.observe_failure(
                    "timeout", f"deadline {self.attempt_deadline_s}s")
            raise AttemptTimeout(
                f"deadline {self.attempt_deadline_s}s cancelled the "
                f"scheduler at gap {rep.gap:.3g}")
        trip = self.sentinels.check_report(rep)
        if trip is not None:
            raise SentinelFailure(str(trip))
        if not rep.converged:
            raise ResolveFailure(f"epoch budget exhausted at gap "
                                 f"{rep.gap:.3g} > tol {self.tol:g}")
        return rep

    def _attempt_sync(self):
        from ..core.engine import make_engine
        host = self.driver.host
        eng = make_engine("reference", graph=host.graph(),
                          activity=host.activity(), dtype=self.driver.dtype,
                          device=self.driver.device)
        res = eng.run(tol=self.tol, max_iter=self.max_iter)
        trip = self.sentinels.check_array("psi", res.psi)
        if trip is not None:
            raise SentinelFailure(str(trip))
        if not bool(res.converged):
            raise ResolveFailure(f"sync sweep exhausted max_iter at gap "
                                 f"{float(res.gap):.3g}")
        # the engine's gap is Eq. 19-scaled (·‖B‖); the residual bound
        # wants the raw l1 step — unscale through the host's b_norm
        b = host.b_norm
        raw_gap = float(res.gap) / b if b > 0 else 0.0
        return _SyncResult(psi=res.psi.cpu().numpy(), gap=raw_gap,
                           converged=True)

    # -- outcomes --------------------------------------------------------- #
    def _accept(self, rep, attempts: int, first_failure: float | None,
                escalation: str) -> ResolveOutcome:
        bound = psi_residual_bound(self.driver.host, float(rep.gap))
        cache = RankingCache(torch.from_numpy(np.asarray(rep.psi)),
                             err_bound=bound)
        self._last_good = cache
        self._last_good_wall = time.time()
        if bound is not None:
            obs_metrics.gauge(
                "psi_certified_error_bound",
                "Eq. 19 certified sup-norm bound of the last served "
                "answer").set(bound)
        if first_failure is not None:
            # MTTR on the shared span clock: first failure → first accepted
            # answer (the same measurement ResilienceReport.mttr_s averages)
            mttr = obs_trace.now() - first_failure
            self.report.recoveries += 1
            self.report.mttr_samples.append(mttr)
            obs_metrics.histogram(
                "psi_resilience_mttr_seconds",
                "first failure to first accepted answer, per incident",
            ).observe(mttr)
            obs_log.event("resolve_recovered",
                          f"resolve recovered via {escalation} "
                          f"after {mttr * 1e3:.1f}ms", escalation=escalation)
        return ResolveOutcome(ranking=cache, degraded=False,
                              escalation=escalation, attempts=attempts,
                              psi_error_bound=bound, report=rep)

    def _degrade(self, attempts: int, failures: list[str]) -> ResolveOutcome:
        if self._last_good is None:
            raise ResolveFailure(
                "every ladder rung failed and no previous fixed point "
                "exists to degrade to:\n  " + "\n  ".join(failures))
        self._note_escalation("degraded")
        self.report.degraded_served += 1
        obs_metrics.counter(
            "psi_resilience_degraded_served_total",
            "answers served from the last known good fixed point",
        ).inc()
        bound = self._last_good.err_bound
        if bound is not None:
            obs_metrics.gauge(
                "psi_certified_error_bound",
                "Eq. 19 certified sup-norm bound of the last served "
                "answer").set(bound)
        now = time.time()
        if self.freshness_fn is not None:
            fr = dataclasses.replace(self.freshness_fn(),
                                     psi_error_bound=bound)
        else:
            # wall-clock staleness tag: the served point is this many real
            # seconds old, with the bound it was certified with back then
            fr = FreshnessReport(
                event_time=now, resolve_time=self._last_good_wall,
                events_total=0, events_buffered=0, events_unresolved=0,
                dirty_users=0, dirty_mass=0.0, resolves=0,
                psi_error_bound=bound)
        return ResolveOutcome(ranking=self._last_good, degraded=True,
                              escalation="degraded", attempts=attempts,
                              psi_error_bound=bound, freshness=fr,
                              report=None)


@dataclasses.dataclass(frozen=True)
class _SyncResult:
    """Duck-typed driver report for the sync-sweep rung (raw-gap field)."""

    psi: np.ndarray
    gap: float
    converged: bool
