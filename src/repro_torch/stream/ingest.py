"""StreamIngestor: event log → batched O(Δ) patches → continuously-fresh ψ.

The pipeline this module closes:

    events (Post / Repost / Follow / Unfollow / TenantEvent)
      → RateEstimator        (online λ̂/μ̂, per-user dirty set)
      → coalescing window    (``FreshnessPolicy.coalesce`` events)
      → one batched patch    (``update_activity`` + ``add_edges`` +
                              ``remove_edges`` against the serving target)
      → freshness policy     (re-resolve every N events / Δt event-time /
                              dirty-mass threshold — else keep serving the
                              existing ranking with certified staleness)

Three serving targets share the ingestor through thin adapters:

* :class:`~repro_torch.core.incremental.PsiService` — patches apply with
  ``resolve=False`` (deferred); ``resolve()`` warm re-solves; between
  resolves the stale :class:`~repro_torch.core.incremental.RankingCache`
  serves.
* :class:`~repro_torch.serving.fleet.TenantFleet` — ``TenantEvent``s route
  to per-tenant lanes, each with its **own** estimator; patches use the
  fleet's native deferred dirty-marking and one ``fleet.solve()`` batches
  every dirty lane per resolve. (Frontier reads are fresh-on-read by the
  fleet's contract; the policy here governs the proactive solve cadence.)

* :class:`~repro_torch.asyncexec.AsyncPsiDriver` — patches go through the
  driver's generation-guarded hooks (between runs, or mid-flight from its
  ``epoch_hook``); ``resolve()`` warm-runs the bounded-staleness pipeline
  with the ingestor's ``resolve_opts``.

The estimator and the coalescing window are host numpy: events never touch
the card, only the batched patches and the resolves do.

Unfollow tombstones: inside one coalescing window the last operation on an
edge wins (follow→unfollow nets to nothing new; unfollow→follow nets to
the plain insert); a tombstone of a materialized edge becomes an edge
*removal* patch (``HostOperators.remove_edges``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from ..core.activity import RATE_FLOOR
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .estimator import RateEstimator
from .events import Follow, Post, Repost, TenantEvent, Unfollow
from .freshness import FreshnessPolicy, FreshnessReport

__all__ = ["StreamIngestor"]

_DONE = object()


# --------------------------------------------------------------------- #
# Target adapters — one uniform patch/resolve/query surface
# --------------------------------------------------------------------- #
class _ServiceTarget:
    """Single-lane adapter over a PsiService (deferred-resolve patches)."""

    multi = False

    def __init__(self, svc):
        self.svc = svc

    def n_of(self, key) -> int:
        return self.svc.graph.n

    def activity_of(self, key):
        return self.svc.engine.activity

    def apply_activity(self, key, users, lam, mu) -> None:
        self.svc.update_activity(users, lam=lam, mu=mu, resolve=False)

    def apply_add_edges(self, key, src, dst) -> None:
        self.svc.add_edges(src, dst, resolve=False)

    def apply_remove_edges(self, key, src, dst) -> None:
        self.svc.remove_edges(src, dst, resolve=False)

    def resolve(self) -> None:
        self.svc.resolve()

    def needs_resolve(self) -> bool:
        """True when a query could NOT serve the existing stale ranking —
        i.e. it would trigger a solve the ingestor's freshness accounting
        would otherwise miss (here: never solved at all)."""
        return self.svc.last_result is None

    def top_k(self, k: int):
        return self.svc.top_k(k)

    def topk_ids(self, k: int) -> tuple:
        return tuple(int(u) for u in self.svc.top_k(k)[0])

    def psi_of(self, key) -> np.ndarray:
        return self.svc.scores()

    def psi_error_bound(self):
        """The engine's certificate for the *served* fixed point — only
        meaningful while no patch has been applied since it was issued
        (certifying engines self-invalidate on patches, and the ingestor
        additionally gates on zero unresolved events)."""
        if self.svc.last_result is None:
            return None
        return self.svc.engine.psi_error_bound()


class _FleetTarget:
    """Per-tenant-lane adapter over a TenantFleet (native deferral)."""

    multi = True

    def __init__(self, fleet):
        self.fleet = fleet

    def n_of(self, tid) -> int:
        return self.fleet.stats(tid)["n"]       # raises for unknown tenants

    def activity_of(self, tid):
        return self.fleet.activity(tid)

    def apply_activity(self, tid, users, lam, mu) -> None:
        self.fleet.patch_activity(tid, users, lam=lam, mu=mu)

    def apply_add_edges(self, tid, src, dst) -> None:
        self.fleet.patch_edges(tid, src, dst)

    def apply_remove_edges(self, tid, src, dst) -> None:
        self.fleet.remove_edges(tid, src, dst)

    def resolve(self) -> None:
        self.fleet.solve()

    def needs_resolve(self) -> bool:
        # frontier reads are fresh-on-read (they solve dirty lanes
        # internally), so any stale tenant means a query IS a resolve —
        # route it through the ingestor so the freshness counters reset
        return any(self.fleet.stats(t)["staleness"] > 0
                   for t in self.fleet.tenant_ids)

    def top_k(self, k: int):
        return self.fleet.frontier.global_top_k(k)

    def topk_ids(self, k: int) -> tuple:
        return tuple((tid, int(u))
                     for tid, u, _ in self.fleet.frontier.global_top_k(k))

    def psi_of(self, tid) -> np.ndarray:
        return self.fleet.psi(tid)

    def psi_error_bound(self):
        return None          # batched lanes carry no residual certificate


class _AsyncDriverTarget:
    """Single-lane adapter over an AsyncPsiDriver (patch between or during
    runs; ``resolve`` warm-runs the bounded-staleness pipeline)."""

    multi = False

    def __init__(self, drv, resolve_opts: dict):
        self.drv = drv
        self.opts = dict(tol=1e-8)
        self.opts.update(resolve_opts)
        self.last_report = None
        self._cache = None

    def n_of(self, key) -> int:
        return self.drv.host.n

    def activity_of(self, key):
        return self.drv.host.activity()

    def apply_activity(self, key, users, lam, mu) -> None:
        self.drv.patch_activity(users, lam=lam, mu=mu)

    def apply_add_edges(self, key, src, dst) -> None:
        self.drv.patch_edges(src, dst)

    def apply_remove_edges(self, key, src, dst) -> None:
        self.drv.remove_edges(src, dst)

    def resolve(self) -> None:
        self.last_report = self.drv.run(warm=True, **self.opts)
        self._cache = self.last_report.queries()

    def needs_resolve(self) -> bool:
        return self._cache is None             # never resolved yet

    def top_k(self, k: int):
        return self._cache.top_k(k)

    def topk_ids(self, k: int) -> tuple:
        return tuple(int(u) for u in self._cache.top_k(k)[0])

    def psi_of(self, key) -> np.ndarray:
        return self._cache.psi

    def psi_error_bound(self):
        return None          # the async gap certifies movement, not distance


def _adapt(target, resolve_opts: dict):
    from ..asyncexec.executor import AsyncPsiDriver
    from ..core.incremental import PsiService
    from ..serving.fleet import TenantFleet
    if isinstance(target, PsiService):
        return _ServiceTarget(target)
    if isinstance(target, TenantFleet):
        return _FleetTarget(target)
    if isinstance(target, AsyncPsiDriver):
        return _AsyncDriverTarget(target, resolve_opts)
    raise TypeError(
        f"unsupported ingest target {type(target).__name__!r}; supported: "
        "PsiService, TenantFleet, AsyncPsiDriver")


# --------------------------------------------------------------------- #
# Lane state + the ingestor
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _Lane:
    """One estimator + coalescing buffer (one per tenant; one total for
    single-target ingestion)."""

    est: RateEstimator
    edge_ops: dict = dataclasses.field(default_factory=dict)  # (s,d)→add?
    buffered: int = 0                 # events since the last flush
    unresolved_mass: float = 0.0      # applied-but-unresolved l1 rate mass
    unresolved_users: set = dataclasses.field(default_factory=set)


class StreamIngestor:
    """Coalesce a live event stream into batched O(Δ) ψ patches.

    Args:
      target: a ``PsiService``, ``TenantFleet`` or ``AsyncPsiDriver``.
      half_life / floor: estimator parameters (see ``estimator.py``).
      policy: flush + resolve cadence (:class:`FreshnessPolicy`).
      topk: ranking depth tracked for the churn-between-resolves metric
        (0 disables churn tracking).
      t0: event-time origin.
      resolve_opts: extra kwargs for the async driver's ``run`` (e.g.
        ``dict(tol=1e-9)``); ignored by the other targets, which own their
        tolerance.
    """

    def __init__(self, target, *, half_life: float = 64.0,
                 floor: float = RATE_FLOOR,
                 policy: FreshnessPolicy | None = None, topk: int = 10,
                 t0: float = 0.0, resolve_opts: dict | None = None):
        self._adapter = _adapt(target, resolve_opts or {})
        self.policy = policy or FreshnessPolicy()
        self.half_life = float(half_life)
        self.floor = float(floor)
        self.topk = int(topk)
        self.t0 = float(t0)
        self._lanes: dict = {}
        self.events_total = 0
        self._buffered = 0                 # across lanes, since last flush
        self._resolved_events = 0          # events_total at the last resolve
        self._event_t = self.t0
        self._resolve_t = self.t0
        self.resolves = 0
        self.churn_history: list[float] = []
        self._last_churn: float | None = None
        self._prev_topk: tuple | None = None
        self._source: Iterator | None = None
        # per-event metric children cached per registry identity: the hot
        # path then pays one dict hit + one counter inc per event, and a
        # registry swap (obs.configure / obs.disable) re-resolves lazily
        self._obs_reg = None
        self._obs_kind: dict = {}

    def _obs_count_event(self, kind: str) -> None:
        reg = obs_metrics.get_registry()
        if reg is not self._obs_reg:
            fam = reg.counter("psi_stream_events_total",
                              "ingested events by kind",
                              labelnames=("kind",))
            self._obs_kind = {k: fam.labels(kind=k)
                              for k in ("post", "repost", "follow",
                                        "unfollow")}
            self._obs_reg = reg
        self._obs_kind[kind].inc()

    # -- lanes ----------------------------------------------------------- #
    def _lane(self, key) -> _Lane:
        lane = self._lanes.get(key)
        if lane is None:
            est = RateEstimator(self._adapter.n_of(key),
                                half_life=self.half_life, floor=self.floor,
                                t0=self.t0)
            est.sync_to(self._adapter.activity_of(key))
            lane = self._lanes[key] = _Lane(est=est)
        return lane

    def estimator(self, tenant: str | None = None) -> RateEstimator:
        """The (per-tenant) estimator lane, created on first access."""
        return self._lane(tenant).est

    # -- ingestion ------------------------------------------------------- #
    def submit(self, event) -> None:
        """Ingest one event; flushes / resolves per the freshness policy."""
        self._submit(event, allow_resolve=True)

    def _submit(self, event, *, allow_resolve: bool) -> None:
        if isinstance(event, TenantEvent):
            if not self._adapter.multi:
                raise TypeError("TenantEvent routing needs a TenantFleet "
                                f"target; got a {type(event).__name__} on a "
                                "single-tenant ingestor")
            key, ev = event.tenant, event.event
        else:
            if self._adapter.multi:
                raise TypeError("fleet ingestion routes TenantEvents; got a "
                                f"bare {type(event).__name__}")
            key, ev = None, event
        lane = self._lane(key)
        self._event_t = max(self._event_t, float(ev.t))
        if isinstance(ev, (Post, Repost)):
            lane.est.observe(ev)
            self._obs_count_event("repost" if isinstance(ev, Repost)
                                  else "post")
        elif isinstance(ev, Follow):
            lane.edge_ops[(int(ev.follower), int(ev.leader))] = True
            self._obs_count_event("follow")
        elif isinstance(ev, Unfollow):
            lane.edge_ops[(int(ev.follower), int(ev.leader))] = False
            self._obs_count_event("unfollow")
        else:
            raise TypeError(f"unknown event type {type(ev).__name__}")
        lane.buffered += 1
        self._buffered += 1
        self.events_total += 1
        if self._buffered >= self.policy.coalesce:
            self.flush()
        if allow_resolve and self._policy_due():
            self.resolve()

    def _policy_due(self) -> bool:
        """Per-event resolve check, cheap by construction: the event-count
        and event-time triggers need two scalars each; the full
        FreshnessReport (O(dirty-set) mass/user accounting) is only built
        when the dirty-mass trigger is enabled."""
        p = self.policy
        if (p.resolve_every is not None
                and self.events_total - self._resolved_events
                >= p.resolve_every):
            return True
        if (p.resolve_seconds is not None
                and self._event_t - self._resolve_t >= p.resolve_seconds):
            return True
        if p.max_dirty_mass is None:
            return False
        return p.due(self.freshness())

    def flush(self) -> None:
        """Apply every buffered window as batched O(Δ) patches (no solve).

        A window that nets out to nothing (e.g. only follow+unfollow pairs
        of the same edge) applies *no* patch at all — the serving layers'
        empty-delta fast paths guarantee no cache invalidation.
        """
        if self._buffered:
            obs_metrics.histogram(
                "psi_stream_flush_events",
                "events coalesced per flush window",
                buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 5000)
            ).observe(self._buffered)
        for key, lane in self._lanes.items():
            if lane.buffered == 0 and not lane.edge_ops:
                continue
            users, lam, mu, mass = lane.est.drain(self._event_t)
            lane.unresolved_mass += mass
            if users.size:
                lane.unresolved_users.update(int(u) for u in users)
                self._adapter.apply_activity(key, users, lam, mu)
            if lane.edge_ops:
                rm = [(s, d) for (s, d), add in lane.edge_ops.items()
                      if not add]
                add = [(s, d) for (s, d), a in lane.edge_ops.items() if a]
                lane.edge_ops.clear()
                if rm:
                    self._adapter.apply_remove_edges(
                        key, np.asarray([e[0] for e in rm], np.int32),
                        np.asarray([e[1] for e in rm], np.int32))
                if add:
                    self._adapter.apply_add_edges(
                        key, np.asarray([e[0] for e in add], np.int32),
                        np.asarray([e[1] for e in add], np.int32))
            lane.buffered = 0
        self._buffered = 0

    def resolve(self) -> None:
        """Flush, re-solve ψ on the target, and reset freshness counters
        (records top-k churn against the previous resolve)."""
        self.flush()
        # lag at the moment the resolve fires = how far the served ψ had
        # fallen behind the event-time watermark
        obs_metrics.gauge(
            "psi_stream_watermark_lag_seconds",
            "event-time lag of the served psi when the resolve fired"
        ).set(self._event_t - self._resolve_t)
        with obs_trace.span("stream.resolve",
                            unresolved=self.events_total
                            - self._resolved_events):
            self._adapter.resolve()
        obs_metrics.counter("psi_stream_resolves_total",
                            "stream-triggered target re-solves").inc()
        self.resolves += 1
        self._resolve_t = self._event_t
        self._resolved_events = self.events_total
        for lane in self._lanes.values():
            lane.unresolved_mass = 0.0
            lane.unresolved_users.clear()
        if self.topk > 0:
            ids = self._adapter.topk_ids(self.topk)
            if self._prev_topk is not None and ids:
                k = max(len(ids), len(self._prev_topk))
                churn = 1.0 - len(set(ids) & set(self._prev_topk)) / k
                self._last_churn = churn
                self.churn_history.append(churn)
            self._prev_topk = ids

    def ingest(self, source: Iterable, *, limit: int | None = None,
               resolve_at_end: bool = True) -> FreshnessReport:
        """Replay a source end-to-end under the freshness policy."""
        start_events = self.events_total
        with obs_trace.span("stream.ingest") as sp:
            for i, ev in enumerate(source):
                if limit is not None and i >= limit:
                    break
                self.submit(ev)
            self.flush()
            if resolve_at_end:
                self.resolve()
        done = self.events_total - start_events
        if done and sp.duration_s > 0:
            obs_metrics.gauge(
                "psi_stream_ingest_events_per_s",
                "wall-clock event throughput of the last ingest() replay"
            ).set(done / sp.duration_s)
        return self.freshness()

    # -- persisted offset (crash recovery) -------------------------------- #
    @property
    def offset(self) -> int:
        """Events consumed so far — the replay cursor a stack checkpoint
        persists. Checkpoints are taken at *flushed* points (buffered = 0,
        no pending edge ops), so a recovery that replays the event log from
        this offset reconstructs exactly the un-applied suffix; the
        estimator's :meth:`~repro_torch.stream.estimator.RateEstimator.
        state_dict` carries the applied prefix
        (:mod:`repro_torch.resilience.recovery` composes the two)."""
        return int(self.events_total)

    def fast_forward(self, offset: int, *, event_t: float | None = None
                     ) -> None:
        """Declare that the first ``offset`` events of the stream are
        already reflected in this ingestor's state (restored estimator +
        restored serving target) — the recovery path's half of the
        exactly-once contract: events before the offset are never
        re-applied, events after it arrive via normal :meth:`submit` /
        :meth:`pump` replay. Only valid on a quiescent ingestor (nothing
        buffered, nothing ingested yet through this instance)."""
        if self._buffered or self.events_total:
            raise RuntimeError("fast_forward on a non-quiescent ingestor "
                               f"(buffered={self._buffered}, "
                               f"events_total={self.events_total})")
        self.events_total = int(offset)
        self._resolved_events = int(offset)
        if event_t is not None:
            self._event_t = float(event_t)
            self._resolve_t = float(event_t)

    # -- incremental feeding (attach + pump) ---------------------------- #
    def attach(self, source: Iterable) -> None:
        """Stage a source for incremental :meth:`pump` consumption."""
        self._source = iter(source)

    @property
    def exhausted(self) -> bool:
        return self._source is None

    def pump(self, max_events: int = 64) -> int:
        """Ingest up to ``max_events`` from the attached source, applying
        patches but **never resolving** — the caller is the resolver.
        Returns the number of events consumed (0 once exhausted)."""
        if self._source is None:
            return 0
        n = 0
        while n < max_events:
            ev = next(self._source, _DONE)
            if ev is _DONE:
                self._source = None
                break
            self._submit(ev, allow_resolve=False)
            n += 1
        if n:
            self.flush()
        return n

    # -- freshness + queries --------------------------------------------- #
    def freshness(self) -> FreshnessReport:
        mass = sum(l.unresolved_mass for l in self._lanes.values())
        dirty = set()
        for key, lane in self._lanes.items():
            mass += lane.est.pending_mass(self._event_t)
            dirty.update((key, u) for u in lane.unresolved_users)
            dirty.update((key, int(u)) for u in lane.est.dirty)
        unresolved = self.events_total - self._resolved_events
        # a numerical certificate only covers the served ψ while nothing
        # has been ingested on top of the operators it was proved against
        bound = (self._adapter.psi_error_bound()
                 if unresolved == 0 else None)
        if obs_metrics.enabled():
            obs_metrics.gauge("psi_stream_dirty_mass",
                              "applied-but-unresolved l1 rate mass"
                              ).set(mass)
            obs_metrics.gauge("psi_stream_dirty_users",
                              "distinct users awaiting a resolve"
                              ).set(len(dirty))
            obs_metrics.gauge("psi_stream_unresolved_events",
                              "events ingested since the last resolve"
                              ).set(unresolved)
            # keep the freshness SLO's signal live between resolves:
            # the current lag of the served ψ behind the event watermark
            obs_metrics.gauge(
                "psi_stream_watermark_lag_seconds",
                "event-time lag of the served psi when the resolve fired"
            ).set(self._event_t - self._resolve_t)
            # the certified-ψ-error SLO reads this gauge; only a bound
            # that still covers the served answer is published
            if bound is not None:
                obs_metrics.gauge(
                    "psi_certified_error_bound",
                    "Eq. 19 certified sup-norm bound of the last served "
                    "answer").set(bound)
        return FreshnessReport(
            event_time=self._event_t, resolve_time=self._resolve_t,
            events_total=self.events_total, events_buffered=self._buffered,
            events_unresolved=unresolved,
            dirty_users=len(dirty), dirty_mass=mass, resolves=self.resolves,
            topk_churn=self._last_churn, psi_error_bound=bound)

    def top_k(self, k: int, *, max_events: int | None = None,
              max_seconds: float | None = None,
              max_dirty_mass: float | None = None,
              max_psi_error: float | None = None):
        """Query the served ranking, demanding at most the given staleness:
        if the current :class:`FreshnessReport` fails ``certify``, the
        ingestor resolves first (otherwise the stale ranking serves). A
        query the target could only answer by solving anyway (never solved,
        or a fleet with stale lanes — frontier reads are fresh-on-read)
        also routes through :meth:`resolve`, so the freshness counters
        always describe the ranking actually served. ``max_psi_error``
        additionally demands a certified numerical bound on the served ψ
        (only certifying backends — ``push`` — can serve stale under it)."""
        if (self._adapter.needs_resolve()
                or not self.freshness().certify(
                    max_events=max_events, max_seconds=max_seconds,
                    max_dirty_mass=max_dirty_mass,
                    max_psi_error=max_psi_error)):
            self.resolve()
        return self._adapter.top_k(k)

    def psi(self, tenant: str | None = None) -> np.ndarray:
        """The target's current ψ (tenant-scoped on a fleet; resolves
        through the freshness accounting when the target has no served
        fixed point to answer from)."""
        if self._adapter.needs_resolve():
            self.resolve()
        return self._adapter.psi_of(tenant)
