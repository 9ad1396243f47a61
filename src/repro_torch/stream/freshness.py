"""Freshness accounting for streamed ψ serving.

Between two resolves the served :class:`~repro_torch.core.incremental.RankingCache`
is *stale by design* — events have been ingested (and possibly applied as
O(Δ) patches) but ψ has not been re-solved. This module makes that
staleness a first-class, certifiable quantity instead of an accident:

* :class:`FreshnessReport` — an immutable snapshot of how far the served
  ranking lags the event stream: events applied-but-unresolved, events
  still buffered, the estimator's dirty mass, event-time staleness, and
  the top-k churn measured between the last two resolves (how much the
  head of the ranking actually moved — the user-visible cost of serving
  stale). ``certify(...)`` answers a query's ``max_staleness`` demand.
* :class:`FreshnessPolicy` — when the ingestor flushes patches
  (``coalesce`` events per batched patch) and when it re-resolves:
  every ``resolve_every`` events, every ``resolve_seconds`` of event
  time, or when the estimator's dirty mass crosses
  ``max_dirty_mass`` — whichever fires first. All three triggers are
  optional; disabling all of them makes resolution purely query-driven
  (``StreamIngestor.top_k(..., max_events=...)``) or manual.
"""
from __future__ import annotations

import dataclasses

__all__ = ["FreshnessPolicy", "FreshnessReport"]


@dataclasses.dataclass(frozen=True)
class FreshnessReport:
    """How far the served ranking lags the ingested stream."""

    event_time: float        # latest event time ingested
    resolve_time: float      # event time when ψ was last resolved
    events_total: int        # events ingested over the stream's lifetime
    events_buffered: int     # ingested but not yet applied as patches
    events_unresolved: int   # ingested since the last resolve (incl. buffered)
    dirty_users: int         # users whose estimated rates are unsynced
    dirty_mass: float        # l1(estimated − synced rates) over dirty users
    resolves: int            # resolves performed so far
    topk_churn: float | None = None   # 1 − overlap/k between last 2 resolves
    # certified per-node |ψ_exact − ψ_served| bound of the serving solve
    # (engine residual certificate, see docs/LOCALPUSH.md); None when the
    # backend cannot certify one or events arrived since it was issued —
    # a bound must never outlive the operators it was proved against
    psi_error_bound: float | None = None

    @property
    def staleness_events(self) -> int:
        return self.events_unresolved

    @property
    def staleness_seconds(self) -> float:
        return max(0.0, self.event_time - self.resolve_time)

    def certify(self, *, max_events: int | None = None,
                max_seconds: float | None = None,
                max_dirty_mass: float | None = None,
                max_psi_error: float | None = None) -> bool:
        """True iff the served ranking meets every given staleness bound
        (an unset bound is not demanded; no bounds → trivially fresh).

        ``max_psi_error`` demands a *certified* numerical bound: it fails
        whenever ``psi_error_bound`` is absent, not merely when it is
        large — an uncertified ranking cannot satisfy a certificate
        demand."""
        if max_events is not None and self.staleness_events > max_events:
            return False
        if max_seconds is not None and self.staleness_seconds > max_seconds:
            return False
        if max_dirty_mass is not None and self.dirty_mass > max_dirty_mass:
            return False
        if max_psi_error is not None and (
                self.psi_error_bound is None
                or self.psi_error_bound > max_psi_error):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class FreshnessPolicy:
    """When the ingestor patches and when it re-resolves.

    Args:
      coalesce: buffered events per batched patch flush (the O(Δ) patch
        granularity; 1 applies every event immediately).
      resolve_every: re-resolve after this many ingested events (None
        disables the event-count trigger).
      resolve_seconds: re-resolve when the served fixed point is this many
        event-time seconds behind the stream (None disables).
      max_dirty_mass: re-resolve when the unresolved l1 rate mass (applied
        patches the served ψ has not absorbed, plus the estimator's
        pending dirty mass) crosses this threshold (None disables).
    """

    coalesce: int = 64
    resolve_every: int | None = 512
    resolve_seconds: float | None = None
    max_dirty_mass: float | None = None

    def __post_init__(self):
        if self.coalesce < 1:
            raise ValueError(f"coalesce must be >= 1; got {self.coalesce}")

    def due(self, report: FreshnessReport) -> bool:
        """Does ``report`` trip any resolve trigger?"""
        if (self.resolve_every is not None
                and report.events_unresolved >= self.resolve_every):
            return True
        if (self.resolve_seconds is not None
                and report.staleness_seconds >= self.resolve_seconds):
            return True
        if (self.max_dirty_mass is not None
                and report.dirty_mass >= self.max_dirty_mass):
            return True
        return False
