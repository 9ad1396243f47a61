"""Streaming ingestion: live event log → online λ/μ → continuously-fresh ψ.

The paper's workload is a *platform*: posts, re-posts and follows arrive as
a stream, not as a pre-estimated Activity over a frozen Graph. This package
closes that gap end to end on the port's engines and fleet:

* :mod:`events`    — typed replayable event log (``Post`` / ``Repost`` /
  ``Follow`` / ``Unfollow`` tombstone / ``TenantEvent``) plus seeded
  synthetic generators (stationary Poisson clocks, posting bursts,
  flash crowds with follower churn).
* :mod:`estimator` — online λ/μ estimation from event timestamps via
  bias-corrected exponentially-decayed counters (provably unbiased on
  stationary streams — the generators' ground truth is a fixed point),
  with per-user dirty-set tracking.
* :mod:`ingest`    — :class:`StreamIngestor`: coalesces events into
  batched O(Δ) patches against a ``PsiService``, a ``TenantFleet``
  (``TenantEvent`` lane routing) or an ``AsyncPsiDriver`` (mid-flight
  through its ``epoch_hook``), resolving per the freshness policy.
* :mod:`freshness` — :class:`FreshnessPolicy` (when to patch / re-solve)
  and :class:`FreshnessReport` (certifiable staleness of the served
  ranking: unresolved events, dirty rate mass, top-k churn).

``python -m repro_torch.stream.check [--device cpu]`` replays a fixed
synthetic log and asserts estimator accuracy + ψ-parity against a
from-scratch batch solve; ``repro_torch.launch.serve --stream <scenario>``
is the serving entry point. ``events``, ``estimator`` and ``freshness`` are
the JAX package's modules, verbatim up to the package name (pure numpy).
"""
from .estimator import RateEstimator
from .events import (EventSource, Follow, Post, ReplayLog, Repost,
                     TenantEvent, Unfollow, burst_stream,
                     flash_crowd_stream, poisson_stream, tenant_interleave)
from .freshness import FreshnessPolicy, FreshnessReport
from .ingest import StreamIngestor

__all__ = [
    "EventSource", "Follow", "FreshnessPolicy", "FreshnessReport", "Post",
    "RateEstimator", "ReplayLog", "Repost", "StreamIngestor", "TenantEvent",
    "Unfollow", "burst_stream", "flash_crowd_stream", "poisson_stream",
    "tenant_interleave",
]
