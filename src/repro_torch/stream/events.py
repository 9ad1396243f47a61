"""Typed, replayable event log for the streaming ingestion subsystem.

The ψ-score is a function of the platform's *activity* — who posts, who
re-posts, who follows whom (PAPER §II) — yet everything upstream of this
module consumes that activity pre-digested into an
:class:`~repro_torch.core.activity.Activity` (λ/μ vectors) and a frozen
:class:`~repro_torch.graphs.structure.Graph`. A live platform produces neither:
it produces an *event log*. This module is the shared vocabulary for that
log:

* :class:`Post` / :class:`Repost`     — activity clock ticks of one user
  (the raw material the online λ/μ estimator counts; ``estimator.py``).
* :class:`Follow` / :class:`Unfollow` — graph mutations. ``Unfollow`` is a
  *tombstone*: the ingestor nets it against a pending ``Follow`` of the
  same edge inside one coalescing window, and otherwise turns it into an
  edge removal patch (``ingest.py``).
* :class:`TenantEvent`                — routes any of the above to one
  tenant lane of a :class:`~repro_torch.serving.fleet.TenantFleet`.

An :class:`EventSource` is simply an iterable that yields the same
time-ordered event sequence on *every* iteration — deterministic replay is
the contract the parity acceptance tests lean on (replay + resolve must
match a from-scratch solve on the final state, so the log must be
re-playable against the batch oracle). :class:`ReplayLog` is the canonical
tuple-backed source; the synthetic generators below all return one.

Generators (all seeded, all pure numpy):

* :func:`poisson_stream`     — stationary ground-truth clocks: user ``u``
  posts as a Poisson process of rate λ_u and re-posts at rate μ_u over a
  fixed horizon (conditional-uniform sampling of arrival times). This is
  the stream the estimator must provably invert — see ``estimator.py``.
* :func:`burst_stream`       — ``poisson_stream`` plus a piecewise-constant
  posting burst: selected users post at ``burst_factor``·λ inside a window.
* :func:`flash_crowd_stream` — the graph-churn scenario: a celebrity gains
  followers mid-stream (``Follow``), the new fans run a repost storm, and a
  fraction churns out afterwards (``Unfollow`` tombstones).
* :func:`tenant_interleave`  — time-merge per-tenant sources into one
  ``TenantEvent`` stream for fleet ingestion.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Protocol, runtime_checkable

import numpy as np

from ..core.activity import Activity
from ..graphs.structure import Graph

__all__ = ["Post", "Repost", "Follow", "Unfollow", "TenantEvent",
           "EventSource", "ReplayLog", "poisson_stream", "burst_stream",
           "flash_crowd_stream", "tenant_interleave"]


@dataclasses.dataclass(frozen=True)
class Post:
    """User ``user`` published an original post at event time ``t``."""

    t: float
    user: int


@dataclasses.dataclass(frozen=True)
class Repost:
    """User ``user`` re-posted from their news feed at ``t``.

    ``origin`` optionally names the author of the re-shared post (−1 when
    unknown); the rate estimator only needs the (t, user) clock tick.
    """

    t: float
    user: int
    origin: int = -1


@dataclasses.dataclass(frozen=True)
class Follow:
    """``follower`` started following ``leader`` (edge follower→leader)."""

    t: float
    follower: int
    leader: int


@dataclasses.dataclass(frozen=True)
class Unfollow:
    """Tombstone: ``follower`` stopped following ``leader``.

    Inside one coalescing window it cancels a pending :class:`Follow` of
    the same edge; against an already-materialized edge it becomes an edge
    *removal* patch (``HostOperators.remove_edges``).
    """

    t: float
    follower: int
    leader: int


@dataclasses.dataclass(frozen=True)
class TenantEvent:
    """Wrapper routing ``event`` to tenant ``tenant`` of a fleet."""

    tenant: str
    event: "Post | Repost | Follow | Unfollow"

    @property
    def t(self) -> float:
        return self.event.t


@runtime_checkable
class EventSource(Protocol):
    """Anything that yields the same time-ordered events every iteration."""

    def __iter__(self) -> Iterator: ...


@dataclasses.dataclass(frozen=True)
class ReplayLog:
    """Materialized, immutable event sequence — trivially replayable."""

    events: tuple

    def __iter__(self) -> Iterator:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __getitem__(self, i):
        return self.events[i]

    @property
    def span(self) -> tuple[float, float]:
        """(first, last) event time; (0, 0) when empty."""
        if not self.events:
            return 0.0, 0.0
        return self.events[0].t, self.events[-1].t

    def counts(self) -> dict:
        """Event-type histogram (``{'Post': k, ...}``)."""
        out: dict[str, int] = {}
        for ev in self.events:
            key = type(ev.event if isinstance(ev, TenantEvent)
                       else ev).__name__
            out[key] = out.get(key, 0) + 1
        return out

    @classmethod
    def from_events(cls, events: Iterable) -> "ReplayLog":
        """Time-sort (stable) a collection of events into a log."""
        return cls(tuple(sorted(events, key=lambda e: e.t)))


# --------------------------------------------------------------------- #
# Synthetic generators
# --------------------------------------------------------------------- #
def _poisson_ticks(rates: np.ndarray, horizon: float, t0: float,
                   rng: np.random.Generator
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(times, users) of merged Poisson clocks, one per user.

    Conditional on the count N_u ~ Poisson(rate_u · horizon), the arrival
    times of a homogeneous Poisson process are i.i.d. uniform on the
    window — so the whole fan of clocks samples in two vectorized draws.
    """
    counts = rng.poisson(np.maximum(rates, 0.0) * horizon)
    users = np.repeat(np.arange(rates.shape[0], dtype=np.int64), counts)
    times = t0 + rng.random(users.shape[0]) * horizon
    return times, users


def _repost_origins(graph: Graph | None, users: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """A random leader of each re-posting user (−1 if none / no graph)."""
    origins = np.full(users.shape[0], -1, np.int64)
    if graph is None or users.size == 0:
        return origins
    _, leaders = graph.edges_by_src
    indptr = graph.csr_indptr
    deg = (indptr[users + 1] - indptr[users]).astype(np.int64)
    has = deg > 0
    pick = indptr[users[has]] + (rng.random(int(has.sum()))
                                 * deg[has]).astype(np.int64)
    origins[has] = leaders[pick]
    return origins


def poisson_stream(activity: Activity, horizon: float, *, seed: int = 0,
                   t0: float = 0.0, graph: Graph | None = None) -> ReplayLog:
    """Stationary ground-truth stream: posts at λ_u, re-posts at μ_u.

    The estimator's convergence target: replaying this log through
    :class:`~repro_torch.stream.estimator.RateEstimator` recovers ``activity``
    (λ̂ → λ, μ̂ → μ as events accumulate — the generator's rates are the
    estimator's fixed point; see the estimator's unbiasedness note).
    ``graph`` (optional) only decorates reposts with a plausible origin.
    """
    rng = np.random.default_rng(seed)
    pt, pu = _poisson_ticks(activity.lam, horizon, t0, rng)
    rt, ru = _poisson_ticks(activity.mu, horizon, t0, rng)
    ro = _repost_origins(graph, ru, rng)
    events = [Post(float(t), int(u)) for t, u in zip(pt, pu)]
    events += [Repost(float(t), int(u), int(o))
               for t, u, o in zip(rt, ru, ro)]
    return ReplayLog.from_events(events)


def burst_stream(activity: Activity, horizon: float, *,
                 burst_users: np.ndarray, burst_factor: float = 8.0,
                 window: tuple[float, float] | None = None, seed: int = 0,
                 t0: float = 0.0, graph: Graph | None = None) -> ReplayLog:
    """Piecewise-constant posting burst over a stationary background.

    ``burst_users`` post at ``burst_factor · λ`` inside ``window``
    (default: the middle third of the horizon) — the scenario that
    exercises the estimator's half-life: short half-lives track the burst,
    long ones smooth it toward the time-average.
    """
    rng = np.random.default_rng(seed)
    base = poisson_stream(activity, horizon, seed=seed + 1, t0=t0,
                          graph=graph)
    w0, w1 = window if window is not None else (t0 + horizon / 3.0,
                                                t0 + 2.0 * horizon / 3.0)
    users = np.asarray(burst_users, np.int64).reshape(-1)
    extra_rate = activity.lam[users] * max(0.0, burst_factor - 1.0)
    bt, bi = _poisson_ticks(extra_rate, w1 - w0, w0, rng)
    extra = [Post(float(t), int(users[i])) for t, i in zip(bt, bi)]
    return ReplayLog.from_events(list(base) + extra)


def flash_crowd_stream(graph: Graph, activity: Activity, horizon: float, *,
                       celebrity: int | None = None,
                       new_followers: int = 64, storm_mu: float = 4.0,
                       churn: float = 0.25,
                       window: tuple[float, float] | None = None,
                       seed: int = 0, t0: float = 0.0) -> ReplayLog:
    """Graph-churn scenario: a flash crowd forms around one celebrity.

    Inside ``window`` (default: middle third), ``new_followers`` users who
    do not yet follow ``celebrity`` (default: the max in-degree node) emit
    ``Follow`` events at uniform times and run a repost storm (extra
    reposts of the celebrity at rate ``storm_mu``). After the window a
    ``churn`` fraction of them emits ``Unfollow`` tombstones. The
    background is the stationary :func:`poisson_stream` of ``activity``.
    """
    rng = np.random.default_rng(seed)
    if celebrity is None:
        celebrity = int(np.argmax(graph.in_degree))
    w0, w1 = window if window is not None else (t0 + horizon / 3.0,
                                                t0 + 2.0 * horizon / 3.0)
    already = set(graph.followers_of(celebrity).tolist()) | {celebrity}
    pool = np.asarray([u for u in range(graph.n) if u not in already],
                      np.int64)
    fans = rng.permutation(pool)[:min(new_followers, pool.size)]
    follow_t = np.sort(w0 + rng.random(fans.size) * (w1 - w0))
    events: list = [Follow(float(t), int(u), int(celebrity))
                    for t, u in zip(follow_t, fans)]
    # repost storm: each fan re-posts the celebrity at storm_mu from the
    # moment it follows until the window closes
    for t_f, u in zip(follow_t, fans):
        k = rng.poisson(storm_mu * max(0.0, w1 - t_f))
        ts = t_f + rng.random(k) * max(1e-12, w1 - t_f)
        events += [Repost(float(t), int(u), int(celebrity)) for t in ts]
    # churn: a fraction of the crowd unfollows after the window
    n_churn = int(round(churn * fans.size))
    churners = rng.permutation(fans)[:n_churn]
    churn_t = w1 + rng.random(n_churn) * max(1e-12, t0 + horizon - w1)
    events += [Unfollow(float(t), int(u), int(celebrity))
               for t, u in zip(churn_t, churners)]
    base = poisson_stream(activity, horizon, seed=seed + 1, t0=t0,
                          graph=graph)
    return ReplayLog.from_events(list(base) + events)


def tenant_interleave(sources: dict[str, EventSource]) -> ReplayLog:
    """Merge per-tenant sources into one time-ordered TenantEvent log."""
    events = [TenantEvent(tid, ev) for tid, src in sources.items()
              for ev in src]
    return ReplayLog.from_events(events)
