"""Online λ/μ estimation from event timestamps.

One exponentially-decayed counter per (user, rate): with decay constant
``α = ln 2 / half_life``, the decayed count of a user's posts at time t is

    N̂(t) = Σ_{events i ≤ t} exp(−α · (t − t_i))

maintained lazily — one multiply-add per event, O(1) per event per user.
For a stationary Poisson clock of rate λ the expectation is exactly

    E[N̂(t)] = λ · W(t),   W(t) = (1 − e^{−α (t − t₀)}) / α,

so the *bias-corrected* estimator  λ̂(t) = N̂(t) / W(t)  is unbiased for
every t > t₀ (not just after a burn-in): at small t it degrades gracefully
to the windowed MLE count/elapsed, and as t → ∞ it becomes the classic
EWMA rate α·N̂ with relative standard deviation √(α / 2λ). Replaying a
stream generated from ground-truth rates therefore *converges to those
rates* — ``activity.heterogeneous`` / ``homogeneous`` are fixed points of
generate → estimate, which is exactly what the parity tests assert. Pick
``half_life`` ≫ 1/λ for tight stationary estimates, or short to track
bursts (docs/STREAMING.md quantifies the trade-off).

Cold start: a user with no observed events has N̂ = 0; the estimate is
clamped to :data:`~repro_torch.core.activity.RATE_FLOOR` (both rates), keeping
λ+μ strictly positive so the ψ iteration's c = μ/(λ+μ) normalization never
degenerates (see ``Activity.floored``).

Dirty-set tracking: the estimator remembers which users saw events since
the last :meth:`drain` and what rates the serving target currently holds
(``synced``). ``drain`` returns exactly the (users, λ̂, μ̂, mass) delta the
ingestor turns into one batched O(Δ) ``update_activity`` patch;
:meth:`pending_mass` is the l1 distance between estimated and synced rates
over the dirty set — the freshness policy's resolve trigger.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.activity import RATE_FLOOR, Activity
from .events import Post, Repost

__all__ = ["RateEstimator"]


class RateEstimator:
    """Per-user decayed-count λ/μ estimator with dirty-set tracking.

    Args:
      n: number of users (fixed; events must reference ids < n).
      half_life: decay half-life in event-time units. ``inf`` is allowed
        and yields the pure count/elapsed MLE (no forgetting).
      floor: strictly-positive clamp for cold-start / silent users.
      t0: event-time origin of the stream.
    """

    def __init__(self, n: int, *, half_life: float = 64.0,
                 floor: float = RATE_FLOOR, t0: float = 0.0):
        if half_life <= 0:
            raise ValueError(f"half_life must be > 0; got {half_life}")
        if floor <= 0:
            raise ValueError(f"floor must be > 0; got {floor}")
        self.n = int(n)
        self.half_life = float(half_life)
        self.alpha = math.log(2.0) / half_life   # 0.0 when half_life = inf
        self.floor = float(floor)
        self.t0 = float(t0)
        self.t = float(t0)                       # latest event time seen
        self.events = 0
        # row 0: posts (λ), row 1: reposts (μ); decayed to self._last[u]
        self._cnt = np.zeros((2, self.n))
        self._last = np.full(self.n, float(t0))
        self._touched = np.zeros(self.n, bool)
        # what the serving target currently holds (floored layout)
        self._synced = np.full((2, self.n), self.floor)

    # -- ingest ---------------------------------------------------------- #
    def observe(self, event) -> None:
        """Count one :class:`Post` / :class:`Repost` clock tick."""
        if isinstance(event, Post):
            self._tick(0, event.t, event.user)
        elif isinstance(event, Repost):
            self._tick(1, event.t, event.user)
        else:
            raise TypeError(f"RateEstimator counts Post/Repost events; "
                            f"got {type(event).__name__}")

    def observe_post(self, t: float, user: int) -> None:
        self._tick(0, t, user)

    def observe_repost(self, t: float, user: int) -> None:
        self._tick(1, t, user)

    def _tick(self, kind: int, t: float, user: int) -> None:
        if not 0 <= user < self.n:
            raise ValueError(f"user {user} out of range [0, {self.n})")
        if not math.isfinite(t):
            # a NaN timestamp would poison _last/_cnt and from there every
            # drained rate — reject at the boundary, state untouched
            raise ValueError(f"non-finite event timestamp {t!r} "
                             f"for user {user}")
        dt = t - self._last[user]
        if dt < 0:                   # same-window jitter: clamp, don't grow
            dt = 0.0
        if self.alpha:
            self._cnt[:, user] *= math.exp(-self.alpha * dt)
        self._cnt[kind, user] += 1.0
        self._last[user] = max(self._last[user], t)
        self.t = max(self.t, t)
        self._touched[user] = True
        self.events += 1

    # -- estimates ------------------------------------------------------- #
    def _normalizer(self, t: float) -> float:
        """W(t) = (1 − e^{−α(t−t₀)})/α — the unbiasedness denominator."""
        elapsed = max(0.0, t - self.t0)
        if self.alpha == 0.0:
            return elapsed
        return -math.expm1(-self.alpha * elapsed) / self.alpha

    def _rates_at(self, t: float, users: np.ndarray) -> np.ndarray:
        """f64[2, |users|] floored (λ̂, μ̂) at query time ``t``."""
        w = self._normalizer(t)
        if w <= 0.0:
            return np.full((2, users.shape[0]), self.floor)
        decay = (np.exp(-self.alpha * np.maximum(0.0, t - self._last[users]))
                 if self.alpha else 1.0)
        return np.maximum(self._cnt[:, users] * decay / w, self.floor)

    def rates(self, t: float | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
        """Current (λ̂, μ̂) vectors (floored), decayed to ``t`` (default:
        the latest event time seen)."""
        est = self._rates_at(self._at(t), np.arange(self.n))
        return est[0], est[1]

    def activity(self, t: float | None = None) -> Activity:
        """The estimated :class:`Activity` (strictly positive by floor)."""
        lam, mu = self.rates(t)
        return Activity(lam, mu)

    # -- dirty-set / sync ------------------------------------------------ #
    def _at(self, t: float | None) -> float:
        """The shared clock read: ``t=None`` means "now" = the latest event
        time seen. :meth:`pending_mass` and :meth:`drain` both resolve
        their default through this one helper, so a pending-mass probe
        followed by a drain at the same (default) instant measures the
        *same* rates — the mass reported equals the mass drained."""
        return self.t if t is None else float(t)

    @property
    def dirty(self) -> np.ndarray:
        """Users with events since the last :meth:`drain` (ascending)."""
        return np.nonzero(self._touched)[0]

    def pending_mass(self, t: float | None = None) -> float:
        """l1 rate mass of the dirty set at time ``t`` (default "now", the
        same clock read :meth:`drain` uses — see :meth:`_at`):

            Σ_dirty |λ̂(t) − λ_synced| + |μ̂(t) − μ_synced|

        Unit: events per event-time unit (a rate, same unit as λ/μ) summed
        over users and both rate kinds — the l1 distance between the
        estimated and the serving-side rate vectors. This is the freshness
        policy's ``max_dirty_mass`` fuel and the scale of the residual the
        push backend reseeds from a drained patch (docs/LOCALPUSH.md)."""
        users = self.dirty
        if users.size == 0:
            return 0.0
        est = self._rates_at(self._at(t), users)
        return float(np.abs(est - self._synced[:, users]).sum())

    def drain(self, t: float | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
        """(users, λ̂, μ̂, mass) of the dirty set; marks it synced, clears.

        The first three fields are exactly one batched ``update_activity``
        patch; ``mass`` is the pre-sync :meth:`pending_mass` of the same
        set (computed here from the one rate evaluation, so callers that
        account for unresolved mass don't pay a second pass). An empty
        stream window drains to empty arrays and zero mass (the serving
        fast path makes that a true no-op).
        """
        users = self.dirty
        if users.size == 0:
            return users, np.empty(0), np.empty(0), 0.0
        est = self._rates_at(self._at(t), users)
        if not np.all(np.isfinite(est)):
            # belt to _tick's suspenders: no drained patch may ever carry a
            # non-finite rate into update_activity/patch_activity
            raise ValueError("non-finite rate estimate in drain; the "
                             "estimator state is corrupt (was a non-finite "
                             "timestamp injected around validation?)")
        mass = float(np.abs(est - self._synced[:, users]).sum())
        self._synced[:, users] = est
        self._touched[users] = False
        return users, est[0].copy(), est[1].copy(), mass

    # -- persistence (crash recovery) ------------------------------------ #
    def state_dict(self) -> dict[str, np.ndarray]:
        """The complete mutable state as flat numpy arrays — checkpointable
        through ``ckpt.checkpoint`` alongside the solver board. Estimator
        state depends only on the *event order*, not on drain boundaries,
        so a restore + exactly-once replay from the persisted offset lands
        on bit-identical rates (repro_torch.resilience.recovery relies on this).
        """
        return dict(
            cnt=self._cnt.copy(), last=self._last.copy(),
            touched=self._touched.copy(), synced=self._synced.copy(),
            scalars=np.asarray([self.t, self.t0, float(self.events)]),
        )

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        """Restore :meth:`state_dict` output (shapes must match ``n``)."""
        cnt = np.asarray(state["cnt"], np.float64)
        if cnt.shape != (2, self.n):
            raise ValueError(f"estimator state is for n={cnt.shape[-1]}, "
                             f"this estimator has n={self.n}")
        self._cnt = cnt.copy()
        self._last = np.asarray(state["last"], np.float64).copy()
        self._touched = np.asarray(state["touched"], bool).copy()
        self._synced = np.asarray(state["synced"], np.float64).copy()
        t, t0, events = np.asarray(state["scalars"], np.float64)
        self.t, self.t0, self.events = float(t), float(t0), int(events)

    def sync_to(self, activity: Activity) -> None:
        """Declare the target's current rates (e.g. its admission-time
        prior) so ``pending_mass`` measures true divergence from day one."""
        if activity.n != self.n:
            raise ValueError("activity/estimator size mismatch")
        self._synced[0] = activity.lam
        self._synced[1] = activity.mu
