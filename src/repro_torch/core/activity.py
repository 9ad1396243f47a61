"""User activity models: posting rate λ and re-posting rate μ per user.

The paper evaluates two regimes (§V):
  (i)  heterogeneous — λ, μ i.i.d. uniform in (0, 1);
  (ii) homogeneous   — λ = 0.15, μ = 0.85 for everyone, in which case
       ψ == PageRank with damping α = μ/(λ+μ) = 0.85 ([10, Thm 5]).

The paper's model assumes λ^(n), μ^(n) > 0; this container is deliberately
one notch laxer and only *rejects negative* rates: a "silent" user with
λ = μ = 0 is representable (the operators mask the degenerate
c = μ/(λ+μ), d = λ/(λ+μ) normalization to 0 — see
``HostOperators.cd`` — which is also how the fleet's padded lanes stay
inert). Paths that need the paper's strict positivity — notably the
streaming estimator's cold-start users, where λ+μ = 0 would zero a user's
c/d row and silently pin ψ contributions — clamp through
:meth:`Activity.floored` with the shared :data:`RATE_FLOOR`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Activity", "heterogeneous", "homogeneous", "RATE_FLOOR"]

#: Strictly-positive clamp for rates that must not be zero (cold-start
#: users in the streaming estimator, explicit `Activity.floored()` calls).
#: Matches the lower bound of `heterogeneous`'s default (low, high) range,
#: so a floored cold-start user is indistinguishable from the paper's
#: least-active heterogeneous user.
RATE_FLOOR = 1e-3


@dataclasses.dataclass(frozen=True)
class Activity:
    lam: np.ndarray  # posting frequency λ^(n) ≥ 0 (paper assumes > 0)
    mu: np.ndarray   # re-posting frequency μ^(n) ≥ 0 (paper assumes > 0)

    def __post_init__(self):
        if self.lam.shape != self.mu.shape:
            raise ValueError("λ/μ shape mismatch")
        if not (np.all(np.isfinite(self.lam))
                and np.all(np.isfinite(self.mu))):
            raise ValueError("activity rates must be finite")
        if np.any(self.lam < 0) or np.any(self.mu < 0):
            raise ValueError("activity rates must be non-negative")

    @property
    def n(self) -> int:
        return int(self.lam.shape[0])

    @property
    def total(self) -> np.ndarray:
        return self.lam + self.mu

    def astype(self, dtype) -> "Activity":
        return Activity(self.lam.astype(dtype), self.mu.astype(dtype))

    def floored(self, floor: float = RATE_FLOOR) -> "Activity":
        """A strictly-positive copy: both rates clamped to ≥ ``floor``.

        Guarantees λ+μ ≥ 2·floor for every user, so the ψ iteration's
        c = μ/(λ+μ) normalization is non-degenerate everywhere — the
        paper's λ, μ > 0 assumption restored by an explicit clamp. The
        streaming estimator applies the same floor to cold-start users.
        """
        if floor <= 0:
            raise ValueError(f"floor must be > 0; got {floor}")
        return Activity(np.maximum(self.lam, floor),
                        np.maximum(self.mu, floor))


def heterogeneous(n: int, *, seed: int = 0, low: float = 1e-3,
                  high: float = 1.0) -> Activity:
    """i.i.d. uniform rates in (low, high) — regime (i) of the paper."""
    rng = np.random.default_rng(seed)
    return Activity(rng.uniform(low, high, n), rng.uniform(low, high, n))


def homogeneous(n: int, *, lam: float = 0.15, mu: float = 0.85) -> Activity:
    """Uniform rates — regime (ii); ψ reduces to PageRank(α=μ/(λ+μ))."""
    return Activity(np.full(n, lam), np.full(n, mu))
