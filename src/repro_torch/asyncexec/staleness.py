"""Bounded-staleness model and the stale-corrected Eq. 19 gap certificate.

The Power-ψ iteration is an affine contraction (ρ(A) < 1, §III-B), so the
asynchronous "chaotic relaxation" theorem of Chazan–Miranker applies: the
fixed point is reached even when each chunk's update reads *stale* values of
the other chunks, as long as the staleness is bounded. :class:`StalenessBound`
pins that bound: no chunk's epoch may lag the fastest chunk by more than
``tau`` epochs, so every partial a step consumes is at most ``tau`` epochs
old.

Termination under staleness needs care. The synchronous Eq. 19 rule stops at
``‖B‖·‖s_t − s_{t−1}‖₁ ≤ ε`` — but an asynchronously assembled gap sums
per-chunk deltas measured at *different* epochs, and a chunk that happens to
be ``σ`` epochs behind under-reports the true residual by up to a factor
``ρ^σ`` (its delta has contracted σ fewer times than it pretends). The
certificate therefore:

* records the epoch **spread** of the contributing per-chunk gaps;
* **inflates** the observed gap by the contraction factor, ``gap · ρ^{−σ}``
  (ρ < 1 ⇒ the inflation is ≥ 1, i.e. pessimistic);
* only marks the result **trusted** when every contributing partial is
  within ``tau`` — a τ-violating assembly is *rejected* outright
  (``trusted = False``), whatever its inflated value says.

The scheduler (:mod:`repro_torch.asyncexec.scheduler`) uses an accepted
certificate only to *gate* the synchronous verification sweep; the final
convergence decision is always a true same-epoch Eq. 19 gap, so the
certificate being a conservative heuristic (ρ is estimated online) can delay
but never corrupt termination.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StalenessBound", "GapCertificate", "certify_gap", "RhoEstimator"]


@dataclasses.dataclass(frozen=True)
class StalenessBound:
    """Maximum epoch lag the scheduler tolerates.

    ``tau = 0`` degenerates to bulk-synchronous execution (every chunk must
    sit at the common epoch before any may advance — a barrier per epoch);
    ``tau ≥ 1`` lets fast chunks run ahead and stragglers fall behind by up
    to ``tau`` epochs before anyone waits.

    ``rho`` is the contraction factor used by the certificate's inflation.
    ``None`` (the default) estimates it online from observed per-epoch gap
    ratios (:class:`RhoEstimator`); a paper-style a-priori bound (e.g. the
    sub-stochastic row-sum bound on A) can be pinned explicitly.
    """

    tau: int = 2
    rho: float | None = None

    def __post_init__(self):
        if self.tau < 0:
            raise ValueError(f"tau must be >= 0; got {self.tau}")
        if self.rho is not None and not (0.0 < self.rho < 1.0):
            raise ValueError(f"rho must be in (0, 1); got {self.rho}")


@dataclasses.dataclass(frozen=True)
class GapCertificate:
    """The stale-corrected Eq. 19 verdict for one assembled global gap."""

    raw_gap: float          # scale · Σ_k latest per-chunk ‖Δs_k‖₁
    certified_gap: float    # raw_gap · ρ^{−spread} (pessimistic correction)
    spread: int             # max − min contributing epoch
    trusted: bool           # every contributing partial within τ
    rho: float              # contraction factor the inflation used

    def accepts(self, tol: float) -> bool:
        """True when the certified (inflated) gap crosses ``tol`` *and* the
        assembly respected the staleness bound. A τ-violating gap is never
        accepted — the scheduler must re-tighten the pipeline first."""
        return self.trusted and self.certified_gap <= tol


def certify_gap(chunk_gaps, chunk_epochs, *, bound: StalenessBound,
                rho: float, scale: float = 1.0) -> GapCertificate:
    """Assemble per-chunk gaps (tagged with the epoch each was measured at)
    into one certified global gap under ``bound``.

    ``chunk_gaps[k]`` is the raw l1 delta of chunk k's latest completed
    step; ``chunk_epochs[k]`` the epoch that step landed on. ``scale`` is
    the Eq. 19 ``‖B‖`` factor (1.0 for an unscaled driver-style gap).
    """
    gaps = np.asarray(chunk_gaps, np.float64)
    epochs = np.asarray(chunk_epochs, np.int64)
    if gaps.size == 0 or gaps.size != epochs.size:
        raise ValueError("need one (gap, epoch) pair per chunk")
    spread = int(epochs.max() - epochs.min())
    raw = float(scale * gaps.sum())
    rho = float(min(max(rho, 1e-6), 1.0 - 1e-9))
    certified = raw * rho ** (-float(spread))
    return GapCertificate(raw_gap=raw, certified_gap=certified,
                          spread=spread, trusted=spread <= bound.tau,
                          rho=rho)


class RhoEstimator:
    """Online contraction-factor estimate from successive global gaps.

    Feeds on gaps observed whenever the *minimum* epoch advances (so the
    ratio spans one genuine global contraction step). The estimate is the
    **minimum** of the recent ratios — the conservative direction: the
    inflation ``ρ^{−σ}`` *grows* as ρ̂ shrinks, so under-estimating ρ
    over-corrects the certified gap (at worst delaying certification; an
    over-estimate would certify gaps the true residual exceeds). Clamped to
    [floor, cap] so one noisy transient ratio can neither blow the
    inflation up unboundedly nor disable it.
    """

    def __init__(self, *, init: float = 0.9, window: int = 8,
                 floor: float = 0.05, cap: float = 0.999):
        self.init = init
        self.window = int(window)
        self.floor = floor
        self.cap = cap
        self.reset()

    def reset(self) -> None:
        self._prev: float | None = None
        self._ratios: list[float] = []

    def update(self, gap: float) -> None:
        if self._prev is not None and self._prev > 0 and np.isfinite(gap):
            r = gap / self._prev
            if np.isfinite(r) and r > 0:
                self._ratios.append(float(r))
                del self._ratios[:-self.window]
        self._prev = float(gap)

    @property
    def value(self) -> float:
        if not self._ratios:
            return self.init
        return float(min(max(min(self._ratios), self.floor), self.cap))
