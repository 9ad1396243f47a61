"""Numerical health sentinels + quarantine for the ψ serving stack.

The Power-ψ iteration is safe *because* it is a contraction: its iteration
matrix M (the left action of A) has induced l1 norm

    α = ‖M‖₁ = max_j Σ_{i∈L(j)} μ_i / w_j  < 1

whenever any leader set carries post rate (w_j ≥ Σ μ over leaders, with
equality only when every leader's λ is zero). Every convergence statement,
staleness certificate, and error bound in this codebase divides by (1−α) —
so the two things that can silently destroy the stack are (a) a non-finite
value entering the iterate/operators and (b) a patch pushing α to 1. This
module watches for exactly those, plus their downstream symptoms (a gap
that grows instead of contracting, a certificate-rejection storm), and
*quarantines* the offender instead of letting it propagate:

* :class:`Sentinels` — the checks themselves, returning a
  :class:`SentinelTrip` instead of raising (the caller decides the blast
  radius).
* :class:`LaneQuarantine` — wraps a ``TenantFleet``: a tripped lane
  freezes and keeps serving its last-known-good scores while every other
  tenant stays live.
* :class:`ServiceGuard` — wraps a ``PsiService``: rejected patches are
  counted and dropped; a post-resolve trip rolls the service back to the
  last complete checkpoint (rates + cold re-solve).

The JAX package's ``repro.resilience.health``, with two changes: the
array sentinel reads torch tensors on their device as well as numpy arrays,
and :meth:`ServiceGuard.rollback` rebuilds the service's operators from the
graph and the checkpointed rates instead of patching them back (see there).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ckpt import checkpoint
from ..core.activity import Activity
from ..core.operators import HostOperators

__all__ = ["SentinelTrip", "Sentinels", "alpha_norm", "psi_residual_bound",
           "LaneQuarantine", "ServiceGuard"]


@dataclasses.dataclass(frozen=True)
class SentinelTrip:
    """One tripped sentinel: what fired, the value that fired it, context."""

    kind: str        # 'non_finite' | 'alpha' | 'gap_growth' | 'cert_storm'
    value: float
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail} (value={self.value:.6g})"


def alpha_norm(host: HostOperators) -> float:
    """α = ‖M‖₁ = max_j Σ_{i∈L(j)} μ_i / w_j of the *current* host mirror —
    the contraction modulus every certificate divides by. Computed exactly
    like ``HostOperators.b_norm`` but over μ (the iteration matrix) rather
    than λ (the epilogue matrix)."""
    if host.n == 0:
        return 0.0
    row_mu = np.zeros(host.n)
    np.add.at(row_mu, host.src_by_src, host.mu[host.dst_by_src])
    return float((row_mu * host.inv_w).max())


def psi_residual_bound(host: HostOperators, raw_gap: float) -> float | None:
    """Certified per-node ``|ψ_exact − ψ_served|`` from a measured raw l1
    gap ``‖s_{k+1} − s_k‖₁`` (Eq. 19, unscaled).

    Contraction gives ``‖s_k − s*‖₁ ≤ raw_gap / (1 − α)``; the epilogue
    ψᵀ = (sᵀB + dᵀ)/N then bounds each node by

        |ψ_i − ψ*_i| ≤ ‖s_k − s*‖₁ · max_{(j→i)∈E} (λ_i / w_j) / N.

    Returns None when no finite certificate exists (α ≥ 1, or a non-finite
    gap) — an honest "uncertifiable", never a wrong number. This is what
    tags degraded-mode answers (supervisor) with a ``psi_error_bound``.
    """
    a = alpha_norm(host)
    if not (np.isfinite(a) and a < 1.0 and np.isfinite(raw_gap)):
        return None
    if host.m == 0:
        return 0.0
    max_b = float(
        (host.lam[host.dst_by_src] * host.inv_w[host.src_by_src]).max())
    return float(raw_gap / (1.0 - a) * max_b / max(host.n, 1))


class Sentinels:
    """The health checks. Stateless except for the gap-growth window.

    Args:
      alpha_max: trip when post-patch α reaches this (default 1.0 — the
        hard divergence wall; serve-side wrappers may pass e.g. 0.999).
      gap_window: consecutive gap *increases* before the growth sentinel
        trips (a contraction's gap shrinks on average; K strict increases
        in a row means the operators are no longer contracting).
      cert_storm: rejected-certificate count in one run that trips the
        staleness sentinel (the pipeline keeps producing under-tol gaps
        that fail τ-validation — it is spinning, not converging).
    """

    def __init__(self, *, alpha_max: float = 1.0, gap_window: int = 8,
                 cert_storm: int = 50):
        self.alpha_max = float(alpha_max)
        self.gap_window = int(gap_window)
        self.cert_storm = int(cert_storm)
        self._gap_prev: float | None = None
        self._gap_rises = 0
        self.trips: list[SentinelTrip] = []

    def _trip(self, kind: str, value: float, detail: str) -> SentinelTrip:
        trip = SentinelTrip(kind, float(value), detail)
        self.trips.append(trip)
        return trip

    def reset_gap(self) -> None:
        self._gap_prev = None
        self._gap_rises = 0

    # -- checks (None = healthy) ----------------------------------------- #
    def check_array(self, name: str, arr) -> SentinelTrip | None:
        """Non-finite entries of ``arr``: a torch tensor (counted on its
        device, one scalar read) or anything numpy reads."""
        if isinstance(arr, torch.Tensor):
            bad = int((~torch.isfinite(arr)).sum())
        else:
            bad = int(np.sum(~np.isfinite(np.asarray(arr))))
        if bad:
            return self._trip("non_finite", float("nan"),
                              f"{bad} non-finite entries in {name}")
        return None

    def check_alpha(self, host: HostOperators) -> SentinelTrip | None:
        a = alpha_norm(host)
        if not np.isfinite(a) or a >= self.alpha_max:
            return self._trip("alpha", a,
                              f"post-patch α = ‖M‖₁ = {a:.6g} ≥ "
                              f"{self.alpha_max:g}: iteration no longer a "
                              "contraction")
        return None

    def check_gap(self, gap: float) -> SentinelTrip | None:
        if not np.isfinite(gap):
            return self._trip("non_finite", gap, "non-finite Eq. 19 gap")
        if self._gap_prev is not None and gap > self._gap_prev:
            self._gap_rises += 1
            if self._gap_rises >= self.gap_window:
                rises = self._gap_rises
                self.reset_gap()
                return self._trip("gap_growth", gap,
                                  f"Eq. 19 gap grew {rises} checks in a row")
        else:
            self._gap_rises = 0
        self._gap_prev = float(gap)
        return None

    def check_report(self, report) -> SentinelTrip | None:
        """Post-run triage of a driver/scheduler report: non-finite ψ or
        gap, then a certificate-rejection storm."""
        trip = self.check_array("psi", report.psi)
        if trip is None:
            trip = self.check_gap(float(report.gap))
        if trip is None:
            rej = int(getattr(report, "rejected_certificates", 0))
            if rej >= self.cert_storm:
                trip = self._trip("cert_storm", rej,
                                  f"{rej} under-tol certificates rejected "
                                  "for τ-violation in one run")
        return trip


# --------------------------------------------------------------------- #
# Quarantine wrappers
# --------------------------------------------------------------------- #
class LaneQuarantine:
    """Sentinel-guarded patch/serve surface over a :class:`TenantFleet`.

    A poisoned patch against one tenant must not take the fleet down: a
    patch that fails validation is dropped with the lane state untouched;
    a patch that passes validation but trips the α sentinel is *reverted*
    (the pre-patch rates are re-applied) — and in both cases the lane
    **freezes**: it keeps serving the scores it served last, while every
    other lane keeps patching and solving normally. ``unfreeze`` lifts the
    quarantine after the operator investigates.
    """

    def __init__(self, fleet, *, sentinels: Sentinels | None = None):
        self.fleet = fleet
        self.sentinels = sentinels or Sentinels()
        self._frozen: dict[str, np.ndarray] = {}   # tid → last-good ψ
        self.rejected_patches = 0
        self.reverted_patches = 0

    # -- state ----------------------------------------------------------- #
    @property
    def frozen(self) -> tuple:
        return tuple(sorted(self._frozen))

    def is_frozen(self, tenant_id: str) -> bool:
        return tenant_id in self._frozen

    def unfreeze(self, tenant_id: str) -> None:
        self._frozen.pop(tenant_id, None)

    def _freeze(self, tenant_id: str) -> None:
        if tenant_id not in self._frozen:
            # the lane state is healthy here (rejected patches never
            # mutated; reverted patches were rolled back) so the fleet's
            # own solve produces the last-known-good scores to pin
            self._frozen[tenant_id] = np.array(self.fleet.psi(tenant_id))

    # -- guarded mutations ------------------------------------------------ #
    def patch_activity(self, tenant_id: str, users, lam=None, mu=None) -> bool:
        """Apply one tenant's activity patch under quarantine rules.
        Returns True if the patch took, False if it was rejected/reverted
        (lane frozen either way on failure)."""
        if tenant_id in self._frozen:
            self.rejected_patches += 1
            return False
        rec_host = self._rec_host(tenant_id)
        users_arr = np.asarray(users, np.int64).reshape(-1)
        old_lam = rec_host.lam[users_arr].copy()
        old_mu = rec_host.mu[users_arr].copy()
        try:
            self.fleet.patch_activity(tenant_id, users, lam=lam, mu=mu)
        except ValueError:
            # validation wall: nothing mutated — freeze and keep serving
            self.rejected_patches += 1
            self._freeze(tenant_id)
            return False
        trip = self.sentinels.check_alpha(rec_host)
        if trip is not None:
            # α-poison passed validation (finite, ≥ 0): revert the rates,
            # then freeze with the pre-patch scores
            self.fleet.patch_activity(tenant_id, users_arr,
                                      lam=old_lam, mu=old_mu)
            self.reverted_patches += 1
            self._freeze(tenant_id)
            return False
        return True

    # -- guarded reads ---------------------------------------------------- #
    def psi(self, tenant_id: str) -> np.ndarray:
        """The tenant's scores — last-known-good while frozen, live else."""
        if tenant_id in self._frozen:
            return self._frozen[tenant_id].copy()
        return self.fleet.psi(tenant_id)

    def top_k(self, tenant_id: str, k: int) -> tuple[np.ndarray, np.ndarray]:
        psi = self.psi(tenant_id)
        idx = np.argsort(-psi, kind="stable")[: int(k)]
        return idx, psi[idx]

    def _rec_host(self, tenant_id: str) -> HostOperators:
        return self.fleet._rec(tenant_id).host


class ServiceGuard:
    """Sentinel-guarded mutation surface over a :class:`PsiService` with
    checkpoint rollback.

    Every healthy resolve checkpoints (rates + served ψ) through
    ``ckpt.checkpoint`` (atomic, GC'd, corruption-hardened). A patch that
    fails validation is dropped (service untouched, still serving). A
    patch that passes validation but leaves the post-resolve state tripped
    (non-finite ψ, α ≥ 1, runaway gap) triggers :meth:`rollback`: the last
    complete checkpoint's rates are re-applied and ψ is re-solved *cold*
    (a NaN-poisoned warm start would never wash out of the iteration).
    Re-solves run where the service runs (its engine's device and dtype).
    """

    def __init__(self, svc, ckpt_dir: str, *,
                 sentinels: Sentinels | None = None, keep: int = 4):
        self.svc = svc
        self.ckpt_dir = ckpt_dir
        self.sentinels = sentinels or Sentinels()
        self.keep = int(keep)
        self._step = 0
        self.rejected_patches = 0
        self.rollbacks = 0
        svc.resolve()                     # ensure a served fixed point…
        self.checkpoint()                 # …and a rollback point for it

    @property
    def n(self) -> int:
        return self.svc.graph.n

    def checkpoint(self) -> None:
        act = self.svc.engine.activity
        self._step += 1
        checkpoint.save(self.ckpt_dir, self._step,
                        dict(lam=np.asarray(act.lam, np.float64),
                             mu=np.asarray(act.mu, np.float64),
                             psi=np.asarray(self.svc.scores(), np.float64)),
                        keep=self.keep)

    def update_activity(self, users, lam=None, mu=None) -> bool:
        """Guarded patch + resolve; True if the service accepted it and
        stayed healthy, False if it was rejected or rolled back."""
        try:
            self.svc.update_activity(users, lam=lam, mu=mu, resolve=True)
        except ValueError:
            self.rejected_patches += 1     # validation wall: state untouched
            return False
        trip = self._health_trip()
        if trip is not None:
            self.rollback()
            return False
        self.checkpoint()
        return True

    def _health_trip(self) -> SentinelTrip | None:
        res = self.svc.last_result
        trip = self.sentinels.check_array("psi", res.psi)
        if trip is None:
            trip = self.sentinels.check_gap(float(res.gap))
        if trip is None:
            host = HostOperators.from_graph(self.svc.graph,
                                            self.svc.engine.activity)
            trip = self.sentinels.check_alpha(host)
        return trip

    def rollback(self) -> None:
        """Restore the last complete checkpoint: rates back, cold re-solve
        (warm state may be NaN/blown-up — it is discarded, not trusted).

        The operators are rebuilt from the graph and the checkpointed rates
        (``PsiService._full_rebuild``), not patched back: the poisoned
        patch went through the float64 ``w``/``row_lam`` accumulators
        (``w += 1e12`` then ``-= 1e12`` keeps ~1e-4 of absolute error), so
        a patch-back would leave operators that no fresh service has. After
        the rebuild, ψ is bit for bit a fresh service's cold solve with the
        checkpointed rates, in as many iterations."""
        tmpl = dict(lam=np.zeros(self.n), mu=np.zeros(self.n),
                    psi=np.zeros(self.n))
        data = checkpoint.restore_latest(self.ckpt_dir, tmpl)
        if data is None:
            raise RuntimeError("rollback requested but no complete "
                               f"checkpoint exists in {self.ckpt_dir}")
        self.rollbacks += 1
        self.sentinels.reset_gap()
        self.svc._last = None              # poisoned warm start: discard
        self.svc._cache = None
        self.svc._full_rebuild(activity=Activity(data["lam"], data["mu"]))
        self.svc.resolve()                 # no last solve: a cold one

    def scores(self) -> np.ndarray:
        return self.svc.scores()
