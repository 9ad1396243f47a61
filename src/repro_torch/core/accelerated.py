"""Beyond-paper: extrapolation-accelerated Power-ψ.

True Chebyshev acceleration needs a real spectrum (directed A has complex
eigenvalues), so this is the safe variant for affine contractions: Aitken /
geometric-series extrapolation on the iterate sequence.

For s_{t+1} = s_t A + c the error e_t = s_t − s* satisfies e_{t+1} = e_t A.
Once the iteration enters its dominant-eigenvalue regime, successive
differences Δ_t = s_{t+1} − s_t shrink by ρ per step with a stable direction,
so the remaining tail sums to Δ_t·ρ/(1−ρ):

    s* ≈ s_{t+1} + Δ_{t+1} · r/(1 − r),   r = ‖Δ_{t+1}‖₁/‖Δ_t‖₁

The loop lives in :func:`repro_torch.core.engine._accelerated_loop`, an
engine-level composition around *any* backend's step, so the
``accelerated`` backend and the ``accelerate=True`` option of the ``cuda``
and ``auto`` engines share one implementation. Every jump is verified with
a plain iteration whose gap drives termination, so the Eq. 19 guarantee
holds; a non-improving jump is reverted and disables future jumps, and a
stalled ratio triggers the Krasnoselskii averaging kick.

This module keeps the functional entry point of the JAX package; prefer
``make_engine("accelerated", graph=..., activity=...)`` in new code.
"""
from __future__ import annotations

import torch

from .operators import PsiOperators
from .power_psi import PsiResult

__all__ = ["power_psi_accelerated"]


def power_psi_accelerated(ops: PsiOperators, *, tol: float = 1e-9,
                          max_iter: int = 10_000,
                          extrapolate_every: int = 8,
                          use_b_norm: bool = True) -> PsiResult:
    """Alg. 2 with periodic Aitken extrapolation (beyond-paper).

    ``iterations`` / ``matvecs`` count mat-vecs actually consumed (each
    verification step included) — the honest currency for an extrapolated
    loop.
    """
    from .engine import _accelerated_loop

    def one_step(a, s):
        s_new = a.mu * a.push(s) + a.c
        return s_new, torch.sum(torch.abs(s_new - s))

    scale = ops.b_norm if use_b_norm else torch.ones(
        (), dtype=ops.dtype, device=ops.device)
    s, gap, t = _accelerated_loop(one_step, ops, ops.c, scale, tol, max_iter,
                                  extrapolate_every=extrapolate_every)
    return PsiResult(psi=ops.psi_epilogue(s), s=s, iterations=t,
                     gap=float(gap), converged=bool(gap <= tol),
                     matvecs=t + 1)
