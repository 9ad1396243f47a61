"""Power-ψ (Algorithm 2 of the paper): fast approximation of the ψ-score.

One left power iteration ``sᵀ ← sᵀA + cᵀ`` starting from ``s₀ = c``, with the
termination rule ``‖B‖ · ‖s_t − s_{t−1}‖ ≤ ε`` which by Eq. (19) guarantees
the ψ trajectory moved less than ε/N, followed by the single epilogue
``ψᵀ = (sᵀB + dᵀ)/N``.

PyTorch runs eagerly, so the loop is a host loop that reads the gap back
after every step; the iteration count and the stopping test are those of the
JAX package's ``lax.while_loop``.
"""
from __future__ import annotations

import dataclasses

import torch

from .operators import PsiOperators

__all__ = ["PsiResult", "power_psi", "power_psi_fixed", "make_power_psi_step"]

_NORMS = {
    "l1": lambda x: torch.sum(torch.abs(x)),
    "l2": lambda x: torch.sqrt(torch.sum(x * x)),
    "linf": lambda x: torch.max(torch.abs(x)),
}


@dataclasses.dataclass(frozen=True)
class PsiResult:
    psi: torch.Tensor       # f[N] — the influence scores
    s: torch.Tensor         # f[N] — converged series Σ cᵀAᵗ
    iterations: int         # power iterations run
    gap: float              # final ‖B‖·‖Δs‖ value
    converged: bool         # gap ≤ tol
    matvecs: int            # sparse mat-vecs consumed (incl. epilogue)


def make_power_psi_step(ops: PsiOperators):
    """One Alg. 2 iteration: s ← sᵀA + c (shared-push edge form)."""

    def step(s: torch.Tensor) -> torch.Tensor:
        return ops.mu * ops.push(s) + ops.c

    return step


def power_psi(ops: PsiOperators, *, tol: float = 1e-9, max_iter: int = 10_000,
              norm: str = "l1", s0: torch.Tensor | None = None,
              use_b_norm: bool = True) -> PsiResult:
    """Run Algorithm 2 to the requested s-tolerance.

    Args:
      ops: precomputed edge-form operators.
      tol: ε of Alg. 2 (on ‖B‖·‖Δs‖ when ``use_b_norm`` else on ‖Δs‖).
      max_iter: safety bound on iterations.
      norm: 'l1' (paper's choice), 'l2' or 'linf'.
      s0: warm-start vector (incremental serving); defaults to c per Alg. 2.
      use_b_norm: keep the paper's ‖B‖ factor inside the gap.
    """
    nrm = _NORMS[norm]
    step = make_power_psi_step(ops)
    scale = ops.b_norm if use_b_norm else torch.ones((), dtype=ops.dtype,
                                                     device=ops.device)
    tol_t = torch.tensor(tol, dtype=ops.dtype)   # compared in the work dtype
    s = ops.c if s0 is None else torch.as_tensor(s0, dtype=ops.dtype,
                                                 device=ops.device)
    gap, t = torch.tensor(float("inf"), dtype=ops.dtype), 0
    while bool(gap > tol_t) and t < max_iter:
        s_new = step(s)
        gap = (scale * nrm(s_new - s)).cpu()
        s, t = s_new, t + 1
    return PsiResult(psi=ops.psi_epilogue(s), s=s, iterations=t,
                     gap=float(gap), converged=bool(gap <= tol_t),
                     matvecs=t + 1)


def power_psi_fixed(ops: PsiOperators, num_iters: int,
                    s0: torch.Tensor | None = None):
    """Fixed-iteration variant (for ablations).

    Returns (psi, s, per-iteration L1 gaps ‖Δs‖ — *without* the ‖B‖ factor).
    """
    step = make_power_psi_step(ops)
    s = ops.c if s0 is None else s0
    gaps = []
    for _ in range(num_iters):
        s_new = step(s)
        gaps.append(torch.sum(torch.abs(s_new - s)))
        s = s_new
    gaps = (torch.stack(gaps) if gaps
            else torch.zeros(0, dtype=ops.dtype, device=ops.device))
    return ops.psi_epilogue(s), s, gaps
