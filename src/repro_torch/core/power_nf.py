"""Power-NF (Algorithm 1 of [10]) — the state-of-the-art baseline.

Solves the news-feed fixed point ``p_i = A p_i + b_i`` *per origin user i*
(N systems of size N), then maps to walls via ``q_i = C p_i + d_i`` and
averages to get ψ_i. This is the method the paper beats; it is implemented
faithfully so Experiments 1–3 can reproduce the comparison.

Faithfulness notes:
  * each origin has its *own* convergence loop (per-column gap & stop);
  * the mat-vec count is per-origin — a chunk iteration with K active
    columns costs K mat-vecs, matching a sequential Alg. 1 run;
  * chunking over origins is purely an execution-layout choice (the paper's
    own library loops origins one by one; the loop body is vectorized).

The chunk loop runs on the operators' device and reads ``active.any()`` on
the host once a step, as the fleet's masked loop does; the JAX package runs
the same body in a ``lax.while_loop``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import numpy_dtype
from .operators import PsiOperators

__all__ = ["PowerNFResult", "power_nf"]


@dataclasses.dataclass(frozen=True)
class PowerNFResult:
    psi: np.ndarray
    matvecs: int            # total N-vector mat-vecs across all origins
    max_iterations: int     # worst per-origin iteration count


def _chunk_solve(ops: PsiOperators, origins: torch.Tensor, *, tol: float,
                 max_iter: int) -> tuple[torch.Tensor, int, int]:
    """Solve p_i = A p_i + b_i for a chunk of origins, per-column stopping."""
    bc = ops.b_columns(origins)                     # [N, K]
    tol_t = torch.tensor(tol, dtype=ops.dtype, device=ops.device)
    p = bc                                          # Alg. 1: p_i ← b_i
    active = torch.ones(origins.shape[0], dtype=torch.bool, device=ops.device)
    matvecs = torch.zeros((), dtype=torch.int64, device=ops.device)
    t = 0
    while t < max_iter and bool(active.any()):
        p_new = ops.right_matvec(p) + bc            # [N, K]
        gaps = torch.sum(torch.abs(p_new - p), dim=0)   # per-column L1
        p = torch.where(active[None, :], p_new, p)  # frozen columns keep value
        matvecs = matvecs + active.sum()
        active = active & (gaps > tol_t)
        t += 1
    # ψ_i = (1/N)(Σ_n c_n p_i^(n) + d_i)   [q_i = C p_i + d_i, then average]
    psi = (ops.c @ p + ops.d[origins]) / ops.n
    return psi, int(matvecs), t


def power_nf(ops: PsiOperators, *, tol: float = 1e-9, max_iter: int = 10_000,
             chunk: int = 256, origins: np.ndarray | None = None
             ) -> PowerNFResult:
    """Run Algorithm 1 for all origins (or a subset) in column chunks."""
    all_origins = (np.arange(ops.n, dtype=np.int64)
                   if origins is None else np.asarray(origins, np.int64))
    psi = np.zeros(all_origins.shape[0], numpy_dtype(ops.dtype))
    total_mv = 0
    worst_t = 0
    for lo in range(0, all_origins.shape[0], chunk):
        sel = all_origins[lo:lo + chunk]
        p_chunk, mv, t = _chunk_solve(
            ops, torch.as_tensor(sel, device=ops.device), tol=tol,
            max_iter=max_iter)
        psi[lo:lo + sel.shape[0]] = p_chunk.cpu().numpy()
        total_mv += mv
        worst_t = max(worst_t, t)
    return PowerNFResult(psi=psi, matvecs=total_mv, max_iterations=worst_t)
