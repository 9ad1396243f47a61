"""Exact ψ-score via direct sparse solve — the ψ_true oracle of Exp. 1–2.

sᵀ = cᵀ(I − A)⁻¹  ⇔  (I − A)ᵀ s = c, solved with a sparse LU (SciPy), then
ψᵀ = (sᵀB + dᵀ)/N. Feasible up to ~10⁵ nodes; the paper uses DBLP (12 591)
for exactly this reason. Host float64 (numpy/scipy) on every device: it is
the oracle the port's solvers are held against.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..graphs.structure import Graph
from .activity import Activity

__all__ = ["exact_psi"]


def exact_psi(graph: Graph, activity: Activity) -> tuple[np.ndarray, np.ndarray]:
    """Return (ψ_true, s_true) in float64."""
    n = graph.n
    lam = activity.lam.astype(np.float64)
    mu = activity.mu.astype(np.float64)
    total = lam + mu
    w = np.zeros(n)
    np.add.at(w, graph.src, total[graph.dst])
    inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(total > 0, mu / total, 0.0)
        d = np.where(total > 0, lam / total, 0.0)

    # Aᵀ[i, j] = A[j, i] = μ_i / w_j for each follow edge (j → i)
    at = sp.csr_matrix(
        (mu[graph.dst] * inv_w[graph.src], (graph.dst, graph.src)),
        shape=(n, n))
    s = spla.spsolve(sp.identity(n, format="csr") - at, c)

    # ψᵀ = (sᵀB + dᵀ)/N with (sᵀB)_i = λ_i Σ_{j→i} s_j / w_j
    push = np.zeros(n)
    np.add.at(push, graph.dst, s[graph.src] * inv_w[graph.src])
    psi = (lam * push + d) / n
    return psi, s
