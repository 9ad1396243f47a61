"""Certified top-k early stop from the push residual.

The push certificate gives per-node confidence intervals
``ψ_i ∈ [ψ̂_i − E_i, ψ̂_i + E_i]`` (uniform-E from
:func:`repro_torch.localpush.push.cert_scale`, or the tighter per-node radii
from :func:`repro_torch.localpush.push.neumann_error_bound`). The top-k *set*
is exact as soon as every member's lower bound clears every non-member's
upper bound:

    min_{i ∈ top-k} (ψ̂_i − E_i)  >  max_{j ∉ top-k} (ψ̂_j + E_j)
    ⇒  {top-k of ψ̂} = {top-k of ψ_exact}.

With a uniform bound this reduces to the classic margin test
``ψ̂_(k) − ψ̂_(k+1) > 2E``. A ``top_k`` query can stop pushing at that
separation — typically long before the global tolerance — which is the
query-driven termination rule the resource-constrained influence
literature argues for. Note the guarantee is on the *set*; the internal
order of near-tied members may still differ at margins within their
interval widths.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["TopKCertificate", "certify_top_k"]


@dataclasses.dataclass(frozen=True)
class TopKCertificate:
    """Outcome of one rank-separation check against the residual bound."""

    k: int
    indices: np.ndarray       # i64[k] — ψ̂-descending (stable tie-break)
    values: np.ndarray        # f64[k] — ψ̂ at those indices
    err_bound: float | None   # max per-node |ψ_i − ψ̂_i| radius (None: unknown)
    margin: float             # ψ̂_(k) − ψ̂_(k+1) (inf when k ≥ N)
    certified: bool           # intervals separate — top-k set is exact

    def __post_init__(self):
        object.__setattr__(self, "indices",
                           np.asarray(self.indices, np.int64))
        object.__setattr__(self, "values",
                           np.asarray(self.values, np.float64))


def certify_top_k(psi: np.ndarray, k: int,
                  err_bound) -> TopKCertificate:
    """Rank-separation check on the current ψ̂ estimate.

    ``err_bound`` is a scalar uniform per-node error bound, an ``f[N]``
    array of per-node radii, or ``None``; ``None`` (or any non-finite
    radius) means no bound is available and the result cannot certify —
    the indices are still the best current estimate. The reported
    ``err_bound`` field is the max radius.
    """
    psi = np.asarray(psi, np.float64).reshape(-1)
    n = psi.size
    k = max(0, min(int(k), n))
    radii: np.ndarray | None = None
    if err_bound is not None:
        radii = np.broadcast_to(
            np.asarray(err_bound, np.float64), (n,))
    bounded = radii is not None and bool(np.isfinite(radii).all())
    worst = float(radii.max(initial=0.0)) if bounded else None
    if k == 0:
        return TopKCertificate(0, np.empty(0, np.int64), np.empty(0),
                               worst, math.inf, bounded)
    if k >= n:
        order = np.lexsort((np.arange(n), -psi))
        return TopKCertificate(k, order, psi[order],
                               worst, math.inf, bounded)   # whole set
    top = np.argpartition(-psi, k - 1)[:k]
    order = top[np.lexsort((top, -psi[top]))]
    mask = np.ones(n, bool)
    mask[top] = False
    margin = float(psi[order[-1]] - psi[mask].max())
    certified = bool(
        bounded
        and (psi[order] - radii[order]).min()
        > (psi[mask] + radii[mask]).max())
    return TopKCertificate(k, order, psi[order], worst, margin, certified)
