"""Cross-tenant query frontier: one ranking surface over a whole fleet.

:class:`FleetRankingCache` is the fleet's analogue of the single-tenant
:class:`repro_torch.core.incremental.RankingCache`: it memoizes one descending
order per (tenant, fixed point) and exposes the batched read surface the
serving loop actually issues —

* ``scores_batch(tenant_ids, users)`` — aligned (tenant, user) pairs in one
  call, grouped per tenant internally so each tenant's ψ is touched once;
* ``top_k(tenant_id, k)`` / ``rank_of(tenant_id, users)`` — per-tenant
  rankings off the memoized order;
* ``global_top_k(k)`` — the fleet-wide frontier: the k highest-ψ users
  across *all* tenants (per-tenant ``torch.topk`` prefilter, then one merge
  of ≤ T·k candidates);
* ``staleness(tenant_id)`` / ``epoch(tenant_id)`` — how many mutations a
  tenant's served ψ is behind, without forcing a solve.

Every query method (except the staleness probes) first lets the fleet
re-solve whatever is dirty, so reads are always against fresh fixed points;
a tenant whose epoch did not move keeps its cached sort (and its bitwise
ψ — clean lanes are masked out of the batched loop entirely).

The port of the JAX package's ``repro.serving.frontier``: the fleet keeps
each tenant's ψ on the host, and its ranking is a
:class:`~repro_torch.core.incremental.RankingCache` over that vector.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.incremental import RankingCache

__all__ = ["FleetRankingCache"]


class FleetRankingCache:
    """Batched ranking queries across every tenant of a fleet."""

    def __init__(self, fleet):
        self._fleet = fleet
        self._caches: dict[str, tuple[int, RankingCache]] = {}

    # -- staleness / epoch probes (no solve triggered) ------------------- #
    def epoch(self, tenant_id: str) -> int:
        return self._fleet._rec(tenant_id).epoch

    def staleness(self, tenant_id: str) -> int:
        """Mutations applied since the served ψ was solved (0 = fresh)."""
        return self._fleet._rec(tenant_id).staleness

    def drop(self, tenant_id: str) -> None:
        """Forget a tenant's cached ranking (fleet calls this on evict)."""
        self._caches.pop(tenant_id, None)

    # -- per-tenant cache ------------------------------------------------ #
    def ranking(self, tenant_id: str) -> RankingCache:
        """The tenant's memoized RankingCache, refreshed iff its ψ moved."""
        self._fleet.solve()
        rec = self._fleet._rec(tenant_id)
        entry = self._caches.get(tenant_id)
        if entry is None or entry[0] != rec.solved_epoch:
            entry = (rec.solved_epoch,
                     RankingCache(torch.from_numpy(rec.psi)))
            self._caches[tenant_id] = entry
        return entry[1]

    # -- queries --------------------------------------------------------- #
    def scores_batch(self, tenant_ids, users) -> np.ndarray:
        """ψ for aligned (tenant, user) pairs — one fleet solve, one pass
        over each distinct tenant."""
        tenant_ids = list(tenant_ids)
        users = np.asarray(users)
        if users.shape != (len(tenant_ids),):
            raise ValueError(f"users must align with tenant_ids: "
                             f"{users.shape} vs {len(tenant_ids)}")
        self._fleet.solve()
        out = np.empty(len(tenant_ids),
                       np.dtype(self._fleet._np_dtype))
        tids = np.asarray(tenant_ids, object)
        for tid in set(tenant_ids):
            sel = np.where(tids == tid)[0]
            out[sel] = self.ranking(tid).scores_batch(users[sel])
        return out

    def top_k(self, tenant_id: str, k: int) -> tuple[np.ndarray, np.ndarray]:
        return self.ranking(tenant_id).top_k(k)

    def rank_of(self, tenant_id: str, users) -> np.ndarray:
        return self.ranking(tenant_id).rank_of(np.asarray(users))

    def global_top_k(self, k: int) -> list[tuple[str, int, float]]:
        """The k most influential (tenant, user, ψ) triples fleet-wide."""
        self._fleet.solve()
        cands: list[tuple[float, str, int]] = []
        for tid in self._fleet.tenant_ids:
            idx, vals = self.ranking(tid).top_k(k)
            cands.extend((float(v), tid, int(u))
                         for u, v in zip(idx, vals))
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        return [(tid, user, score) for score, tid, user in cands[:k]]
