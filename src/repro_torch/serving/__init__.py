"""Multi-tenant batched ψ-score serving.

``TenantFleet`` multiplexes many independent (graph, activity) tenants onto
one device: tenants are size-bucketed into padded batches
(:mod:`repro_torch.serving.bucket`), each bucket solves as one
convergence-masked Power-ψ loop over its lanes
(:mod:`repro_torch.serving.fleet`; on the card one ``power_step`` launch a
step for the whole bucket), and queries go through the cross-tenant ranking
frontier (:mod:`repro_torch.serving.frontier`).
"""
from .bucket import BucketPolicy, BucketSpec
from .fleet import TenantFleet, TenantView
from .frontier import FleetRankingCache

__all__ = ["BucketPolicy", "BucketSpec", "TenantFleet", "TenantView",
           "FleetRankingCache"]
