"""ψ-score core: the paper's contribution (Power-ψ) plus baselines, the
engines and the service."""
from .activity import Activity, RATE_FLOOR, heterogeneous, homogeneous
from .operators import (PsiOperators, LaneOperators, HostOperators,
                        build_operators, dense_operators)
from .power_psi import PsiResult, power_psi, power_psi_fixed
from .power_nf import PowerNFResult, power_nf
from .pagerank import PageRankResult, build_pagerank_ops, pagerank
from .exact import exact_psi
from .accelerated import power_psi_accelerated
from .engine import (ConvergenceCriterion, EngineState, PsiEngine,
                     ReferenceEngine, AcceleratedEngine, CudaEngine,
                     AutoEngine, DistributedEngine, AsyncEngine,
                     ChunkExtrapolator, make_engine, register_backend,
                     available_backends, make_batched_loop,
                     make_reference_step, make_lane_reference_step,
                     make_dense_step, make_edge_tile_step)
from .incremental import PsiService, RankingCache, RankedQueries

__all__ = [
    "Activity", "RATE_FLOOR", "heterogeneous", "homogeneous",
    "PsiOperators", "LaneOperators", "HostOperators", "build_operators",
    "dense_operators",
    "PsiResult", "power_psi", "power_psi_fixed", "power_psi_accelerated",
    "PowerNFResult", "power_nf",
    "PageRankResult", "build_pagerank_ops", "pagerank", "exact_psi",
    "ConvergenceCriterion", "EngineState", "PsiEngine", "ReferenceEngine",
    "AcceleratedEngine", "CudaEngine", "AutoEngine", "DistributedEngine",
    "AsyncEngine", "ChunkExtrapolator", "make_engine",
    "register_backend", "available_backends", "make_batched_loop",
    "make_reference_step", "make_lane_reference_step", "make_dense_step",
    "make_edge_tile_step",
    "PsiService", "RankingCache", "RankedQueries",
]
