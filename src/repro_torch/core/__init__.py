"""ψ-score core: activity, operators, Power-ψ, the engines and the service."""
from .activity import Activity, RATE_FLOOR, heterogeneous, homogeneous
from .operators import (PsiOperators, HostOperators, build_operators,
                        dense_operators)
from .power_psi import PsiResult, power_psi, power_psi_fixed
from .accelerated import power_psi_accelerated
from .engine import (ConvergenceCriterion, EngineState, PsiEngine,
                     ReferenceEngine, AcceleratedEngine, CudaEngine,
                     AutoEngine, make_engine, register_backend,
                     available_backends)
from .incremental import PsiService, RankingCache, RankedQueries

__all__ = [
    "Activity", "RATE_FLOOR", "heterogeneous", "homogeneous",
    "PsiOperators", "HostOperators", "build_operators", "dense_operators",
    "PsiResult", "power_psi", "power_psi_fixed", "power_psi_accelerated",
    "ConvergenceCriterion", "EngineState", "PsiEngine", "ReferenceEngine",
    "AcceleratedEngine", "CudaEngine", "AutoEngine", "make_engine",
    "register_backend", "available_backends",
    "PsiService", "RankingCache", "RankedQueries",
]
