"""Bounded-staleness asynchronous Power-ψ execution.

The contraction ρ(A) < 1 tolerates bounded-stale partials (Chazan–Miranker
chaotic relaxation), so chunk updates need not barrier every epoch:

* :mod:`staleness`  — the τ-lag model and the stale-corrected Eq. 19 gap
  certificate (ρ-inflation, τ-violation rejection); the JAX package's
  module verbatim (pure numpy).
* :mod:`scheduler`  — :class:`ChunkedOperators` (dst-row chunk decomposition
  of the iteration) and :class:`AsyncChunkScheduler` (epoch-tagged
  overlapped dispatch on worker threads, one CUDA stream each on a card,
  straggler absorption, mid-flight O(Δ) patches).
* :mod:`executor`   — :class:`AsyncPsiDriver`, the checkpoint/restart +
  elastic front end sharing :class:`~repro_torch.runtime.psi_driver.
  PsiDriverBase` with the synchronous driver.

The ``"async"`` engine backend (``make_engine("async", ...)``) delegates to
the scheduler, so `PsiService` and every parity harness can run it like any
other backend.
"""
from .executor import AsyncDriverReport, AsyncPsiDriver
from .scheduler import (AsyncChunkScheduler, ChunkArgs, ChunkedOperators,
                        SchedulerRun, make_chunk_step)
from .staleness import (GapCertificate, RhoEstimator, StalenessBound,
                        certify_gap)

__all__ = [
    "AsyncChunkScheduler", "AsyncDriverReport", "AsyncPsiDriver",
    "ChunkArgs", "ChunkedOperators", "GapCertificate", "RhoEstimator",
    "SchedulerRun", "StalenessBound", "certify_gap", "make_chunk_step",
]
