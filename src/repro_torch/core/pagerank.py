"""PageRank power method (Eq. 22) — the speed yardstick of the paper.

πᵀ_t = α πᵀ_{t−1} W + (1−α)/N 1ᵀ with W = D_out⁻¹ L (row-normalized
follower→leader adjacency; rows of dangling users are zero, making W
sub-stochastic — exactly the structure ψ's A has in the homogeneous case,
so ψ(λ=const, μ=const) == PageRank(α = μ/(λ+μ)) holds verbatim [10, Thm 5].

The step is the push of :class:`~repro_torch.core.operators.PsiOperators`
with 1/outdeg in place of 1/w: a segmented sum over each node's follower run
(dst-sorted edges), in a fixed order on every device. The JAX package's
``lax.while_loop`` becomes a loop on the device that reads the gap on the
host once a step; the stop rule (``gap > tol``) and the iteration count are
the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph

__all__ = ["PageRankResult", "PageRankOps", "build_pagerank_ops", "pagerank"]


@dataclasses.dataclass(frozen=True)
class PageRankOps:
    n: int
    src_by_dst: torch.Tensor   # i64[M] follower endpoint, edges sorted by dst
    in_degree: torch.Tensor    # i64[N] segment lengths of the dst-sorted view
    inv_outdeg: torch.Tensor   # f[N] 1/outdeg, 0 for dangling


@dataclasses.dataclass(frozen=True)
class PageRankResult:
    pi: torch.Tensor
    iterations: int
    gap: float
    converged: bool
    matvecs: int


def build_pagerank_ops(graph: Graph, *, dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> PageRankOps:
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    outdeg = graph.out_degree.astype(np_dtype)
    inv = np.where(outdeg > 0, 1.0 / np.where(outdeg > 0, outdeg, 1), 0.0)
    s_d, _ = graph.edges_by_dst
    return PageRankOps(
        n=graph.n,
        src_by_dst=torch.as_tensor(s_d.astype(np.int64), device=dev),
        in_degree=torch.as_tensor(graph.in_degree.astype(np.int64),
                                  device=dev),
        inv_outdeg=torch.tensor(inv.astype(np_dtype), device=dev))


def pagerank(ops: PageRankOps, *, alpha: float = 0.85, tol: float = 1e-9,
             max_iter: int = 10_000, pi0: torch.Tensor | None = None
             ) -> PageRankResult:
    dtype, dev = ops.inv_outdeg.dtype, ops.inv_outdeg.device
    teleport = torch.tensor((1.0 - alpha) / ops.n, dtype=dtype, device=dev)
    a = torch.tensor(alpha, dtype=dtype, device=dev)
    tol_t = torch.tensor(tol, dtype=dtype)       # compared in the work dtype

    def step(pi):
        contrib = (pi * ops.inv_outdeg)[ops.src_by_dst]
        agg = torch.segment_reduce(contrib, "sum", lengths=ops.in_degree,
                                   unsafe=True)
        return a * agg + teleport

    pi = (torch.full((ops.n,), 1.0 / ops.n, dtype=dtype, device=dev)
          if pi0 is None else torch.as_tensor(pi0, dtype=dtype, device=dev))
    gap, t = torch.tensor(float("inf"), dtype=dtype), 0
    while bool(gap > tol_t) and t < max_iter:
        pi_new = step(pi)
        gap = torch.sum(torch.abs(pi_new - pi)).cpu()
        pi, t = pi_new, t + 1
    return PageRankResult(pi=pi, iterations=t, gap=float(gap),
                          converged=bool(gap <= tol_t), matvecs=t)
