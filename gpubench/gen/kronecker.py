"""Graph500 Kronecker generator on a torch device.

The Graph500 specification's reference generator (``kronecker_generator``)
draws ``edgefactor · 2^scale`` edges bit by bit with the initiator
probabilities A, B, C (D = 1 − A − B − C), then permutes the vertex
labels. The graph is undirected, as the spec and the LDBC Graphalytics
``graph500-<scale>`` datasets have it: self-loops and duplicate edges are
dropped, every edge is a mutual follow (both arcs), and vertices with no
edge are dropped, as Graphalytics drops them. The arcs are left in the
order of their key ``src · n + dst``; the spec's shuffle of the edge list
is therefore not drawn.

The graph and the users' rates are drawn once, from the configuration's
``structure_seed``; the run's seed draws the spec's label permutation, and
each user's rates move with its label. Every seed is thus the same graph
with the same rates in another order: the same sizes and the same work
(the same arc count, the same degree of each hub), laid out differently in
memory, in the tiles and in the order of every sum. Every draw comes from
a ``torch.Generator`` on ``device``, in a fixed sequence of calls.
"""
from __future__ import annotations

import torch

from gpubench.gen.rates import uniform_rates

__all__ = ["generate"]


def kronecker_edges(scale: int, edge_factor: int, a: float, b: float,
                    c: float, gen: torch.Generator,
                    device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The spec's sampled edge list before its label permutation: i64
    (u, v) of ``edge_factor · 2^scale`` edges (loops and duplicates
    kept)."""
    n = 1 << scale
    m = edge_factor * n
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        src |= ii.to(torch.int64) << bit
        dst |= jj.to(torch.int64) << bit
    return src, dst


def undirected_arcs(n: int, u: torch.Tensor,
                    v: torch.Tensor) -> tuple[int, torch.Tensor,
                                              torch.Tensor]:
    """(n', src, dst): each edge {u, v} with u ≠ v once, as both arcs,
    sorted by key, over the n' vertices that have an edge, renumbered
    0..n'−1 in the order of their ids."""
    keep = u != v
    u, v = u[keep], v[keep]
    key = torch.unique(torch.cat([u * n + v, v * n + u]))
    src, dst = key // n, key % n
    present = torch.zeros(n, dtype=torch.bool, device=u.device)
    present[src] = True
    new_id = torch.cumsum(present, 0) - 1
    return int(present.sum()), new_id[src], new_id[dst]


def generate(params: dict, seed: int, device: torch.device) -> dict:
    """One undirected graph as arcs, and its rates: ``n``, i32 ``src`` /
    ``dst`` (``src`` follows ``dst``; both arcs of every edge) and f64
    ``lam`` / ``mu`` on ``device``, and ``sampled`` (the edge count the
    generator drew)."""
    shape = torch.Generator(device=device)
    shape.manual_seed(int(params["structure_seed"]))
    scale = int(params["scale"])
    u, v = kronecker_edges(scale, int(params["edge_factor"]),
                           float(params["A"]), float(params["B"]),
                           float(params["C"]), shape, device)
    sampled = int(u.numel())
    n, src, dst = undirected_arcs(1 << scale, u, v)
    del u, v
    lam, mu = uniform_rates(n, float(params["rate_low"]),
                            float(params["rate_high"]), shape, device)
    labels = torch.Generator(device=device)
    labels.manual_seed(int(seed))
    perm = torch.randperm(n, generator=labels, device=device)
    key, _ = torch.sort(perm[src] * n + perm[dst])
    del src, dst
    moved_lam, moved_mu = torch.empty_like(lam), torch.empty_like(mu)
    moved_lam[perm] = lam
    moved_mu[perm] = mu
    return dict(n=n, src=(key // n).to(torch.int32),
                dst=(key % n).to(torch.int32), lam=moved_lam, mu=moved_mu,
                sampled=sampled)
