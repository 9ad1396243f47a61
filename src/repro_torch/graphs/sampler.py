"""Uniform k-hop fanout neighbour sampler (GraphSAGE ``minibatch_lg``).

Host-side numpy over the CSR neighbour lists — a real sampler, not a stub:
per hop, each frontier node draws ``fanout`` neighbours uniformly with
replacement (matching the original GraphSAGE implementation); the union of
sampled nodes forms the subgraph, re-labelled to local ids and padded to the
static worst-case (batch · Π fanouts) so the compiled step has fixed shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .structure import Graph

__all__ = ["SampledSubgraph", "fanout_sample", "subgraph_budget"]


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    node_ids: np.ndarray     # i64[n_pad] global ids (sentinel −1 on pads)
    src: np.ndarray          # i32[e_pad] local sender (sentinel n_pad)
    dst: np.ndarray          # i32[e_pad] local receiver (sorted, sentinel)
    seed_mask: np.ndarray    # bool[n_pad]
    node_mask: np.ndarray    # bool[n_pad]
    n_pad: int
    e_pad: int


def subgraph_budget(batch_nodes: int, fanout: tuple[int, ...]
                    ) -> tuple[int, int]:
    """Worst-case (nodes, edges) for static padding."""
    n = batch_nodes
    tot_n = batch_nodes
    tot_e = 0
    for f in fanout:
        e = n * f
        tot_e += e
        n = e
        tot_n += e
    return tot_n, tot_e


def fanout_sample(graph: Graph, seeds: np.ndarray, fanout: tuple[int, ...],
                  *, seed: int = 0) -> SampledSubgraph:
    rng = np.random.default_rng(seed)
    src_sorted, dst_sorted = graph.edges_by_src
    indptr = graph.csr_indptr
    n_pad, e_pad = subgraph_budget(seeds.shape[0], fanout)

    frontier = seeds.astype(np.int64)
    all_nodes = [frontier]
    edges_s: list[np.ndarray] = []
    edges_d: list[np.ndarray] = []
    for f in fanout:
        deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
        has = deg > 0
        draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                            (frontier.shape[0], f))
        idx = indptr[frontier][:, None] + draw            # [F, f]
        nbrs = dst_sorted[np.minimum(idx, dst_sorted.shape[0] - 1)]
        nbrs = np.where(has[:, None], nbrs, -1)
        # message edge: neighbour (sender) → frontier node (receiver)
        edges_s.append(nbrs.reshape(-1))
        edges_d.append(np.repeat(frontier, f))
        frontier = nbrs.reshape(-1)
        frontier = frontier[frontier >= 0]
        all_nodes.append(frontier)

    nodes = np.concatenate(all_nodes)
    nodes = nodes[nodes >= 0]
    uniq, inv = np.unique(nodes, return_inverse=True)
    n_local = uniq.shape[0]
    lookup = {int(g): i for i, g in enumerate(uniq)}

    es = np.concatenate(edges_s)
    ed = np.concatenate(edges_d)
    valid = es >= 0
    es, ed = es[valid], ed[valid]
    es_l = np.fromiter((lookup[int(g)] for g in es), np.int32, es.shape[0])
    ed_l = np.fromiter((lookup[int(g)] for g in ed), np.int32, ed.shape[0])
    order = np.argsort(ed_l, kind="stable")
    es_l, ed_l = es_l[order], ed_l[order]

    node_ids = np.full(n_pad, -1, np.int64)
    node_ids[:n_local] = uniq
    src = np.full(e_pad, n_pad, np.int32)
    dst = np.full(e_pad, n_pad, np.int32)
    src[:es_l.shape[0]] = es_l
    dst[:ed_l.shape[0]] = ed_l
    seed_mask = np.zeros(n_pad, bool)
    for s in seeds:
        seed_mask[lookup[int(s)]] = True
    node_mask = np.zeros(n_pad, bool)
    node_mask[:n_local] = True
    return SampledSubgraph(node_ids=node_ids, src=src, dst=dst,
                           seed_mask=seed_mask, node_mask=node_mask,
                           n_pad=n_pad, e_pad=e_pad)
