"""2-D sharded message passing: GraphSAGE on block-cyclic feature shards.

A port of the JAX package's ``models/gnn/sharded_mp.py`` onto the port's
:class:`~repro_torch.launch.mesh.Mesh`. The ψ-score 2-D block-cyclic
partition (:func:`~repro_torch.graphs.partition.partition_2d`) lays out
*feature matrices*: rank (r, c) owns the edges with src ∈ block-cyclic row
r and dst ∈ contiguous column block c, and one layer of mean aggregation
costs exactly

    reduce-scatter [Nc, F] over the src group   (the local partials)
  + all-gather     [q, F]  over the model group (reassemble the row shard)

per layer — the same schedule as the distributed ψ push. Where the JAX
package runs ``shard_map`` over the whole mesh, each rank here runs its
own block: the local segment sum goes through the ``seg_mm`` kernel over
an :class:`~repro_torch.models.gnn.common.EdgeAgg` of the block's
``dst_local`` (sentinel ``nc``), ``psum_scatter`` becomes
:meth:`Mesh.reduce_scatter_src` and the tiled ``all_gather``
:meth:`Mesh.all_gather_model`. Forward only, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...graphs.partition import Partition2D, partition_2d
from ...graphs.structure import Graph
from ...launch.mesh import Mesh
from .common import EdgeAgg, edge_agg, segment_agg

__all__ = ["ShardedGraph", "build_sharded_graph", "make_sage_layer",
           "sharded_sage_apply", "features_to_src_layout",
           "features_from_src_layout"]


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """This rank's edge block and in-degree piece, on the mesh's device."""
    src_local: torch.Tensor     # i64[e_max] block-cyclic src ids
    dst_local: torch.Tensor     # i32[e_max] contiguous dst ids; sentinel nc
    deg_piece: torch.Tensor     # f32[q] in-degree of this rank's piece
    agg: EdgeAgg                # the block's real edges onto its nc rows


def build_sharded_graph(graph: Graph, mesh: Mesh, *,
                        bidirectional: bool = True
                        ) -> tuple[Partition2D, ShardedGraph]:
    """The 2-D partition of ``graph`` over ``mesh`` (every rank computes
    the same one) and this rank's block of it."""
    g = graph
    if bidirectional:
        g = Graph(g.n, np.concatenate([g.src, g.dst]),
                  np.concatenate([g.dst, g.src]), name=g.name)
    part = partition_2d(g, mesh.d, mesh.mo)
    deg = np.zeros(part.n_pad, np.float32)
    np.add.at(deg[: g.n], g.dst, 1.0)
    r, c, dev = mesh.row, mesh.col, mesh.device
    dst = part.dst_local[r, c]
    return part, ShardedGraph(
        src_local=torch.as_tensor(part.src_local[r, c], dtype=torch.long,
                                  device=dev),
        dst_local=torch.as_tensor(dst, device=dev),
        deg_piece=torch.as_tensor(part.to_piece_layout(deg)[r, c],
                                  device=dev),
        agg=edge_agg(np.zeros_like(dst), dst, part.nc, device=dev))


def make_sage_layer(part: Partition2D, mesh: Mesh):
    """One mean-aggregate + dense update layer on 2-D sharded features.

    x: f[local_n, F], this rank's row of the block-cyclic src layout
    (replicated over the row's columns); weights replicated. Returns the
    same layout. Collectives: one reduce-scatter and one all-gather."""
    nc, q = part.nc, part.q

    def layer(x, sg: ShardedGraph, w_self, b_self, w_neigh, b_neigh):
        f = x.shape[-1]
        msgs = F.pad(x, (0, 0, 0, 1)).index_select(0, sg.src_local)
        partial = segment_agg(msgs, sg.dst_local, nc, "sum", agg=sg.agg)
        agg_piece = mesh.reduce_scatter_src(partial.reshape(-1)).reshape(q, f)
        mean_piece = agg_piece / torch.clamp(
            sg.deg_piece.to(x.dtype)[:, None], min=1)
        # self features of this piece = local slice c·q … (c+1)·q of row r
        self_piece = x[mesh.col * q:(mesh.col + 1) * q]
        h = F.relu(self_piece @ w_self + b_self
                   + mean_piece @ w_neigh + b_neigh)
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1,
                                                     keepdim=True), min=1e-6)
        # reassemble this row's block-cyclic shard for the next layer
        return mesh.all_gather_model(h).reshape(-1, h.shape[-1])

    return layer


@torch.no_grad()
def sharded_sage_apply(params: dict, x_local: torch.Tensor,
                       part: Partition2D, sg: ShardedGraph, mesh: Mesh,
                       cfg) -> torch.Tensor:
    """Full sharded GraphSAGE forward: features stay 2-D sharded end to
    end. ``x_local``: f[mo·q, d_feat], this rank's row of
    :func:`features_to_src_layout`. Returns this row's logits. No
    gradient flows through it (the collectives are not differentiable)."""
    h = x_local.to(cfg.dtype)
    layer = make_sage_layer(part, mesh)
    for lyr in params["layers"]:
        h = layer(h, sg, lyr["w_self"]["w"], lyr["w_self"]["b"],
                  lyr["w_neigh"]["w"], lyr["w_neigh"]["b"])
    return h @ params["head"]["w"] + params["head"]["b"]


def features_to_src_layout(part: Partition2D, x: np.ndarray) -> np.ndarray:
    """f[n, F] → f[d, mo·q, F] (each column as ``to_src_layout``)."""
    return np.stack([part.to_src_layout(x[:, j]) for j in range(x.shape[1])],
                    -1)


def features_from_src_layout(part: Partition2D, arr: np.ndarray
                             ) -> np.ndarray:
    """f[d, mo·q, F] → f[n, F]."""
    return np.stack([part.from_src_layout(arr[..., j])
                     for j in range(arr.shape[-1])], -1)
