"""A GNN batch's nodes and edges split over the data ranks: the layout, its
collectives as autograd functions, and a rank's shard of a whole batch.

The JAX package's GNN cells give the node arrays and the edge arrays the
spec ``P(("pod", "data"))`` wherever they split (``launch/specs.py``
``build_gnn_cell``) and let XLA partition every gather and segment sum.
Here a :class:`GraphSplit` on a
:class:`~repro_torch.models.gnn.common.GraphBatch` says how the batch lies
over the **src group** of a :class:`~repro_torch.launch.mesh.Mesh` (the
``d`` ranks of a column, ``pod`` × ``data``), rule for rule:

* node rows (``x``, ``pos``, ``node_mask``, ``graph_ids``, ``seed_mask``,
  node labels): rank row ``r`` holds ``[r·n/d, (r+1)·n/d)`` when
  ``n % d == 0``, else every row;
* edges (``src``, ``dst``): ``[r·e/d, (r+1)·e/d)`` of the padded,
  dst-sorted arrays when ``e % d == 0``, else every edge; node ids stay
  global (sentinel ``n``);
* graph labels, parameters and optimizer state whole on every rank.

The schedule is the baseline one, what XLA's partitioning of a gather and
a scatter computes:

* the senders' rows: an all-gather of the node rows over the src group
  (:func:`gather_nodes`; backward a reduce-scatter);
* a rank computes the messages of its own edges;
* sum and mean: the local messages summed into all ``n`` rows (``seg_mm``),
  then reduce-scattered onto the rows' owners (:func:`finish_rows`;
  backward an all-gather);
* max, min and the softmax's maximum: an all-reduce with ``max`` (``min``)
  over the src group (:class:`Extreme`, which also counts a row's ties
  over every rank, as the one-device gradient splits a row's cotangent
  evenly over its ties).

Gradients are shares: the cotangent a rank holds for a tensor that is
whole on every rank is its share (the shares sum to the true cotangent),
and each rank's parameter gradient is its share, summed over the src group
by ``launch/train.py``'s ``train_step``. A loss reduction over node rows
goes through :func:`total`: :class:`~repro_torch.launch.mesh.SrcSum` where
the rows split (each rank sums its own rows), a ``1/d`` share of the
cotangent where every rank holds every row.

A split that needs no collective (one rank, or neither nodes nor edges
splitting) is no split: :func:`split_flags` gives None, the batch carries
no :class:`GraphSplit`, and every function of ``common.py`` runs its
one-device code.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ...launch.mesh import SrcSum

__all__ = ["GraphSplit", "split_flags", "row_range", "gather_nodes",
           "finish_rows", "own_rows", "psum", "total", "Extreme",
           "shard_batch"]


@dataclasses.dataclass(frozen=True)
class GraphSplit:
    """How a batch lies over the src group of ``mesh``; see the module
    docstring. ``in_degree`` holds, for each of this rank's node rows, the
    real edges into it over every rank (a padded row 0)."""
    mesh: Any
    n: int                      # node slots of the whole batch
    e: int                      # edge slots of the whole batch
    nodes: bool                 # node rows split over the src group
    edges: bool                 # edges split over the src group
    in_degree: torch.Tensor     # i64[rows]

    def node_range(self) -> tuple[int, int]:
        return row_range(self.n, self.mesh, self.nodes)


def split_flags(n: int, e: int, mesh) -> tuple[bool, bool] | None:
    """(nodes split, edges split) of a batch of ``n`` nodes and ``e`` edges
    over the src group of ``mesh``: JAX's rule, a dimension splits when the
    group divides it. None when nothing splits (no mesh, one rank, or
    neither dimension divisible)."""
    d = 1 if mesh is None else mesh.d
    if d == 1:
        return None
    nodes, edges = n % d == 0, e % d == 0
    return (nodes, edges) if nodes or edges else None


def row_range(size: int, mesh, split: bool) -> tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``size`` rows: its src-group row's
    equal share when ``split``, else all of them."""
    if not split:
        return 0, size
    part = size // mesh.d
    return mesh.row * part, (mesh.row + 1) * part


# --------------------------------------------------------------------- #
# Collectives with their transposes
# --------------------------------------------------------------------- #
class _GatherRows(torch.autograd.Function):
    """Forward: the node rows of every rank of the src group, in row order.
    Backward: the cotangent shares summed and scattered back onto the
    owners (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather_src_dim(x, 0)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter_src_dim(grad, 0), None


class _ScatterRows(torch.autograd.Function):
    """Forward: partial sums over all rows, summed over the src group, each
    rank keeping its own rows (a reduce-scatter). Backward: every rank's
    rows' cotangent to every rank (an all-gather)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.reduce_scatter_src_dim(x, 0)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather_src_dim(grad, 0), None


class _PSum(torch.autograd.Function):
    """Forward: partial sums summed over the src group, whole on every
    rank. Backward: the shares of the cotangent summed the same way (each
    rank's partial receives the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_src(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_src(grad), None


class _Share(torch.autograd.Function):
    """Forward: ``x`` as it is (whole on every rank). Backward: a ``1/d``
    share of the cotangent, so that the ``d`` ranks' shares sum to it."""

    @staticmethod
    def forward(ctx, x, d):
        ctx.d = d
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.d, None


def gather_nodes(x: torch.Tensor, split: GraphSplit | None) -> torch.Tensor:
    """Every node row of ``x`` (this rank's rows in, all ``n`` out); ``x``
    itself where the rows do not split."""
    if split is None or not split.nodes:
        return x
    return _GatherRows.apply(x, split.mesh)


def own_rows(x: torch.Tensor, split: GraphSplit | None) -> torch.Tensor:
    """This rank's rows of a tensor of every node row."""
    if split is None or not split.nodes:
        return x
    lo, hi = split.node_range()
    return x[lo:hi]


def finish_rows(partial: torch.Tensor,
                split: GraphSplit | None) -> torch.Tensor:
    """This rank's node rows of a sum over every edge, from ``partial``:
    the sum over this rank's edges into all ``n`` rows."""
    if split is None:
        return partial
    if split.edges:
        if split.nodes:
            return _ScatterRows.apply(partial, split.mesh)
        return _PSum.apply(partial, split.mesh)
    return own_rows(partial, split)          # every edge here: complete


def psum(partial: torch.Tensor, split: GraphSplit | None) -> torch.Tensor:
    """A sum over every edge, whole on every rank, from this rank's edges'
    ``partial`` (itself where the edges do not split)."""
    if split is None or not split.edges:
        return partial
    return _PSum.apply(partial, split.mesh)


def total(x: torch.Tensor, split: GraphSplit | None) -> torch.Tensor:
    """A loss reduction over node rows, whole on every rank: ``x`` is this
    rank's rows' sum where the rows split (summed over the src group,
    :class:`SrcSum`), else already the whole sum (its cotangent shared
    ``1/d`` a rank)."""
    if split is None:
        return x
    if split.nodes:
        return SrcSum.apply(x, split.mesh)
    return _Share.apply(x, split.mesh.d)


class Extreme(torch.autograd.Function):
    """The max (``kind="max"``) or min of each node's incoming edge rows
    over every rank's edges: this rank's edges reduced into ``n + 1`` rows
    (from ∓inf; the sentinel row ``n`` dropped), all-reduced over the src
    group; this rank's node rows out (∓inf where a row has no edge).

    Backward: a row's cotangent split evenly over the edges that reach its
    extreme on any rank (the count all-reduced in the forward), as
    ``scatter_reduce``'s gradient splits it on one device."""

    @staticmethod
    def forward(ctx, values, dst, split, kind):
        mesh, n = split.mesh, split.n
        idx = dst.long().reshape((-1,) + (1,) * (values.dim() - 1)
                                 ).expand_as(values)
        fill = float("-inf") if kind == "max" else float("inf")
        part = values.new_full((n + 1,) + values.shape[1:], fill)
        part = part.scatter_reduce(0, idx, values,
                                   "amax" if kind == "max" else "amin")
        m = mesh.all_reduce_src(part[:n], op=kind)
        m_p = torch.cat([m, part[n:]])
        hit = (values == m_p.gather(0, idx)) & (idx < n)
        cnt = values.new_zeros((n + 1,) + values.shape[1:]).scatter_add(
            0, idx, hit.to(values.dtype))[:n]
        ctx.save_for_backward(hit, mesh.all_reduce_src(cnt), dst)
        ctx.split = split
        return own_rows(m, split)

    @staticmethod
    def backward(ctx, grad):
        hit, cnt, dst = ctx.saved_tensors
        split = ctx.split
        whole = (split.mesh.all_gather_src_dim(grad, 0) if split.nodes
                 else split.mesh.all_reduce_src(grad))
        each = torch.cat([whole / torch.clamp(cnt, min=1),
                          whole.new_zeros((1,) + whole.shape[1:])])
        idx = dst.long().reshape((-1,) + (1,) * (hit.dim() - 1)
                                 ).expand_as(hit)
        return (torch.where(hit, each.gather(0, idx), 0.0), None, None,
                None)


# --------------------------------------------------------------------- #
# A rank's shard of a whole batch
# --------------------------------------------------------------------- #
def shard_batch(batch, mesh):
    """This rank's shard of a whole padded, dst-sorted ``batch`` (a
    :class:`~repro_torch.models.gnn.common.GraphBatch` with its format):
    its node rows and its edges by :func:`split_flags`, the format rebuilt
    over its edges (on the host), the global in-degree of its rows from the
    whole batch's format. The batch itself when nothing splits."""
    from .common import edge_agg
    e = batch.src.shape[0]
    flags = split_flags(batch.n, e, mesh)
    if flags is None:
        return batch
    nodes, edges = flags
    nlo, nhi = row_range(batch.n, mesh, nodes)
    elo, ehi = row_range(e, mesh, edges)

    def rows(a):
        return None if a is None else a[nlo:nhi]

    src, dst = batch.src[elo:ehi], batch.dst[elo:ehi]
    labels = batch.labels
    if labels is not None and labels.shape[0] == batch.n:
        labels = rows(labels)
    dev = batch.device
    split = GraphSplit(mesh=mesh, n=batch.n, e=e, nodes=nodes, edges=edges,
                       in_degree=batch.agg.in_degree[nlo:nhi])
    return dataclasses.replace(
        batch, x=rows(batch.x), src=src, dst=dst, pos=rows(batch.pos),
        node_mask=rows(batch.node_mask), graph_ids=rows(batch.graph_ids),
        labels=labels, seed_mask=rows(batch.seed_mask),
        agg=edge_agg(src.cpu().numpy(), dst.cpu().numpy(), batch.n,
                     device=dev),
        split=split)
