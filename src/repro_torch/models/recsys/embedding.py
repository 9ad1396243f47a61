"""Embedding substrate for the recsys stack: a port of the JAX package's
``models/recsys/embedding.py``.

* :func:`embedding_bag` — ragged multi-hot bags (sum or mean), sentinel id
  ``vocab`` for padding. The JAX package sums with ``jax.ops.segment_sum``;
  here the gathered rows of a bag go into the slots of an edge-tile layout
  of the bags (:func:`bag_layout`, built once a batch on the host) and are
  summed by the ``seg_mm`` kernel (:func:`repro_torch.kernels.agg.seg_sum`;
  its plain version on a CPU tensor).
* :func:`sharded_lookup` — a row-sharded table: rank ``(row, col)`` of a
  :class:`~repro_torch.launch.mesh.Mesh` holds rows ``[col · rows, (col +
  1) · rows)``, gathers the ids it owns (the rest masked to zero) and the
  model group sums the pieces (:class:`ModelSum`). Ids are split over the
  data rows as the JAX package's ``batch_axes=("pod", "data")`` splits
  them: each rank passes its row's ids. The gradient of a table shard is
  the local scatter-add of the gather; the caller sums it over the rank's
  data column (:meth:`Mesh.all_reduce_src`).

With no mesh, or one model rank, both are the plain gather: nothing is
masked or summed (at ``train_batch`` the negatives' rows alone are 17.2 GB).
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels.agg import EdgeAgg, edge_agg, seg_sum
from ...launch.mesh import ModelSum

__all__ = ["embedding_bag", "bag_layout", "sharded_lookup", "ModelSum",
           "model_ranks"]


def model_ranks(mesh) -> int:
    """The ranks a table is split over: the mesh's ``"model"`` size, 1 with
    no mesh."""
    return 1 if mesh is None else mesh.mo


def _owned_rows(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """f[*ids.shape, d]: this rank's rows of ``ids`` from its table shard,
    zero where another rank owns the id; the plain gather with one model
    rank."""
    rows, d = table.shape
    flat = ids.reshape(-1)
    if model_ranks(mesh) == 1:
        return table.index_select(0, flat).reshape(ids.shape + (d,))
    rel = flat - mesh.col * rows
    ok = (rel >= 0) & (rel < rows)
    emb = table.index_select(0, torch.clamp(rel, 0, rows - 1))
    return (emb * ok[:, None].to(emb.dtype)).reshape(ids.shape + (d,))


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Row-sharded embedding lookup: ``table`` f[rows, d] is this rank's
    shard, ``ids`` i64[...] this rank's ids (global row numbers). Returns
    f[*ids.shape, d], the same on every rank of the model group."""
    emb = _owned_rows(table, ids, mesh)
    if model_ranks(mesh) == 1:
        return emb
    return ModelSum.apply(emb, mesh)


def bag_layout(ids, bag_ids, n_bags: int, vocab: int, *,
               device: str | torch.device = "cuda") -> EdgeAgg:
    """The layout of a batch's bags, on the host: ``ids`` i64[n_idx] and
    ``bag_ids`` i64[n_idx] (numpy, ``bag_ids`` sorted). An id below
    ``vocab`` takes a slot of its bag; the rest (the sentinel ``vocab``)
    take none, so ``in_degree`` counts each bag's valid ids, the divisor of
    the mean."""
    ids = np.asarray(ids, np.int64)
    bag_ids = np.asarray(bag_ids, np.int64)
    dst = np.where(ids < vocab, bag_ids, n_bags)
    return edge_agg(np.zeros_like(dst), dst, n_bags, device=device)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int, *, mode: str = "mean",
                  layout: EdgeAgg | None = None, mesh=None) -> torch.Tensor:
    """EmbeddingBag: ``ids`` i64[n_idx] (sentinel = vocab → zero row; an id
    above it reads as the sentinel), ``bag_ids`` i64[n_idx] sorted. →
    f[n_bags, d]. ``mode="mean"`` divides by the count of valid ids (0 for
    a bag of sentinels). ``layout`` is :func:`bag_layout` of the same
    arrays (built from host copies of them when not given: a sync on a
    card). With a mesh of several model ranks ``table`` is this rank's row
    shard: each rank sums the rows it owns and the model group sums the
    bags."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean'; got {mode!r}")
    vocab = table.shape[0] * model_ranks(mesh)
    if layout is None:
        layout = bag_layout(ids.cpu().numpy(), bag_ids.cpu().numpy(),
                            n_bags, vocab, device=table.device)
    rows = _owned_rows(table, ids.index_select(0, layout.edge_ids), mesh)
    msgs = rows.new_zeros(layout.num_slots, rows.shape[-1]).index_copy(
        0, layout.slots, rows)
    out = seg_sum(msgs, layout)
    if model_ranks(mesh) > 1:
        out = ModelSum.apply(out, mesh)
    if mode == "mean":
        out = out / torch.clamp(layout.in_degree.to(out.dtype), min=1)[:, None]
    return out
