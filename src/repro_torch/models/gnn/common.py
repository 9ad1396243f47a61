"""Shared GNN substrate: graph batches, segment aggregation, MLPs.

A port of the JAX package's ``models/gnn/common.py``. Edges are dst-sorted
with sentinel padding (src = dst = n). Sum and mean aggregation go through
the ``seg_mm`` kernel (:mod:`repro_torch.kernels.seg_mm`) over an edge-tile
format of the batch's real edges (:class:`EdgeAgg`); sentinel edges are
dropped when the format is built, where the JAX package aggregates them into
a dropped segment ``n``. Max, min, the segment softmax and graph pooling are
plain torch. ``EdgeAgg``, ``edge_agg`` and ``DEFAULT_TILES`` live in
:mod:`repro_torch.kernels.agg` and are re-exported here.

A batch split over the data ranks carries a
:class:`~repro_torch.models.gnn.parallel.GraphSplit` (``batch.split``): its
arrays are the rank's node rows and edges (node ids global), and the
functions here take the split (``split=``, or the batch's) and run the
collectives of :mod:`repro_torch.models.gnn.parallel`; without one each
does the one-device computation.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...kernels.agg import DEFAULT_TILES, EdgeAgg, edge_agg
from ...kernels.agg import seg_sum as _seg_sum
from . import parallel
from .parallel import GraphSplit

__all__ = ["GraphBatch", "EdgeAgg", "edge_agg", "segment_agg",
           "neighbor_agg", "segment_softmax", "graph_pool", "mlp_init",
           "mlp_apply", "dense_init", "batch_from_graph", "pad_graph_batch",
           "tensors_to", "params_to", "node_xent", "in_degree",
           "DEFAULT_TILES"]


def _scatter_extreme(values: torch.Tensor, dst: torch.Tensor, n: int,
                     reduce: str) -> torch.Tensor:
    """f[n + 1, ...]: the max or min of each segment; 0 where empty."""
    idx = dst.long().reshape((-1,) + (1,) * (values.dim() - 1))
    return values.new_zeros((n + 1,) + values.shape[1:]).scatter_reduce(
        0, idx.expand_as(values), values, reduce, include_self=False)


def _per_node(cnt: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return cnt.to(like.dtype).reshape((-1,) + (1,) * (like.dim() - 1))


def segment_agg(values: torch.Tensor, dst: torch.Tensor, n: int, kind: str,
                *, agg: EdgeAgg | None = None,
                split: GraphSplit | None = None) -> torch.Tensor:
    """Aggregate edge rows onto nodes. kind ∈ {sum, mean, max, min, std}.

    ``values`` f[e, ...] per edge, ``dst`` i32[e] (sentinel ``n``). Sum and
    mean scatter the rows into the slots of ``agg`` (built from ``dst`` when
    not given) and run ``seg_mm``. With a ``split`` the edges are this
    rank's and the result this rank's node rows, over every rank's edges:
    sums reduce-scattered, extremes all-reduced, the std's mean gathered
    back to the edges."""
    if kind in ("sum", "mean"):
        if agg is None:
            d_host = dst.cpu().numpy()
            agg = edge_agg(np.zeros_like(d_host), d_host, n,
                           device=values.device)
        flat = values.reshape(values.shape[0], -1)
        msgs = flat.new_zeros(agg.num_slots, flat.shape[1]).index_copy(
            0, agg.slots, flat.index_select(0, agg.edge_ids))
        s = parallel.finish_rows(_seg_sum(msgs, agg), split)
        s = s.reshape((s.shape[0],) + values.shape[1:])
        if kind == "sum":
            return s
        deg = agg.in_degree if split is None else split.in_degree
        return s / torch.clamp(_per_node(deg, s), min=1)
    if kind in ("max", "min"):
        if split is not None and split.edges:
            m = parallel.Extreme.apply(values, dst, split, kind)
        else:
            m = parallel.own_rows(_scatter_extreme(
                values, dst, n, "amax" if kind == "max" else "amin")[:n],
                split)
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    if kind == "std":
        # the two-pass variance mean((x − mean)²): the same function as the
        # JAX package's mean(x²) − mean² (clamped alike), which at float32
        # keeps only var / mean(x²) of its precision and loses the rest in
        # the subtraction (PNA's full-width encoder gradient: 8.8e-5 rel L2
        # from float64 against 4.4e-7 two-pass)
        mean = parallel.gather_nodes(
            segment_agg(values, dst, n, "mean", agg=agg, split=split), split)
        mean_p = torch.cat([mean, mean.new_zeros((1,) + mean.shape[1:])])
        dev = values - mean_p.index_select(0, torch.clamp(dst.long(), max=n))
        var = segment_agg(dev * dev, dst, n, "mean", agg=agg, split=split)
        return torch.sqrt(torch.clamp(var, min=1e-8))
    raise ValueError(kind)


def in_degree(batch: "GraphBatch") -> torch.Tensor:
    """i64[rows]: the real edges into each of the batch's node rows (over
    every rank's edges for a split batch)."""
    return (batch.split.in_degree if batch.split is not None
            else batch.agg.in_degree)


def neighbor_agg(h: torch.Tensor, batch: "GraphBatch",
                 kind: str) -> torch.Tensor:
    """Aggregate the senders' rows ``h[src]`` onto each receiver. For sum
    and mean the messages are gathered from ``h`` straight into the blocked
    layout of ``batch.agg`` (``h`` padded with a zero row at index ``n``,
    the sentinel source) and summed by ``seg_mm``. A split batch gathers
    every rank's rows of ``h`` first and returns this rank's rows."""
    split = batch.split
    h = parallel.gather_nodes(h, split)
    if kind not in ("sum", "mean"):
        src = torch.clamp(batch.src.long(), max=batch.n - 1)
        return segment_agg(h.index_select(0, src), batch.dst, batch.n, kind,
                           split=split)
    h_pad = F.pad(h, (0, 0, 0, 1))
    msgs = h_pad.index_select(0, batch.agg.fmt.src_idx.reshape(-1))
    s = parallel.finish_rows(_seg_sum(msgs, batch.agg), split)
    if kind == "sum":
        return s
    return s / torch.clamp(_per_node(in_degree(batch), s), min=1)


def segment_softmax(logits: torch.Tensor, dst: torch.Tensor, n: int, *,
                    split: GraphSplit | None = None) -> torch.Tensor:
    """Edge-wise softmax normalized per destination node. Where a split
    batch's edges split, each row's maximum is all-reduced (a constant of
    the gradient: the softmax does not move with it) and its sum of
    exponentials summed over the src group."""
    dst = dst.long()
    if split is None or not split.edges:
        mx = _scatter_extreme(logits, dst, n, "amax")
        e = torch.exp(logits - mx[dst])
        z = logits.new_zeros((n + 1,) + logits.shape[1:]).index_add(0, dst,
                                                                    e)
        return e / torch.clamp(z[dst], min=1e-20)
    with torch.no_grad():
        idx = dst.reshape((-1,) + (1,) * (logits.dim() - 1)
                          ).expand_as(logits)
        mx = logits.new_full((n + 1,) + logits.shape[1:], float("-inf"))
        mx = split.mesh.all_reduce_src(
            mx.scatter_reduce(0, idx, logits, "amax"), op="max")
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(logits - mx[dst])
    z = parallel.psum(logits.new_zeros((n + 1,) + logits.shape[1:])
                      .index_add(0, dst, e), split)
    return e / torch.clamp(z[dst], min=1e-20)


def graph_pool(values: torch.Tensor, batch: "GraphBatch",
               kind: str = "sum") -> torch.Tensor:
    """Pool node values per graph (molecule shape); a split batch's rows
    pooled on each rank and summed over the src group."""
    rows = values.shape[0]
    gid = (batch.graph_ids.long() if batch.graph_ids is not None
           else torch.zeros(rows, dtype=torch.long, device=values.device))
    if batch.node_mask is not None:
        values = values * batch.node_mask[:, None].to(values.dtype)
    out = parallel.total(values.new_zeros(
        (batch.n_graphs,) + values.shape[1:]).index_add(0, gid, values),
        batch.split)
    if kind == "mean":
        w = (batch.node_mask.to(values.dtype) if batch.node_mask is not None
             else values.new_ones(rows))
        cnt = parallel.total(values.new_zeros(batch.n_graphs).index_add(
            0, gid, w), batch.split)
        out = out / torch.clamp(cnt[:, None], min=1)
    return out


# --------------------------------------------------------------------- #
# Tiny functional-MLP helpers
# --------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> dict:
    """``{w: f[d_in, d_out] ~ N(0, 1/d_in), b: zeros}`` on the generator's
    device (the JAX package's layout: ``x @ w + b``)."""
    scale = 1.0 / math.sqrt(d_in)
    return dict(w=torch.randn(d_in, d_out, generator=gen, dtype=dtype,
                              device=gen.device) * scale,
                b=torch.zeros(d_out, dtype=dtype, device=gen.device))


def mlp_init(gen: torch.Generator, dims: list[int],
             dtype: torch.dtype = torch.float32) -> list[dict]:
    return [dense_init(gen, a, b, dtype) for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(layers, x, act=F.silu, final_act: bool = False):
    for i, lyr in enumerate(layers):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def params_to(tree, device: torch.device):
    """A parameter tree (nested dicts and lists) with every leaf on
    ``device``, each a leaf tensor that requires grad."""
    from ...train.optim import tree_map
    return tree_map(lambda t: t.detach().to(device).requires_grad_(), tree)


def node_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor | None, *,
              split: GraphSplit | None = None) -> torch.Tensor:
    """Mean cross-entropy over the nodes of ``mask`` (all when None);
    labels below 0 are read as class 0, as the JAX package clips them. A
    split batch's numerator and count are summed over the src group."""
    mask = (mask if mask is not None else
            torch.ones(logits.shape[0], dtype=torch.bool,
                       device=logits.device)).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1,
                        torch.clamp(labels.long(), min=0)[:, None])[:, 0]
    return parallel.total(torch.sum((logz - gold) * mask), split) / \
        torch.clamp(parallel.total(torch.sum(mask), split), min=1.0)


# --------------------------------------------------------------------- #
# Batches
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """One (possibly batched/padded) graph on a device. n = #node slots
    (incl. pad); ``agg`` is the edge-tile format of the real edges."""
    n: int
    x: torch.Tensor                         # f[n, d_feat] (pad rows zero)
    src: torch.Tensor                       # i32[e] sender; sentinel = n
    dst: torch.Tensor                       # i32[e] receiver; sentinel = n
    pos: torch.Tensor | None = None         # f[n, 3]
    node_mask: torch.Tensor | None = None   # bool[n] valid nodes
    graph_ids: torch.Tensor | None = None   # i32[n] for pooling
    n_graphs: int = 1
    labels: torch.Tensor | None = None      # i64[n] or f[n_graphs, ...]
    seed_mask: torch.Tensor | None = None   # bool[n] readout nodes
    agg: EdgeAgg | None = None
    split: GraphSplit | None = None         # over the data ranks

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def n_local(self) -> int:
        """The node rows this batch holds (``n`` unless it is split)."""
        return self.x.shape[0]

    def to(self, device: str | torch.device) -> "GraphBatch":
        return tensors_to(self, resolve_device(device))


def tensors_to(obj, device: torch.device):
    """A copy of a dataclass with every tensor field (nested dataclasses
    included) on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = tensors_to(v, device)
    return dataclasses.replace(obj, **changes)


def _tensor(a, device, dtype=None):
    return None if a is None else torch.as_tensor(np.asarray(a), dtype=dtype,
                                                  device=device)


def batch_from_graph(graph, x: np.ndarray, *, labels=None, pos=None,
                     bidirectional: bool = True,
                     device: str | torch.device = "cuda") -> GraphBatch:
    """Host Graph → device GraphBatch (dst-sorted, with its format)."""
    dev = resolve_device(device)
    src, dst = graph.src, graph.dst
    if bidirectional:
        src, dst = (np.concatenate([src, graph.dst]),
                    np.concatenate([dst, graph.src]))
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    return GraphBatch(
        n=graph.n, x=_tensor(x, dev),
        src=_tensor(src, dev, torch.int32), dst=_tensor(dst, dev, torch.int32),
        pos=_tensor(pos, dev), labels=_tensor(labels, dev),
        node_mask=torch.ones(graph.n, dtype=torch.bool, device=dev),
        agg=edge_agg(src, dst, graph.n, device=dev))


def pad_graph_batch(b: GraphBatch, n_pad: int, e_pad: int) -> GraphBatch:
    """Pad to (n_pad, e_pad) with sentinel edges and zero rows; the format
    is rebuilt over ``n_pad`` nodes."""
    dn = n_pad - b.n
    de = e_pad - b.src.shape[0]
    dev = b.device

    def pad_row(a):
        return None if a is None else F.pad(a, (0, 0) * (a.dim() - 1)
                                            + (0, dn))

    def pad_vec(a, value):
        return torch.cat([a, torch.full((dn,), value, dtype=a.dtype,
                                        device=dev)])

    sentinel = torch.full((de,), n_pad, dtype=torch.int32, device=dev)
    src, dst = torch.cat([b.src, sentinel]), torch.cat([b.dst, sentinel])
    node_mask = (b.node_mask if b.node_mask is not None
                 else torch.ones(b.n, dtype=torch.bool, device=dev))
    return GraphBatch(
        n=n_pad, x=pad_row(b.x), src=src, dst=dst, pos=pad_row(b.pos),
        node_mask=pad_vec(node_mask, False),
        graph_ids=None if b.graph_ids is None else pad_vec(b.graph_ids, 0),
        n_graphs=b.n_graphs, labels=b.labels,
        seed_mask=None if b.seed_mask is None else pad_vec(b.seed_mask,
                                                           False),
        agg=edge_agg(src.cpu().numpy(), dst.cpu().numpy(), n_pad, device=dev))
