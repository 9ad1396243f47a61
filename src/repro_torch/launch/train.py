"""Training launcher: ``--arch graphsage-reddit`` → a GraphSAGE train loop.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --shape minibatch_lg --steps 10

The GNN branch of the JAX package's trainer, in two modes:

* ``--reduced`` (the default, as the JAX trainer's GNN branch): the reduced
  config, full-batch on ``erdos_renyi(200, 1200, seed=1)`` with
  ``adamw(cosine_schedule(3e-3, steps, 2))``;
* ``--shape minibatch_lg``: the full-width config on a fanout-sampled
  minibatch per step (1,024 seeds, fanout (15, 10), padded to the cell's
  static dims from :mod:`repro_torch.launch.specs`) with the cell's
  ``adamw(cosine_schedule(1e-3, 10_000, 100))``. The data is synthetic: a
  Reddit-sized ``erdos_renyi(232_965, 11_461_589, seed=1)`` (Reddit's node
  count and one tenth of its 114,615,892 edges; the sampler draws a fixed
  fanout with replacement, so the step's work does not depend on the edge
  count), float32 features ``[232_965, 602]`` and labels in ``[0, 41)`` from
  numpy seeds, kept on the device. On a card each step prints the split of
  its time: host sampling, building the aggregation format, the copy to the
  card and the device time (CUDA events).

Both layers' neighbour sums run through the ``seg_mm`` kernel. ``--device
cuda`` (the default) needs a card; ``--device cpu`` runs the kernels' plain
versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import get_arch
from ..device import resolve_device
from ..graphs import Graph, erdos_renyi
from ..graphs.sampler import fanout_sample
from ..models.gnn import sage
from ..models.gnn.common import (EdgeAgg, GraphBatch, batch_from_graph,
                                 edge_agg, tensors_to)
from ..train.optim import adamw, cosine_schedule, tree_leaves, tree_map
from .specs import _gnn_cfg_for, _gnn_shape_dims

REDDIT_NODES = 232_965
REDDIT_EDGES_CUT = 11_461_589      # one tenth of Reddit's 114,615,892


def train_step(params: dict, state: dict, batch: GraphBatch, cfg, opt):
    """One AdamW step on ``batch``: → (params, state, loss)."""
    loss = sage.loss_fn(params, batch, cfg)
    loss.backward()
    params, state = opt.apply(tree_map(lambda p: p.grad, params), state,
                              params)
    for p in tree_leaves(params):
        p.grad = None
    return params, state, loss.detach()


# --------------------------------------------------------------------- #
# Reduced: the JAX trainer's own GNN path
# --------------------------------------------------------------------- #
def reduced_batch(cfg, device) -> GraphBatch:
    """The JAX trainer's batch: the same graph, labels and features."""
    rng = np.random.default_rng(0)
    g = erdos_renyi(200, 1200, seed=1)
    labels = rng.integers(0, cfg.n_classes, g.n)
    x = rng.normal(size=(g.n, cfg.d_feat)).astype(np.float32)
    return batch_from_graph(g, x, labels=labels, device=device)


def train_reduced(steps: int, device, *, params: dict | None = None,
                  log=print) -> list[float]:
    """``steps`` full-batch steps of the reduced config; → the losses.
    ``params`` (e.g. the JAX package's, converted) replaces the seeded
    init."""
    cfg = get_arch("graphsage-reddit").config(reduced=True)
    batch = reduced_batch(cfg, device)
    if params is None:
        params = sage.init_params(cfg, 0, device=device)
    opt = adamw(cosine_schedule(3e-3, steps, 2))
    state = opt.init(params)
    losses = []
    for step in range(steps):
        params, state, loss = train_step(params, state, batch, cfg, opt)
        losses.append(float(loss))
        log(f"[train] step {step} loss {losses[-1]:.4f}")
    return losses


# --------------------------------------------------------------------- #
# minibatch_lg: fanout-sampled minibatches of a Reddit-sized graph
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class NodeData:
    """A graph on the host with its node features and labels on a device."""
    graph: Graph
    feats: torch.Tensor          # f[n, d_feat]
    labels: torch.Tensor         # i64[n]


def synthetic_reddit(cfg, device) -> NodeData:
    """The cell's synthetic data: the cut Reddit-sized graph, and features
    and labels of ``cfg``'s widths from numpy seeds, on ``device``."""
    dev = resolve_device(device)
    graph = erdos_renyi(REDDIT_NODES, REDDIT_EDGES_CUT, seed=1)
    graph.csr_indptr, graph.edges_by_src         # the sampler's CSR views
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((graph.n, cfg.d_feat), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, graph.n)
    return NodeData(graph, torch.from_numpy(feats).to(dev),
                    torch.from_numpy(labels).to(dev))


@dataclasses.dataclass(frozen=True)
class Minibatch:
    """A sampled subgraph's index arrays, padded to (n, e), with its
    aggregation format; features are gathered on the device by
    :meth:`batch`."""
    n: int
    node_ids: torch.Tensor       # i64[n_local] global ids of the local nodes
    src: torch.Tensor            # i32[e] local sender; sentinel n
    dst: torch.Tensor            # i32[e] local receiver; sentinel n
    node_mask: torch.Tensor      # bool[n]
    seed_mask: torch.Tensor      # bool[n]
    agg: EdgeAgg

    def to(self, device) -> "Minibatch":
        return tensors_to(self, resolve_device(device))

    def batch(self, data: NodeData) -> GraphBatch:
        """The :class:`GraphBatch`: features and labels of the local nodes
        gathered from ``data`` (zero rows and label −1 on pad nodes)."""
        pad = self.n - self.node_ids.shape[0]
        return GraphBatch(
            n=self.n,
            x=F.pad(data.feats.index_select(0, self.node_ids), (0, 0, 0, pad)),
            src=self.src, dst=self.dst, node_mask=self.node_mask,
            labels=F.pad(data.labels.index_select(0, self.node_ids), (0, pad),
                         value=-1),
            seed_mask=self.seed_mask, agg=self.agg)


def sample_minibatch(graph: Graph, seeds: np.ndarray, fanout, *, n: int,
                     e: int, seed: int) -> tuple[Minibatch, dict]:
    """``fanout_sample`` around ``seeds``, padded to ``n`` nodes and ``e``
    edges, with its aggregation format, all on the host. → (minibatch,
    host seconds {"sample", "format"})."""
    t0 = time.perf_counter()
    sub = fanout_sample(graph, seeds, fanout, seed=seed)
    t1 = time.perf_counter()
    src = np.full(e, n, np.int32)
    dst = np.full(e, n, np.int32)
    real = sub.dst < sub.n_pad
    k = int(real.sum())
    src[:k], dst[:k] = sub.src[real], sub.dst[real]
    n_local = int(sub.node_mask.sum())
    mb = Minibatch(
        n=n, node_ids=torch.from_numpy(sub.node_ids[:n_local]),
        src=torch.from_numpy(src), dst=torch.from_numpy(dst),
        node_mask=torch.from_numpy(np.arange(n) < n_local),
        seed_mask=torch.from_numpy(np.pad(sub.seed_mask, (0, n - sub.n_pad))),
        agg=edge_agg(src, dst, n, device="cpu"))
    return mb, {"sample": t1 - t0, "format": time.perf_counter() - t1}


def cell():
    """(config, shape params, padded dims) of the ``graphsage-reddit``
    ``minibatch_lg`` cell."""
    entry = get_arch("graphsage-reddit")
    spec = entry.shape("minibatch_lg")
    dims = _gnn_shape_dims(spec)
    return _gnn_cfg_for(entry, dims), spec.params, dims


def train_minibatch(steps: int, device, *, data: NodeData | None = None,
                    params: dict | None = None, log=print) -> dict:
    """``steps`` steps of the ``minibatch_lg`` cell, a fresh sample each.
    → {"losses", "splits" (per step, seconds), "padding" (slots per real
    edge, per step), "data", "params"}."""
    dev = resolve_device(device)
    cfg, p, dims = cell()
    if data is None:
        data = synthetic_reddit(cfg, dev)
    if params is None:
        params = sage.init_params(cfg, 0, device=dev)
    opt = adamw(cosine_schedule(1e-3, 10_000, 100))
    state = opt.init(params)
    out = dict(losses=[], splits=[], padding=[], data=data, params=params)
    for step in range(steps):
        seeds = np.random.default_rng(1000 + step).choice(
            data.graph.n, p["batch_nodes"], replace=False)
        mb, split = sample_minibatch(data.graph, seeds, p["fanout"],
                                     n=dims["n"], e=dims["e"], seed=step)
        t0 = time.perf_counter()
        mb = mb.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        split["h2d"] = time.perf_counter() - t0
        params, state, loss = train_step(params, state, mb.batch(data), cfg,
                                         opt)
        loss = float(loss)
        line = f"[train] step {step} loss {loss:.4f}"
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            split["device"] = start.elapsed_time(end) / 1e3
            line += (f" (sample {split['sample'] * 1e3:.1f} ms, format "
                     f"{split['format'] * 1e3:.1f} ms, h2d "
                     f"{split['h2d'] * 1e3:.2f} ms, device "
                     f"{split['device'] * 1e3:.2f} ms; {mb.agg.padding:.3f} "
                     f"slots per real edge)")
        log(line)
        out["losses"].append(loss)
        out["splits"].append(split)
        out["padding"].append(mb.agg.padding)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config, full batch (the default)")
    ap.add_argument("--shape", choices=("minibatch_lg",), default=None,
                    help="run the full-width cell of this shape instead")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        entry = get_arch(args.arch)
    except KeyError as exc:
        raise SystemExit(f"--arch {args.arch}: {exc.args[0]}") from None
    if entry.family != "gnn":
        raise SystemExit(f"--arch {args.arch}: the psi family serves; use "
                         "repro_torch.launch.serve")
    if args.reduced and args.shape:
        raise SystemExit("--reduced and --shape exclude each other")
    if args.shape:
        return train_minibatch(args.steps, args.device)
    return train_reduced(args.steps, args.device)


if __name__ == "__main__":
    main()
