"""Training launcher: ``--arch <gnn, lm or recsys arch>`` → a train loop.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch pna --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch graphsage-reddit --shape minibatch_lg --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch equiformer-v2 --shape molecule --steps 5

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --shape train_4k --steps 5

The LM branch of the JAX package's trainer for ``tinyllama-1.1b``,
``yi-9b``, ``nemotron-4-340b``, ``mixtral-8x22b`` and ``mixtral-8x7b``
(:func:`train_lm`): ``TokenPipeline`` batches (seed 0, ``--batch`` ×
``--seq``), the config's optimizer (``adamw`` or ``adafactor``) over
``cosine_schedule(3e-3, steps, max(1, steps // 10))``, ``cfg.accum_steps``
microbatches a step, ``--ckpt-dir``/``--ckpt-every``/``--resume`` through
``ckpt/`` (the state saved as ``dict(p=params, o=opt_state)`` in the JAX
tree layout, so either package resumes the other's run) and the straggler
flag. ``--reduced`` (the default) runs the reduced config at ``--batch 8
--seq 64``; ``--shape train_4k`` runs the full config at the cell's sequence
length, its global batch of 256 cut to ``--batch`` (8 by default), with the
JAX package's LM cells' ``cosine_schedule(3e-4, 10_000, 200)``
(``launch/specs.py``; the reduced run's 3e-3 diverges at full width), and
prints the cuts.

The GNN branch of the JAX package's trainer for ``graphsage-reddit``,
``pna``, ``nequip`` and ``equiformer-v2``, in two modes:

* ``--reduced`` (the default, as the JAX trainer's GNN branch): the reduced
  config, full-batch on ``erdos_renyi(200, 1200, seed=1)`` (positions for
  the geometric archs, one graph-level label for ``out_kind == "graph"``)
  with ``adamw(cosine_schedule(3e-3, steps, 2))``;
* ``--shape``: the full-width config of the registry's cell with the cell's
  ``adamw(cosine_schedule(1e-3, 10_000, 100))``, on synthetic data from
  numpy seeds:

  - ``minibatch_lg`` (``graphsage-reddit``, ``pna``): a fanout-sampled
    minibatch per step (1,024 seeds, fanout (15, 10), padded to the cell's
    static dims from :mod:`repro_torch.launch.specs`) of a Reddit-sized
    ``erdos_renyi(232_965, 11_461_589, seed=1)`` (Reddit's node count and
    one tenth of its 114,615,892 edges; the sampler draws a fixed fanout
    with replacement, so the step's work does not depend on the edge
    count), float32 features ``[232_965, 602]`` and labels in ``[0, 41)``,
    kept on the device. On a card each step prints the split of its time:
    host sampling, building the aggregation format, the copy to the card
    and the device time (CUDA events);
  - ``full_graph_sm``: a Cora-sized ``erdos_renyi(2_708, 10_556, seed=1)``
    (both directions: 21,112 edges) padded to the cell's (4,096, 22,528),
    features ``[2_708, 1_433]``, 7 classes (positions for the geometric
    archs), full-batch;
  - ``molecule``: 128 molecules of 30 atoms and 64 bonds each (both
    directions: 16,384 edges; 3,840 atoms padded to 4,096), atoms at least
    1.0 apart in a ball of radius 3.0 and each molecule's 64 shortest pairs
    bonded (every bond well inside the 5.0 cutoff), width-16 species
    features, one float32 energy label a molecule, full-batch;
  - ``ogb_products`` does not fit one card and raises.

  On a card each full-batch step prints its device ms (CUDA events).

The recsys branch for ``mind`` (:func:`train_recsys`):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mind --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mind --shape train_batch --steps 5

``--reduced`` (the default) is the JAX launcher's run: the reduced config,
one batch of ``--batch`` users (8) from numpy seed 0 with 4 profile tags a
user, ``adamw(cosine_schedule(1e-2, steps, 2))``. ``--shape train_batch``
runs the full config (4,194,304 × 64 item table, 131,072 × 64 profile
table) at the cell's 65,536 users (``--batch`` cuts it), 8 profile tags and
1,024 uniform negatives a user, a fresh batch a step, with the JAX cell's
``cosine_schedule(1e-3, 10_000, 100)``; each step prints its ms (CUDA
events) and users/s. The profile bags' layout is built once a batch on the
host and their sums run through ``seg_mm``.

Every sum and mean of a neighbourhood runs through the ``seg_mm`` kernel.
``--device cuda`` (the default) needs a card; ``--device cpu`` runs the
kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ckpt import checkpoint
from ..configs import get_arch
from ..data import TokenPipeline
from ..device import resolve_device
from ..graphs import Graph, erdos_renyi
from ..graphs.sampler import fanout_sample
from ..models.gnn import sage
from ..models.gnn.common import (EdgeAgg, GraphBatch, batch_from_graph,
                                 edge_agg, pad_graph_batch, tensors_to)
from ..models import recsys, transformer
from ..train.optim import (ShardLayout, adafactor, adamw, cosine_schedule,
                           tree_leaves, tree_map)
from .specs import _GEOMETRIC, _GNN_MODS, _gnn_cfg_for, _gnn_shape_dims

REDDIT_NODES = 232_965
REDDIT_EDGES_CUT = 11_461_589      # one tenth of Reddit's 114,615,892
CORA_NODES, CORA_EDGES = 2_708, 10_556
# ogb_products on one card: 2,449,029 nodes, 123.7M directed edges; PNA's
# per-edge messages alone are [123.7M, 75] f32 = 37 GB each
OGB_PRODUCTS_REFUSAL = (
    "ogb_products does not fit one card: 2,449,029 nodes and 123.7M "
    "directed edges, and a layer's per-edge messages alone take "
    "[123.7M, 75] f32 = 37 GB each (PNA); it waits for a multi-card run")


def train_step(params: dict, state: dict, batch: GraphBatch, cfg, opt,
               mod=sage, mesh=None):
    """One optimizer step of ``mod.loss_fn`` on ``batch``: → (params,
    state, loss). A leaf the loss does not reach gets a zero gradient, as
    under ``jax.value_and_grad``. With a ``mesh`` every rank holds the
    parameters. A batch split over the data ranks (``batch.split``: the
    GNN cells' layout, :mod:`repro_torch.models.gnn.parallel`) gives each
    rank its share of every gradient, summed over the src group; a batch
    whole on every rank gives each the whole gradient, summed over the src
    group and divided by its size."""
    loss = mod.loss_fn(params, batch, cfg)
    loss.backward()
    d = 1 if mesh is None else mesh.d

    def grad(p):
        if p.grad is None:
            return torch.zeros_like(p)
        if d == 1:
            return p.grad
        if batch.split is not None:
            return mesh.all_reduce_src(p.grad)
        return mesh.all_reduce_src(p.grad) / d

    grads = tree_map(grad, params)
    params, state = opt.apply(grads, state, params)
    for p in tree_leaves(params):
        p.grad = None
    return params, state, loss.detach()


# --------------------------------------------------------------------- #
# Reduced: the JAX trainer's own GNN path
# --------------------------------------------------------------------- #
def reduced_batch(cfg, device, *, geometric: bool = False) -> GraphBatch:
    """The JAX trainer's batch: the same graph, labels, features and (for
    the geometric archs) positions."""
    rng = np.random.default_rng(0)
    g = erdos_renyi(200, 1200, seed=1)
    labels = (np.zeros(1, np.float32)
              if getattr(cfg, "out_kind", "node") == "graph"
              else rng.integers(0, cfg.n_classes, g.n))
    x = rng.normal(size=(g.n, cfg.d_feat)).astype(np.float32)
    pos = (rng.normal(size=(g.n, 3)).astype(np.float32) if geometric
           else None)
    return batch_from_graph(g, x, labels=labels, pos=pos, device=device)


def train_reduced(steps: int, device, *, arch: str = "graphsage-reddit",
                  params: dict | None = None, log=print) -> list[float]:
    """``steps`` full-batch steps of ``arch``'s reduced config; → the
    losses. ``params`` (e.g. the JAX package's, converted) replaces the
    seeded init."""
    mod = _GNN_MODS[arch]
    cfg = get_arch(arch).config(reduced=True)
    batch = reduced_batch(cfg, device, geometric=arch in _GEOMETRIC)
    if params is None:
        params = mod.init_params(cfg, 0, device=device)
    opt = adamw(cosine_schedule(3e-3, steps, 2))
    state = opt.init(params)
    losses = []
    for step in range(steps):
        params, state, loss = train_step(params, state, batch, cfg, opt, mod)
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


def cell(arch: str = "graphsage-reddit", shape: str = "minibatch_lg"):
    """(config, shape params, padded dims) of the cell ``arch`` × ``shape``
    (the ``graphsage-reddit`` ``minibatch_lg`` cell by default)."""
    entry = get_arch(arch)
    spec = entry.shape(shape)
    dims = _gnn_shape_dims(spec)
    return _gnn_cfg_for(entry, dims), spec.params, dims


def train_minibatch(steps: int, device, *, arch: str = "graphsage-reddit",
                    data: NodeData | None = None, params: dict | None = None,
                    log=print) -> dict:
    """``steps`` steps of the ``minibatch_lg`` cell, a fresh sample each.
    → {"losses", "splits" (per step, seconds), "padding" (slots per real
    edge, per step), "data", "params"}."""
    if arch in _GEOMETRIC:
        raise SystemExit(f"--arch {arch} --shape minibatch_lg: a sampled "
                         "subgraph of the Reddit-sized graph has no "
                         "positions; use full_graph_sm or molecule")
    dev = resolve_device(device)
    mod = _GNN_MODS[arch]
    cfg, p, dims = cell(arch)
    if data is None:
        data = synthetic_reddit(cfg, dev)
    if params is None:
        params = mod.init_params(cfg, 0, device=dev)
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
                                         opt, mod)
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


# --------------------------------------------------------------------- #
# full_graph_sm and molecule: one fixed full batch
# --------------------------------------------------------------------- #
def synthetic_cora(cfg, device, *, geometric: bool = False) -> GraphBatch:
    """The ``full_graph_sm`` cell's batch: a Cora-sized random graph, its
    features and labels (and positions) from numpy seeds, padded to the
    cell's (n, e)."""
    _, _, dims = cell("graphsage-reddit", "full_graph_sm")
    g = erdos_renyi(CORA_NODES, CORA_EDGES, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((g.n, cfg.d_feat), dtype=np.float32)
    labels = np.concatenate([rng.integers(0, dims["n_classes"], g.n),
                             np.full(dims["n"] - g.n, -1)])
    pos = (rng.standard_normal((g.n, 3), dtype=np.float32) if geometric
           else None)
    b = batch_from_graph(g, x, labels=labels, pos=pos, device=device)
    return pad_graph_batch(b, dims["n"], dims["e"])


# a full-graph cell's synthetic graph is drawn in chunks of edge positions
# and of node rows, each from a numpy seed of its own: a rank draws only the
# chunks its shard touches, and any split assembles to the same graph
EDGE_CHUNK, ROW_CHUNK = 1 << 16, 1 << 12


def _chunked(draw, seed: int, lo: int, hi: int, chunk: int) -> np.ndarray:
    """Items ``[lo, hi)`` of a sequence drawn ``chunk`` at a time, chunk
    ``k`` by ``draw(np.random.default_rng([seed, k]), chunk)``."""
    if hi <= lo:
        return draw(np.random.default_rng([seed, 0]), 0)
    k0 = lo // chunk
    parts = [draw(np.random.default_rng([seed, k]), chunk)
             for k in range(k0, -(-hi // chunk))]
    return np.concatenate(parts)[lo - k0 * chunk:hi - k0 * chunk]


def full_graph_receivers(n_real: int, e_real: int, n: int, lo: int,
                         hi: int, *, seed: int = 5):
    """(receivers of the dst-sorted edge slots ``[lo, hi)`` (sentinel ``n``
    past the ``e_real`` real ones), every real node's in-degree) of
    :func:`full_graph_shard`'s graph."""
    deg = np.random.default_rng(seed).multinomial(
        e_real, np.full(n_real, 1.0 / n_real))
    dst = np.full(hi - lo, n, np.int64)
    k = max(0, min(hi, e_real) - lo)
    dst[:k] = np.searchsorted(np.cumsum(deg), np.arange(lo, lo + k),
                              side="right")
    return dst, deg


def full_graph_shard(n_real: int, e_real: int, n: int, e: int, d_feat: int,
                     n_classes: int, device, *, mesh=None,
                     geometric: bool = False, seed: int = 5) -> GraphBatch:
    """This rank's shard of a full-graph cell's synthetic graph, padded to
    (``n``, ``e``): ``e_real`` directed edges, the in-degrees of the
    ``n_real`` real nodes one multinomial draw (uniform), each sender
    uniform, dst-sorted; width-``d_feat`` normal float32 features, labels
    in ``[0, n_classes)`` (−1 on pad rows) and, ``geometric``, normal
    positions; all from numpy seeds ``seed`` … ``seed + 4``. Only the
    rank's node rows and edges are drawn
    (:func:`~repro_torch.models.gnn.parallel.split_flags` over ``mesh``);
    without a split, the whole graph."""
    from ..models.gnn.parallel import GraphSplit, row_range, split_flags
    dev = resolve_device(device)
    flags = split_flags(n, e, mesh)
    nodes, edges = flags or (False, False)
    nlo, nhi = row_range(n, mesh, nodes)
    elo, ehi = row_range(e, mesh, edges)
    dst, deg = full_graph_receivers(n_real, e_real, n, elo, ehi, seed=seed)
    k = int((dst < n).sum())                       # real edges here
    src = np.full(ehi - elo, n, np.int64)
    src[:k] = _chunked(lambda g, c: g.integers(0, n_real, c), seed + 1,
                       elo, elo + k, EDGE_CHUNK)
    r = max(0, min(nhi, n_real) - nlo)             # real node rows here

    def rows(draw, seed_, width, dtype, fill):
        a = np.full((nhi - nlo,) + width, fill, dtype)
        a[:r] = _chunked(draw, seed_, nlo, nlo + r, ROW_CHUNK)
        return torch.as_tensor(a, device=dev)

    x = rows(lambda g, c: g.standard_normal((c, d_feat), np.float32),
             seed + 2, (d_feat,), np.float32, 0.0)
    labels = rows(lambda g, c: g.integers(0, n_classes, c), seed + 3, (),
                  np.int64, -1)
    pos = (rows(lambda g, c: g.standard_normal((c, 3), np.float32),
                seed + 4, (3,), np.float32, 0.0) if geometric else None)
    in_deg = np.zeros(nhi - nlo, np.int64)
    in_deg[:r] = deg[nlo:nlo + r]
    split = None if flags is None else GraphSplit(
        mesh=mesh, n=n, e=e, nodes=nodes, edges=edges,
        in_degree=torch.as_tensor(in_deg, device=dev))
    return GraphBatch(
        n=n, x=x, src=torch.as_tensor(src, dtype=torch.int32, device=dev),
        dst=torch.as_tensor(dst, dtype=torch.int32, device=dev), pos=pos,
        node_mask=torch.as_tensor(np.arange(nlo, nhi) < n_real, device=dev),
        labels=labels, agg=edge_agg(src, dst, n, device=dev), split=split)


def molecule_positions(rng, n_atoms: int, radius: float = 3.0,
                       min_dist: float = 1.0) -> np.ndarray:
    """f32[n_atoms, 3]: points in a ball of ``radius``, each at least
    ``min_dist`` from every earlier one (rejection sampling)."""
    pos = []
    while len(pos) < n_atoms:
        p = rng.uniform(-radius, radius, 3)
        if np.linalg.norm(p) <= radius and all(
                np.linalg.norm(p - q) >= min_dist for q in pos):
            pos.append(p)
    return np.asarray(pos, np.float32)


def molecule_batch(n_mol: int, n_atoms: int, n_bonds: int, d_feat: int,
                   device, *, n_pad: int, e_pad: int,
                   seed: int = 3) -> GraphBatch:
    """``n_mol`` molecules of ``n_atoms`` atoms, each bonding its
    ``n_bonds`` closest pairs (both directions), with width-``d_feat``
    species features, positions (:func:`molecule_positions`) and one
    energy label a molecule from ``numpy`` seed ``seed``, padded to
    (``n_pad``, ``e_pad``)."""
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n_atoms, 1)
    pos, src, dst = [], [], []
    for k in range(n_mol):
        xyz = molecule_positions(rng, n_atoms)
        d = np.linalg.norm(xyz[iu[0]] - xyz[iu[1]], axis=-1)
        bonds = np.argsort(d, kind="stable")[:n_bonds]
        pos.append(xyz)
        src.append(iu[0][bonds] + k * n_atoms)
        dst.append(iu[1][bonds] + k * n_atoms)
    g = Graph(n_atoms * n_mol, np.concatenate(src), np.concatenate(dst))
    x = rng.standard_normal((g.n, d_feat), dtype=np.float32)
    energy = rng.standard_normal(n_mol, dtype=np.float32)
    b = batch_from_graph(g, x, labels=energy, pos=np.concatenate(pos),
                         device=device)
    b = dataclasses.replace(
        b, n_graphs=n_mol, graph_ids=torch.as_tensor(
            np.repeat(np.arange(n_mol, dtype=np.int32), n_atoms),
            device=b.device))
    return pad_graph_batch(b, n_pad, e_pad)


def synthetic_molecules(cfg, device) -> GraphBatch:
    """The ``molecule`` cell's batch (:func:`molecule_batch` at the
    registry's 128 molecules of 30 atoms and 64 bonds, padded to the
    cell's (n, e))."""
    _, p, dims = cell("nequip", "molecule")
    return molecule_batch(p["batch"], p["n_nodes"], p["n_edges"], cfg.d_feat,
                          device, n_pad=dims["n"], e_pad=dims["e"])


def shape_batch(arch: str, shape: str, cfg, device) -> GraphBatch:
    """The fixed full batch of the cell ``arch`` × ``shape``."""
    if shape == "full_graph_sm":
        return synthetic_cora(cfg, device, geometric=arch in _GEOMETRIC)
    if shape == "molecule":
        return synthetic_molecules(cfg, device)
    if shape == "ogb_products":
        raise SystemExit(f"--shape ogb_products: {OGB_PRODUCTS_REFUSAL}")
    raise ValueError(f"{shape} is not a full-batch shape")


def train_full_batch(arch: str, shape: str, steps: int, device, *,
                     params: dict | None = None, log=print) -> dict:
    """``steps`` steps of the cell ``arch`` × ``shape`` on its fixed
    batch. → {"losses", "device_ms" (per step, on a card), "batch",
    "params", "state", "cfg", "opt"}."""
    dev = resolve_device(device)
    mod = _GNN_MODS[arch]
    cfg, _, _ = cell(arch, shape)
    batch = shape_batch(arch, shape, cfg, dev)
    if params is None:
        params = mod.init_params(cfg, 0, device=dev)
    opt = adamw(cosine_schedule(1e-3, 10_000, 100))
    state = opt.init(params)
    out = dict(losses=[], device_ms=[], batch=batch, cfg=cfg, opt=opt)
    for step in range(steps):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        params, state, loss = train_step(params, state, batch, cfg, opt, mod)
        loss = float(loss)
        line = f"[train] step {step} loss {loss:.4f}"
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            out["device_ms"].append(start.elapsed_time(end))
            line += f" (device {out['device_ms'][-1]:.2f} ms)"
        log(line)
        out["losses"].append(loss)
    out.update(params=params, state=state)
    return out


# --------------------------------------------------------------------- #
# The LM family
# --------------------------------------------------------------------- #
# the JAX package's schedule for the LM cells (launch/specs.py, _opt_for)
LM_CELL_SCHEDULE = (3e-4, 10_000, 200)


def lm_cell(arch: str, shape: str | None = None, *, batch: int | None = None,
            seq: int | None = None):
    """(config, batch, seq, cuts) of ``arch``: the reduced config at batch
    8 × seq 64 when ``shape`` is None, else the full config at the train
    cell's sequence length and batch 8, each overridden by ``batch`` /
    ``seq``; ``cuts`` lists what differs from the cell."""
    entry = get_arch(arch)
    if shape is None:
        return entry.config(reduced=True), batch or 8, seq or 64, []
    spec = entry.shape(shape)
    if spec.kind != "train":
        raise SystemExit(f"--shape {shape} is a {spec.kind} cell; serve it "
                         "with repro_torch.launch.serve")
    full_batch, full_seq = spec.params["global_batch"], spec.params["seq_len"]
    batch, seq = batch or 8, seq or full_seq
    cuts = [f"{name} {full} -> {val}" for name, full, val in (
        ("global batch", full_batch, batch), ("seq", full_seq, seq))
        if full != val]
    return entry.config(), batch, seq, cuts


def _load_tree(template, restored):
    """``restored`` (``checkpoint.restore``'s numpy leaves and bfloat16
    tensors) written into ``template``'s tensors in place; a non-tensor
    leaf (an optimizer's step count) becomes an int."""
    if isinstance(template, dict):
        return {k: _load_tree(v, restored[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(torch.as_tensor(restored))
        return template
    return int(restored)


def train_lm(arch: str, steps: int, device, *, shape: str | None = None,
             batch: int | None = None, seq: int | None = None,
             ckpt_dir: str | None = None, ckpt_every: int = 10,
             resume: bool = False, params: dict | None = None,
             log=print) -> dict:
    """``steps`` steps of the LM ``arch`` (:func:`lm_cell` picks the config
    and sizes), as the JAX package's trainer runs them. ``params`` (e.g.
    the JAX package's, converted) replaces the seeded init. → {"losses",
    "step_ms" (a step's host ms to the loss, CUDA events on a card),
    "params", "state", "cfg", "tokens" (a step's)}."""
    dev = resolve_device(device)
    cfg, batch, seq, cuts = lm_cell(arch, shape, batch=batch, seq=seq)
    if batch % cfg.accum_steps:
        raise SystemExit(f"--batch {batch} does not split into "
                         f"{cfg.accum_steps} microbatches")
    if shape is not None:
        log(f"[train] {cfg.name} at {shape}: batch {batch} x seq {seq}, "
            f"{cfg.accum_steps} microbatches a step; cut: "
            f"{'; '.join(cuts) or 'nothing'}")
    if params is None:
        params = transformer.init_params(cfg, 0, device=dev)
    sched = (cosine_schedule(3e-3, steps, max(1, steps // 10))
             if shape is None else cosine_schedule(*LM_CELL_SCHEDULE))
    opt = (adafactor if cfg.optimizer == "adafactor" else adamw)(sched)
    state = opt.init(params)
    step_fn = transformer.make_train_step(cfg, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                         seed=0)
    start = (checkpoint.latest_step(ckpt_dir) if resume and ckpt_dir
             else None) or 0
    if start:
        data = checkpoint.restore(ckpt_dir, start, dict(p=params, o=state))
        params = _load_tree(params, data["p"])
        state = _load_tree(state, data["o"])
        log(f"[train] resumed at step {start}")
    out = dict(losses=[], step_ms=[], cfg=cfg, tokens=batch * seq)
    durations = []
    for step in range(start, steps):
        b = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in pipe.batch(step).items()}
        t0 = time.perf_counter()
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, state, loss = step_fn(params, state, b)
        loss = float(loss)
        dt = time.perf_counter() - t0
        if dev.type == "cuda":
            ev[1].record()
            ev[1].synchronize()
        ms = ev[0].elapsed_time(ev[1]) if dev.type == "cuda" else dt * 1e3
        if durations and dt > 3.0 * float(np.median(durations)):
            log(f"[train] straggler flag at step {step}: "
                f"{dt:.2f}s vs median {np.median(durations):.2f}s")
        durations.append(dt)
        out["step_ms"].append(ms)
        out["losses"].append(loss)
        log(f"[train] step {step} loss {loss:.4f} ({dt:.2f}s"
            + (f"; {ms:.1f} ms by events, {batch * seq / ms * 1e3:.0f} "
               "tokens/s)" if dev.type == "cuda" else ")"))
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, dict(p=params, o=state))
    out.update(params=params, state=state)
    return out


# --------------------------------------------------------------------- #
# The recsys family
# --------------------------------------------------------------------- #
# the JAX package's schedule for the recsys train cell (launch/specs.py)
RECSYS_CELL_SCHEDULE = (1e-3, 10_000, 100)
RECSYS_REDUCED_TAGS = 4        # the JAX launcher's profile tags a user


def recsys_host_batch(cfg, users: int, rng: np.random.Generator, *,
                      tags: int, train: bool = True) -> dict:
    """A batch of ``users`` as numpy, drawn from ``rng`` in the JAX
    launcher's order: ``hist_ids`` [users, H], ``hist_mask`` (80% kept),
    ``tags`` profile ids a user with their sorted ``profile_bags``, then
    for training ``pos_ids`` [users] and ``neg_ids`` [users, n_neg]
    (uniform over the item table)."""
    hb = dict(
        hist_ids=rng.integers(0, cfg.n_items, (users, cfg.hist_len)),
        hist_mask=rng.random((users, cfg.hist_len)) > 0.2,
        profile_ids=rng.integers(0, cfg.n_profile, (users * tags,)),
        profile_bags=np.repeat(np.arange(users), tags))
    if train:
        hb.update(pos_ids=rng.integers(0, cfg.n_items, (users,)),
                  neg_ids=rng.integers(0, cfg.n_items, (users, cfg.n_neg)))
    return hb


def slice_users(hb: dict, lo: int, hi: int) -> dict:
    """Users ``[lo, hi)`` of a host batch, their bags renumbered from 0."""
    a, b = np.searchsorted(hb["profile_bags"], [lo, hi])
    return {k: (v[a:b] - (lo if k == "profile_bags" else 0))
            if k.startswith("profile") else v[lo:hi] for k, v in hb.items()}


def recsys_device_batch(hb: dict, cfg, device) -> dict:
    """A host batch on ``device``, with the profile bags' layout
    (:func:`~repro_torch.models.recsys.embedding.bag_layout`) built on the
    host."""
    dev = resolve_device(device)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in hb.items()}
    out["profile_layout"] = recsys.bag_layout(
        hb["profile_ids"], hb["profile_bags"], hb["hist_ids"].shape[0],
        cfg.n_profile, device=dev)
    return out


def recsys_layout(cfg, mesh):
    """The optimizer's ``layout=`` for MIND's parameters on ``mesh`` (None
    without one): the clip's norm sums a table shard's squares over the
    model group."""
    if mesh is None:
        return None
    return ShardLayout(mesh, recsys.param_specs(cfg))


def recsys_step(params: dict, state: dict, batch: dict, cfg, opt,
                mesh=None):
    """One optimizer step of MIND's sampled-softmax loss: → (params,
    state, loss). With a mesh, ``params`` are the rank's shards
    (``mind.shard_params``), ``batch`` its data row's users and ``state``
    made with :func:`recsys_layout`."""
    loss, grads = recsys.loss_and_grads(params, batch, cfg, mesh)
    kw = {} if mesh is None else dict(layout=recsys_layout(cfg, mesh))
    params, state = opt.apply(grads, state, params, **kw)
    return params, state, loss


def train_recsys(arch: str, steps: int, device, *, shape: str | None = None,
                 batch: int | None = None, params: dict | None = None,
                 mesh=None, log=print) -> dict:
    """``steps`` steps of MIND. Reduced (``shape`` None): the JAX launcher's
    run, one fixed batch of ``batch`` users (8 by default) from numpy seed
    0 with RECSYS_REDUCED_TAGS tags a user, ``adamw(cosine_schedule(1e-2,
    steps, 2))``. ``shape="train_batch"``: the full config at the cell's
    65,536 users (``batch`` cuts it), ``cfg.profile_tags`` tags a user and
    ``cfg.n_neg`` negatives, a fresh batch each step (numpy seed 1000 +
    step), the JAX cell's ``cosine_schedule(1e-3, 10_000, 100)``.
    ``params`` (e.g. the JAX package's, converted) replaces the seeded
    init. With a ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh` on the
    caller's process group) each rank holds its rows of the tables and its
    data row's share of the users (the batch must split over the data
    rows), and the step is :func:`recsys_step`'s sharded one.
    → {"losses", "step_ms" (CUDA events on a card, host clock on the CPU),
    "users", "params", "state", "opt", "cfg", "batch" (the last, on the
    device) and "host" (the same as numpy)}."""
    dev = resolve_device(device)
    entry = get_arch(arch)
    if shape is None:
        cfg, users, tags = entry.config(reduced=True), batch or 8, \
            RECSYS_REDUCED_TAGS
        sched = cosine_schedule(1e-2, steps, 2)
        fixed = recsys_host_batch(cfg, users, np.random.default_rng(0),
                                  tags=tags)
    else:
        spec = entry.shape(shape)
        if spec.kind != "train":
            raise SystemExit(f"--shape {shape} is a {spec.kind} cell; serve "
                             "it with repro_torch.launch.serve")
        cfg, tags = entry.config(), entry.config().profile_tags
        users = batch or spec.params["batch"]
        sched = cosine_schedule(*RECSYS_CELL_SCHEDULE)
        fixed = None
        log(f"[train] {cfg.name} at {shape}: {users} users a step, "
            f"{tags} profile tags and {cfg.n_neg} negatives a user, tables "
            f"{cfg.n_items} x {cfg.embed_dim} and {cfg.n_profile} x "
            f"{cfg.embed_dim}; cut: "
            + (f"batch {spec.params['batch']} -> {users}"
               if users != spec.params["batch"] else "nothing"))
    if params is None:
        params = recsys.init_params(cfg, 0, device=dev)
    if mesh is not None:
        if users % mesh.d:
            raise SystemExit(f"{users} users do not split over {mesh.d} "
                             "data rows")
        params = recsys.shard_params(params, mesh)
        lo, hi = (mesh.row * users // mesh.d,
                  (mesh.row + 1) * users // mesh.d)

    def mine(hb):
        return hb if mesh is None else slice_users(hb, lo, hi)

    opt = adamw(sched)
    state = opt.init(params)
    out = dict(losses=[], step_ms=[], users=users, cfg=cfg, opt=opt)
    hb = fixed
    b = (recsys_device_batch(mine(hb), cfg, dev) if fixed is not None
         else None)
    for step in range(steps):
        if fixed is None:
            hb = b = None                # free the last batch first
            hb = recsys_host_batch(cfg, users,
                                   np.random.default_rng(1000 + step),
                                   tags=tags)
            b = recsys_device_batch(mine(hb), cfg, dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, state, loss = recsys_step(params, state, b, cfg, opt, mesh)
        if dev.type == "cuda":
            ev[1].record()
        loss = float(loss)
        if dev.type == "cuda":
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            ms = (time.perf_counter() - t0) * 1e3
        out["losses"].append(loss)
        out["step_ms"].append(ms)
        log(f"[train] step {step} loss {loss:.4f}"
            + (f" ({ms:.1f} ms by events, {users / ms * 1e3:.0f} users/s)"
               if dev.type == "cuda" else ""))
    out.update(params=params, state=state, batch=b, host=hb)
    return out


def _torchrun_mesh(spec: str, device):
    """The ``(data, model)`` mesh ``spec`` on torchrun's process group
    (``env://``; a card a rank by ``LOCAL_RANK``)."""
    import os
    import torch.distributed as dist
    from .mesh import make_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return make_mesh(tuple(int(x) for x in spec.split(",")), device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (the default)")
    ap.add_argument("--shape", default=None,
                    help="run the full-width cell of this shape instead: "
                         "minibatch_lg, full_graph_sm, molecule or "
                         "ogb_products (GNN), train_4k (LM), train_batch "
                         "(recsys)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="LM: sequences a step (default 8); recsys: users "
                         "a step (8 reduced, the cell's with --shape)")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM: tokens a sequence (default 64 reduced, the "
                         "cell's with --shape)")
    ap.add_argument("--ckpt-dir", default=None, help="LM: checkpoint dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="LM: resume from the newest step in --ckpt-dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="recsys: DATA,MODEL — run sharded on the ranks of "
                         "the process group torchrun starts (each rank its "
                         "table rows and data row's users)")
    args = ap.parse_args(argv)
    try:
        entry = get_arch(args.arch)
    except KeyError as exc:
        raise SystemExit(f"--arch {args.arch}: {exc.args[0]}") from None
    if entry.family == "psi":
        raise SystemExit(f"--arch {args.arch}: the psi family serves; use "
                         "repro_torch.launch.serve")
    if args.reduced and args.shape:
        raise SystemExit("--reduced and --shape exclude each other")
    if args.shape:
        try:
            entry.shape(args.shape)
        except KeyError as exc:
            raise SystemExit(f"--shape {args.shape}: {exc.args[0]}") from None
    if args.mesh and entry.family != "recsys":
        raise SystemExit("--mesh runs the recsys trainer only")
    if entry.family == "recsys":
        mesh = _torchrun_mesh(args.mesh, args.device) if args.mesh else None
        try:
            return train_recsys(args.arch, args.steps, args.device,
                                shape=args.shape, batch=args.batch,
                                mesh=mesh)
        finally:
            if mesh is not None:
                mesh.close()
    if entry.family == "lm":
        return train_lm(args.arch, args.steps, args.device, shape=args.shape,
                        batch=args.batch, seq=args.seq,
                        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        resume=args.resume)
    if args.shape == "minibatch_lg":
        return train_minibatch(args.steps, args.device, arch=args.arch)
    if args.shape:
        return train_full_batch(args.arch, args.shape, args.steps,
                                args.device)
    return train_reduced(args.steps, args.device, arch=args.arch)


if __name__ == "__main__":
    main()
