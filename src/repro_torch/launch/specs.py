"""Cell builders: (arch × shape × mesh) → one rank's step, its arguments
and the JAX cell's metadata.

The port of the JAX package's ``launch/specs.py``. A :class:`Cell` holds a
rank's step (``step``), a function that makes the rank's arguments on a
device (``make_args``: under ``FakeTensorMode`` it allocates nothing, on a
card it is the rank-0 run's input), the batch arrays' global shapes and
dtypes (``batch``), how each argument is laid out over the mesh
(``layout``), the JAX cell's ``meta`` key for key, and the L / L+1 probes
(1 and 2 layers for the LM family, 1 and 2 iterations for ψ) that the dry
run (:mod:`repro_torch.launch.dryrun`) traces. The mesh is a
:class:`~repro_torch.launch.mesh.Mesh`; each builder also takes ``None``
(one device).

* LM (:func:`build_lm_cell`): the JAX layout (``param_specs``, the batch
  over the src group where it splits, ``cache_specs``), the config's
  optimizer over ``cosine_schedule(3e-4, 10_000, 200)`` and the JAX
  ``_effective_accum``. A train cell's probes are the JAX probes: one
  microbatch, 1 and 2 layers.
* GNN (:func:`build_gnn_cell`): JAX's replicated parameters; JAX's batch
  layout, nodes and edges each over the src group where it divides them
  (:mod:`repro_torch.models.gnn.parallel`: a rank holds its node rows and
  its slice of the dst-sorted edges, the models gather and reduce over the
  src group), each rank's share of the gradients summed over it. A real
  run's rank makes only its shard: a full-graph cell's from chunked numpy
  seeds (:func:`~repro_torch.launch.train.full_graph_shard`; the whole
  ``ogb_products`` graph is never built), the others cut from the
  trainer's small synthetic batch. A traced cell's aggregation format has
  the shapes of the real one: a full-graph cell's from the shard's own
  receivers, the others' from seeded per-tile counts of the rank's real
  edges.
* recsys (:func:`build_recsys_cell`): MIND's tables row-sharded over the
  model group (``mind.param_specs``), each rank its data row's users.
* ψ (:func:`build_psi_cell`): one rank's block of :class:`~repro_torch.
  core.distributed.DistributedPsi` on the graph's dims, ``make_run`` of the
  config's ``chunk_iters``.

``_gnn_shape_dims``, ``_gnn_cfg_for``, ``_gnn_model_flops``, ``_GNN_MODS``
and ``_GEOMETRIC`` size the GNN trainer's cells too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..configs.registry import ArchEntry, ShapeCfg
from ..graphs.sampler import subgraph_budget
from ..models.gnn import equiformer_v2, nequip, pna, sage
from ..models import recsys as mind
from ..models import transformer as lm
from ..train import optim

__all__ = ["Cell", "build_cell", "build_lm_cell", "build_gnn_cell",
           "build_recsys_cell", "build_psi_cell"]


@dataclasses.dataclass
class Cell:
    """One rank's part of a cell; see the module docstring."""
    arch: str
    shape: str
    cfg: Any
    batch: dict                        # name -> (global shape, dtype)
    meta: dict                         # the JAX cell's meta
    step: Callable | None = None       # step(*make_args(device))
    make_args: Callable | None = None  # device -> the step's arguments
    layout: dict = dataclasses.field(default_factory=dict)
    probes: list["Cell"] | None = None


def _dp_size(mesh) -> int:
    return 1 if mesh is None else mesh.d


def _rows(mesh) -> str:
    return "replicated" if _dp_size(mesh) == 1 else "rows over the src group"


# ===================================================================== #
# LM family
# ===================================================================== #
def _opt_for(cfg):
    sched = optim.cosine_schedule(3e-4, 10_000, 200)
    if cfg.optimizer == "adafactor":
        return optim.adafactor(sched)
    return optim.adamw(sched)


def _effective_accum(cfg, mesh, batch: int) -> int:
    a = cfg.accum_steps
    dp = _dp_size(mesh)
    while a > 1 and (batch % a != 0 or (batch // a) % dp != 0):
        a //= 2
    return max(1, a)


def _tokens(gen, vocab: int, shape, dev) -> torch.Tensor:
    return torch.randint(0, vocab, shape, generator=gen, device=dev)


def build_lm_cell(entry: ArchEntry, shape: ShapeCfg, mesh, *,
                  probe_layers: int | None = None) -> Cell:
    cfg = entry.config()
    p = shape.params
    batch, seq = p["global_batch"], p["seq_len"]
    accum = _effective_accum(cfg, mesh, batch)
    if probe_layers is not None:
        # the JAX probe: one microbatch of the step, no accumulation
        cfg = dataclasses.replace(cfg, n_layers=probe_layers, accum_steps=1)
        if shape.kind == "train":
            batch = max(_dp_size(mesh), batch // accum)
            accum = 1
    rows = lm.local_batch(batch, mesh)
    c = min(seq, cfg.sliding_window or seq)
    eff_ctx = c
    params_layout = ("param_specs: TP over the model group, FSDP over the "
                     "src group" if cfg.fsdp else "param_specs: TP over the "
                     "model group, replicated over the src group")
    i64 = torch.int64

    def params_on(dev):
        return lm.init_params(cfg, 0, device=dev, mesh=mesh)

    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, accum_steps=accum)
        opt = _opt_for(cfg)
        tokens = batch * seq

        def make_args(dev):
            params = params_on(dev)
            gen = torch.Generator(dev).manual_seed(1)
            tok = _tokens(gen, cfg.vocab, (rows, seq), dev)
            return (params, opt.init(params, lm.param_layout(cfg, mesh)),
                    dict(tokens=tok, labels=torch.roll(tok, -1, 1)))

        meta = dict(kind="train",
                    model_flops=6 * lm.active_params(cfg) * tokens
                    + 6 * tokens * eff_ctx * cfg.q_dim,
                    layers=cfg.n_layers, accum=cfg.accum_steps,
                    tokens=tokens, params=lm.count_params(cfg))
        return Cell(entry.arch_id, shape.name, cfg,
                    dict(tokens=((batch, seq), i64),
                         labels=((batch, seq), i64)), meta,
                    lm.make_train_step(cfg, opt, mesh), make_args,
                    dict(params=params_layout, opt_state="as the params",
                         batch=_rows(mesh) + ", microbatch-major"))

    if shape.kind == "prefill":
        def make_args(dev):
            gen = torch.Generator(dev).manual_seed(1)
            return params_on(dev), _tokens(gen, cfg.vocab, (rows, seq), dev)

        meta = dict(kind="prefill",
                    model_flops=2 * lm.active_params(cfg) * batch * seq
                    + 2 * batch * seq * eff_ctx * cfg.q_dim,
                    layers=cfg.n_layers, tokens=batch * seq,
                    params=lm.count_params(cfg))
        return Cell(entry.arch_id, shape.name, cfg,
                    dict(tokens=((batch, seq), i64)), meta,
                    lm.make_prefill(cfg, mesh), make_args,
                    dict(params=params_layout, tokens=_rows(mesh),
                         cache_out="cache_specs: batch over the src group, "
                         "every KV head on every model rank"))

    def make_args(dev):                  # decode against a full cache
        gen = torch.Generator(dev).manual_seed(1)
        cache = lm.init_cache(cfg, batch, seq, device=dev, mesh=mesh)
        cache["pos"].copy_(torch.arange(c, device=dev).expand(rows, c))
        cache["t"] = c - 1
        return (params_on(dev), cache,
                _tokens(gen, cfg.vocab, (rows,), dev))

    meta = dict(kind="decode",
                model_flops=2 * lm.active_params(cfg) * batch
                + 2 * 2 * cfg.n_layers * batch * c * cfg.kv_dim,
                layers=cfg.n_layers, tokens=batch, cache_len=c,
                params=lm.count_params(cfg))
    return Cell(entry.arch_id, shape.name, cfg,
                dict(token=((batch,), i64)), meta,
                lm.make_decode_step(cfg, mesh), make_args,
                dict(params=params_layout, cache="cache_specs: batch over "
                     "the src group, every KV head on every model rank",
                     token=_rows(mesh)))


# ===================================================================== #
# GNN family
# ===================================================================== #
_GNN_MODS = {"pna": pna, "graphsage-reddit": sage, "nequip": nequip,
             "equiformer-v2": equiformer_v2}
_GEOMETRIC = {"nequip", "equiformer-v2"}


def _pad_to(x: int, mult: int = 2048) -> int:
    return -(-x // mult) * mult


def _gnn_shape_dims(shape: ShapeCfg) -> dict:
    """Static padded dims; padding uses sentinel edges / masked nodes."""
    p = shape.params
    if shape.kind == "full_graph":
        n, e = _pad_to(p["n_nodes"]), _pad_to(2 * p["n_edges"])
        return dict(n=n, e=e, d_feat=p["d_feat"],
                    n_classes=47 if n > 10 ** 6 else 7,
                    n_graphs=1, kind="node_class")
    if shape.kind == "minibatch":
        n, e = subgraph_budget(p["batch_nodes"], p["fanout"])
        return dict(n=_pad_to(n), e=_pad_to(e), d_feat=602, n_classes=41,
                    n_graphs=1, kind="node_class")
    # molecule
    n = _pad_to(p["n_nodes"] * p["batch"])
    e = _pad_to(2 * p["n_edges"] * p["batch"])
    return dict(n=n, e=e, d_feat=16, n_classes=1, n_graphs=p["batch"],
                kind="graph")


def _gnn_cfg_for(entry: ArchEntry, dims: dict):
    cfg = entry.config()
    kw = dict(d_feat=dims["d_feat"])
    if entry.arch_id in ("pna", "graphsage-reddit"):
        kw["out_kind"] = "graph" if dims["kind"] == "graph" else "node"
        kw["n_classes"] = dims["n_classes"]
    else:
        kw["out_kind"] = dims["kind"]
        kw["n_classes"] = dims["n_classes"] if dims["kind"] != "graph" else 1
    return dataclasses.replace(cfg, **kw)


def _gnn_model_flops(arch: str, cfg, n: int, e: int) -> int:
    """Analytic model FLOPs of a train step (dominant message/feature
    matmuls, fwd+bwd ~3x)."""
    L = cfg.n_layers
    if arch == "graphsage-reddit":
        h = cfg.d_hidden
        per = 2 * n * (cfg.d_feat * h + h * h)
        return 3 * L * (per + e * h)
    if arch == "pna":
        h = cfg.d_hidden
        return 3 * L * (2 * n * (13 * h) * h + 4 * e * h)
    if arch == "nequip":
        C = cfg.d_hidden
        n_paths = len(nequip.paths_for(cfg.l_max))
        per_edge = n_paths * (2 * cfg.l_max + 1) ** 2 * C * 2
        return 3 * L * e * per_edge
    # equiformer-v2
    C = cfg.d_hidden
    lm_, mm = cfg.l_max, cfg.m_max
    n0 = lm_ + 1
    so2 = 2 * ((n0 * C) ** 2 + 2 * sum(
        ((lm_ - m + 1) * C) ** 2 * 2 for m in range(1, mm + 1)))
    wigner = sum(2 * (2 * l + 1) ** 2 * C for l in range(lm_ + 1))
    return 3 * cfg.n_layers * e * (so2 + 2 * wigner)


def _tile_counts(n: int, receivers: tuple[int, int], e_real: int,
                 seed: int = 0) -> np.ndarray:
    """Seeded real-edge counts of each node tile of the aggregation format
    for ``e_real`` edges with receivers uniform over the nodes ``[lo,
    hi)`` of ``n``."""
    from ..kernels.agg import DEFAULT_TILES
    tile = DEFAULT_TILES[0]
    nodes = np.bincount(np.arange(*receivers) // tile,
                        minlength=-(-n // tile))
    if e_real == 0:
        return np.zeros_like(nodes)
    return np.random.default_rng(seed).multinomial(e_real,
                                                   nodes / nodes.sum())


def _fake_agg(n: int, counts: np.ndarray, dev):
    """An :class:`~repro_torch.kernels.agg.EdgeAgg` of the shapes that real
    edges of per-tile ``counts`` over ``n`` nodes give (the arrays are
    empty: for a traced step, whose values nobody reads)."""
    from ..kernels.agg import DEFAULT_TILES, EdgeAgg
    from ..kernels.ops import DeviceEdgeTiles
    tile, e1, e2 = DEFAULT_TILES
    num_tiles = -(-n // tile)
    e_real = int(counts.sum())
    nb = int(np.maximum(1, -(-counts // (e1 * e2))).sum())  # a block a tile

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    fmt = DeviceEdgeTiles(
        n=n, n_pad=num_tiles * tile, n_gather=num_tiles * tile + 1,
        tile=tile, e1=e1, e2=e2, num_tiles=num_tiles,
        src_idx=empty(nb, e1, e2), dst_local=empty(nb, e1, e2),
        block_tile=empty(nb), tile_first_block=empty(num_tiles),
        tile_num_blocks=empty(num_tiles), tile_order=empty(num_tiles))
    return EdgeAgg(fmt=fmt, edge_ids=empty(e_real, dtype=torch.int64),
                   slots=empty(e_real, dtype=torch.int64),
                   in_degree=empty(n, dtype=torch.int64),
                   tile_span=empty(num_tiles))


def _real_counts(shape: ShapeCfg, dims: dict) -> tuple[int, int]:
    """(real nodes, real directed edges) of a GNN cell."""
    p = shape.params
    if shape.kind == "full_graph":
        return p["n_nodes"], 2 * p["n_edges"]
    if shape.kind == "minibatch":
        return subgraph_budget(p["batch_nodes"], p["fanout"])
    return p["n_nodes"] * p["batch"], 2 * p["n_edges"] * p["batch"]


def _gnn_batch(entry, shape, cfg, dims, dev, mesh):
    """This rank's shard of the cell's padded batch on ``dev``
    (:func:`~repro_torch.models.gnn.parallel.split_flags` over ``mesh``):
    made from numpy seeds on a real device, of its shapes under
    ``FakeTensorMode``."""
    from ..kernels._build import is_fake
    from ..kernels.agg import DEFAULT_TILES
    from ..models.gnn.common import GraphBatch
    from ..models.gnn.parallel import (GraphSplit, row_range, shard_batch,
                                       split_flags)
    n, e = dims["n"], dims["e"]
    n_real, e_real = _real_counts(shape, dims)
    if not is_fake(torch.empty(0, device=dev)):
        from . import train
        if shape.kind == "full_graph":
            return train.full_graph_shard(
                n_real, e_real, n, e, dims["d_feat"], dims["n_classes"], dev,
                mesh=mesh, geometric=entry.arch_id in _GEOMETRIC)
        if shape.kind == "minibatch":
            data = train.synthetic_reddit(cfg, dev)
            seeds = np.random.default_rng(1000).choice(
                data.graph.n, shape.params["batch_nodes"], replace=False)
            mb, _ = train.sample_minibatch(data.graph, seeds,
                                           shape.params["fanout"], n=n, e=e,
                                           seed=0)
            return shard_batch(mb.to(dev).batch(data), mesh)
        return shard_batch(train.shape_batch(entry.arch_id, shape.name, cfg,
                                             dev), mesh)
    flags = split_flags(n, e, mesh)
    nodes, edges = flags or (False, False)
    nlo, nhi = row_range(n, mesh, nodes)
    elo, ehi = row_range(e, mesh, edges)
    rows = nhi - nlo
    tile = DEFAULT_TILES[0]
    if shape.kind == "full_graph":
        # the format of the shard's own receivers, block for block
        from .train import full_graph_receivers
        dst, _ = full_graph_receivers(n_real, e_real, n, elo, ehi)
        counts = np.bincount(dst[dst < n] // tile, minlength=-(-n // tile))
    else:
        # this rank's real edges, their receivers spread over the real
        # nodes as the dst order spreads them
        real = max(0, min(ehi, e_real) - elo)
        counts = _tile_counts(n, (elo * n_real // e_real, min(
            n_real, -(-(elo + real) * n_real // e_real))), real)
    graph = dims["kind"] == "graph"

    def t(*shp, dtype=torch.float32):
        return torch.empty(shp, dtype=dtype, device=dev)

    return GraphBatch(
        n=n, x=t(rows, dims["d_feat"]), src=t(ehi - elo, dtype=torch.int32),
        dst=t(ehi - elo, dtype=torch.int32),
        pos=t(rows, 3) if entry.arch_id in _GEOMETRIC else None,
        node_mask=t(rows, dtype=torch.bool),
        graph_ids=t(rows, dtype=torch.int32) if dims["n_graphs"] > 1
        else None,
        n_graphs=dims["n_graphs"],
        labels=t(dims["n_graphs"]) if graph else t(rows, dtype=torch.int64),
        seed_mask=t(rows, dtype=torch.bool) if shape.kind == "minibatch"
        else None,
        agg=_fake_agg(n, counts, dev),
        split=None if flags is None else GraphSplit(
            mesh=mesh, n=n, e=e, nodes=nodes, edges=edges,
            in_degree=t(rows, dtype=torch.int64)))


def _gnn_layout(flags) -> dict:
    """The cell's ``layout``: JAX's ``build_gnn_cell`` specs, rule for
    rule."""
    nodes, edges = flags or (False, False)
    return dict(
        params="replicated", opt_state="replicated",
        nodes=("x, pos, node_mask, graph_ids, seed_mask and node labels: "
               "rows over the src group, rank row r holds [r*n/d, "
               "(r+1)*n/d)" if nodes else "x, pos, node_mask, graph_ids, "
               "seed_mask and node labels replicated"),
        edges=("src, dst: over the src group, rank row r holds [r*e/d, "
               "(r+1)*e/d) of the padded dst-sorted edges, global node ids"
               if edges else "src, dst replicated"),
        graph_labels="replicated")


def build_gnn_cell(entry: ArchEntry, shape: ShapeCfg, mesh) -> Cell:
    """The GNN cell ``entry`` × ``shape``: a train step of the rank's
    shard of the padded batch (nodes and edges split over the src group
    where it divides them, as JAX's cell), its parameters and AdamW state
    whole on every rank."""
    from ..models.gnn.parallel import split_flags
    dims = _gnn_shape_dims(shape)
    mod = _GNN_MODS[entry.arch_id]
    cfg = _gnn_cfg_for(entry, dims)
    n, e = dims["n"], dims["e"]
    opt = optim.adamw(optim.cosine_schedule(1e-3, 10_000, 100))

    def make_args(dev):
        params = mod.init_params(cfg, 0, device=dev)
        return (params, opt.init(params),
                _gnn_batch(entry, shape, cfg, dims, dev, mesh))

    def step(params, opt_state, batch):
        from .train import train_step      # train imports this module
        return train_step(params, opt_state, batch, cfg, opt, mod, mesh)

    meta = dict(kind="gnn_train",
                model_flops=_gnn_model_flops(entry.arch_id, cfg, n, e),
                nodes=n, edges=e, layers=cfg.n_layers)
    f32, i32 = torch.float32, torch.int32
    return Cell(entry.arch_id, shape.name, cfg,
                dict(x=((n, dims["d_feat"]), f32), src=((e,), i32),
                     dst=((e,), i32)), meta, step, make_args,
                _gnn_layout(split_flags(n, e, mesh)))


# ===================================================================== #
# RecSys family
# ===================================================================== #
def build_recsys_cell(entry: ArchEntry, shape: ShapeCfg, mesh=None) -> Cell:
    """The cell ``entry`` × ``shape`` (``train_batch``, ``serve_p99``,
    ``serve_bulk`` or ``retrieval_cand``): ``batch`` the global batch
    arrays; each rank takes its data row's users (``retrieval``: one user,
    replicated) and its rows of the tables."""
    from . import train
    cfg = entry.config()
    p = shape.params
    d, H, K = cfg.embed_dim, cfg.hist_len, cfg.n_interests
    i32, b8 = torch.int32, torch.bool
    dp = _dp_size(mesh)
    row = 0 if mesh is None else mesh.row
    tables = "param_specs: table rows over the model group, the rest " \
        "replicated"

    def params_on(dev):
        params = mind.init_params(cfg, 0, device=dev)
        return params if mesh is None else mind.shard_params(params, mesh)

    def users_on(users, dev, train_batch):
        """This rank's share of the users, a seeded host batch (numpy seed
        1000 + its data row), on ``dev`` (the profile layout built on the
        host)."""
        if users % dp:
            raise ValueError(f"{users} users do not split over {dp} rows")
        hb = train.recsys_host_batch(cfg, users // dp,
                                     np.random.default_rng(1000 + row),
                                     tags=cfg.profile_tags,
                                     train=train_batch)
        return train.recsys_device_batch(hb, cfg, dev)

    if shape.kind in ("train", "serve"):
        b, tags = p["batch"], p["batch"] * cfg.profile_tags
        batch = dict(hist_ids=((b, H), i32), hist_mask=((b, H), b8),
                     profile_ids=((tags,), i32), profile_bags=((tags,), i32))
        extract = b * 2 * H * d * d * (cfg.capsule_iters + 1)
        layout = dict(params=tables, batch=_rows(mesh) + " (users)")
        if shape.kind == "serve":
            def serve(params, bt):
                return mind.user_interests(
                    params, bt["hist_ids"], bt["hist_mask"],
                    bt["profile_ids"], bt["profile_bags"], cfg, mesh,
                    profile_layout=bt["profile_layout"])

            return Cell(entry.arch_id, shape.name, cfg, batch,
                        dict(kind="serve", model_flops=extract, batch=b),
                        serve, lambda dev: (params_on(dev),
                                            users_on(b, dev, False)),
                        layout)
        batch.update(pos_ids=((b,), i32), neg_ids=((b, cfg.n_neg), i32))
        lookups = b * (H + 1 + cfg.n_neg + cfg.profile_tags)
        flops = 3 * (extract + b * cfg.n_neg * d + lookups * d)
        opt = optim.adamw(optim.cosine_schedule(1e-3, 10_000, 100))

        def make_args(dev):
            params = params_on(dev)
            return params, opt.init(params), users_on(b, dev, True)

        def train_step(params, state, bt):
            return train.recsys_step(params, state, bt, cfg, opt, mesh)

        layout.update(opt_state="as the params")
        return Cell(entry.arch_id, shape.name, cfg, batch,
                    dict(kind="train", model_flops=flops, lookups=lookups,
                         batch=b), train_step, make_args, layout)
    nc = p["n_candidates"]

    def make_args(dev):
        gen = torch.Generator(dev).manual_seed(1)
        return (params_on(dev),
                torch.randn(K, d, generator=gen, device=dev),
                torch.randint(0, cfg.n_items, (nc,), generator=gen,
                              device=dev))

    def retrieve(params, interests, cand_ids):
        return mind.retrieval_scores(params, interests, cand_ids, cfg, mesh)

    return Cell(entry.arch_id, shape.name, cfg,
                dict(interests=((K, d), torch.float32),
                     cand_ids=((nc,), i32)),
                dict(kind="retrieval", model_flops=2 * nc * d * K,
                     candidates=nc), retrieve, make_args,
                dict(params=tables, interests="replicated",
                     cand_ids="replicated"))


# ===================================================================== #
# psi family (the paper itself)
# ===================================================================== #
def _psi_graph_dims(name: str) -> tuple[int, int]:
    from ..graphs.datasets import DATASETS
    if name.startswith("rmat"):
        scale = int(name.removeprefix("rmat"))
        return (1 << scale), (1 << scale) * 16
    n, m, *_ = DATASETS[name]
    return n, m


def build_psi_cell(entry: ArchEntry, shape: ShapeCfg, mesh, *,
                   probe_iters: int | None = None) -> Cell:
    """One rank's block of the sharded Power-ψ on the dims of the shape's
    graph (the JAX cell's ``e_max``: twice the mean edges a block, padded
    to 128), ``chunk_iters`` steps (``probe_iters`` for a probe). A real
    run's block is seeded: local src ids uniform, the real edges of the
    block in dst runs of seeded lengths."""
    from ..core.distributed import DistPsiArrays, DistributedPsi
    from ..graphs.partition import Partition2D
    cfg = entry.config()
    n, m = _psi_graph_dims(shape.params["dataset"])
    d, mo = (1, 1) if mesh is None else (mesh.d, mesh.mo)
    q = -(-n // (d * mo))
    e_max = int(np.ceil(m / (d * mo) * 2.0 / 128)) * 128 + 128
    placeholder = np.broadcast_to(np.zeros((1,), np.int32), (d, mo, e_max))
    part = Partition2D(n=n, n_pad=d * mo * q, d=d, mo=mo, q=q,
                       src_local=placeholder, dst_local=placeholder,
                       e_counts=np.zeros((d, mo), np.int64))
    dist_psi = DistributedPsi(part, mesh)
    iters = probe_iters or cfg.chunk_iters
    run = dist_psi.make_run(chunk_iters=iters)
    f32, i64 = torch.float32, torch.int64

    def make_args(dev):
        gen = torch.Generator(dev).manual_seed(1)
        nc, real = part.nc, min(e_max, -(-m // (d * mo)))
        runs = torch.zeros(nc + 1, dtype=i64, device=dev)
        runs.index_add_(0, torch.randint(0, nc, (real,), generator=gen,
                                         device=dev),
                        torch.ones(real, dtype=i64, device=dev))
        runs[nc] += e_max - real                 # the sentinel run
        src = torch.randint(0, mo * q, (e_max,), generator=gen, device=dev)

        def vec(k):
            return torch.rand(k, generator=gen, device=dev)

        arrays = DistPsiArrays(
            src_local=src, lengths=runs, inv_w_src=vec(mo * q),
            mu_piece=vec(q), c_piece=vec(q), c_src=vec(mo * q),
            lam_piece=vec(q), d_piece=vec(q))
        return arrays.c_src.clone(), arrays

    meta = dict(kind="psi_iterate", nodes=n, edges=m, iters=iters,
                model_flops=iters * 3 * m)
    return Cell(entry.arch_id, shape.name, cfg,
                {k: v for k, v in dist_psi.input_specs().items()}, meta,
                run, make_args,
                dict(s="row r of the src layout (whole on the model group)",
                     arrays="DistributedPsi.shardings(): block (row, col) "
                     "of the [d, mo] grid; src-layout rows over the src "
                     "group"))


# ===================================================================== #
# Dispatcher
# ===================================================================== #
def build_cell(entry: ArchEntry, shape: ShapeCfg, mesh) -> Cell:
    if entry.family == "lm":
        cell = build_lm_cell(entry, shape, mesh)
        cell.probes = [build_lm_cell(entry, shape, mesh, probe_layers=1),
                       build_lm_cell(entry, shape, mesh, probe_layers=2)]
        return cell
    if entry.family == "gnn":
        return build_gnn_cell(entry, shape, mesh)
    if entry.family == "recsys":
        return build_recsys_cell(entry, shape, mesh)
    if entry.family == "psi":
        cell = build_psi_cell(entry, shape, mesh)
        cell.probes = [build_psi_cell(entry, shape, mesh, probe_iters=1),
                       build_psi_cell(entry, shape, mesh, probe_iters=2)]
        return cell
    raise ValueError(entry.family)
