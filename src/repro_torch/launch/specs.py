"""Cell sizing for the GNN and recsys families: the JAX package's
``launch/specs.py`` GNN and recsys sections without their sharding and
lowering (TPU dry-run machinery).

``_gnn_shape_dims`` turns a registry shape into the static padded dims of a
train step, ``_gnn_cfg_for`` fits the arch's config to them and
``_gnn_model_flops`` counts the step's dominant matmul FLOPs, so the trainer
sizes a cell from the same code as the JAX package. ``_GNN_MODS`` maps each
GNN arch to its model module and ``_GEOMETRIC`` names the archs that read
positions. :func:`build_recsys_cell` gives a recsys cell's batch arrays
(shape and dtype) and the JAX cell's ``meta`` (kind, model FLOPs, lookups,
batch, candidates).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.registry import ArchEntry, ShapeCfg
from ..graphs.sampler import subgraph_budget
from ..models.gnn import equiformer_v2, nequip, pna, sage

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


# --------------------------------------------------------------------- #
# RecSys family
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RecsysCell:
    """A recsys cell: the full config, each batch array's (shape, dtype)
    and the JAX cell's ``meta``."""
    arch: str
    shape: str
    cfg: object
    batch: dict
    meta: dict


def build_recsys_cell(entry: ArchEntry, shape: ShapeCfg) -> RecsysCell:
    """The cell ``entry`` × ``shape`` (``train_batch``, ``serve_p99``,
    ``serve_bulk`` or ``retrieval_cand``)."""
    cfg = entry.config()
    p = shape.params
    d, H, K = cfg.embed_dim, cfg.hist_len, cfg.n_interests
    i32, b8 = torch.int32, torch.bool
    if shape.kind in ("train", "serve"):
        b, tags = p["batch"], p["batch"] * cfg.profile_tags
        batch = dict(hist_ids=((b, H), i32), hist_mask=((b, H), b8),
                     profile_ids=((tags,), i32), profile_bags=((tags,), i32))
        extract = b * 2 * H * d * d * (cfg.capsule_iters + 1)
        if shape.kind == "serve":
            return RecsysCell(entry.arch_id, shape.name, cfg, batch,
                              dict(kind="serve", model_flops=extract,
                                   batch=b))
        batch.update(pos_ids=((b,), i32), neg_ids=((b, cfg.n_neg), i32))
        lookups = b * (H + 1 + cfg.n_neg + cfg.profile_tags)
        flops = 3 * (extract + b * cfg.n_neg * d + lookups * d)
        return RecsysCell(entry.arch_id, shape.name, cfg, batch,
                          dict(kind="train", model_flops=flops,
                               lookups=lookups, batch=b))
    nc = p["n_candidates"]
    return RecsysCell(entry.arch_id, shape.name, cfg,
                      dict(interests=((K, d), torch.float32),
                           cand_ids=((nc,), i32)),
                      dict(kind="retrieval", model_flops=2 * nc * d * K,
                           candidates=nc))
