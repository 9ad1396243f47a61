"""GraphSAGE [arXiv:1706.02216] — mean aggregator, fanout-sampled training.

h_v^{k+1} = σ( W_self h_v ⊕ W_neigh · mean_{u∈N(v)} h_u )   (concat variant)

A port of the JAX package's ``models/gnn/sage.py``: the same parameter tree
(``{"layers": [{"w_self": {"w", "b"}, "w_neigh": {...}}], "head": {...}}``,
``w`` as ``[d_in, d_out]``), the same per-layer rematerialisation
(``torch.utils.checkpoint``, non-reentrant, in place of ``jax.checkpoint``:
the layer's messages are recomputed in the backward pass instead of kept),
and the neighbour mean through the ``seg_mm`` kernel
(:func:`repro_torch.models.gnn.common.neighbor_agg`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from .common import (GraphBatch, dense_init, graph_pool, neighbor_agg,
                     node_xent, params_to)

__all__ = ["SageConfig", "init_params", "apply", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class SageConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    sample_sizes: tuple[int, ...] = (25, 10)
    d_feat: int = 602
    n_classes: int = 41
    out_kind: str = "node"        # node | graph (molecule shape)
    dtype: torch.dtype = torch.float32


def init_params(cfg: SageConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` (not the JAX
    package's numbers: carry those over with
    :func:`repro_torch.convert.sage_params_from_numpy`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append(dict(
            w_self=dense_init(gen, d_in, cfg.d_hidden, cfg.dtype),
            w_neigh=dense_init(gen, d_in, cfg.d_hidden, cfg.dtype)))
        d_in = cfg.d_hidden
    head = dense_init(gen, cfg.d_hidden, cfg.n_classes, cfg.dtype)
    return params_to(dict(layers=layers, head=head), dev)


def _layer(h: torch.Tensor, lyr: dict, batch: GraphBatch,
           aggregator: str) -> torch.Tensor:
    agg = neighbor_agg(h, batch, aggregator)
    h = F.relu(h @ lyr["w_self"]["w"] + lyr["w_self"]["b"]
               + agg @ lyr["w_neigh"]["w"] + lyr["w_neigh"]["b"])
    # L2 normalize as in the paper
    return h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                           min=1e-6)


def apply(params: dict, batch: GraphBatch, cfg: SageConfig) -> torch.Tensor:
    """→ logits f[n, n_classes]."""
    h = batch.x.to(cfg.dtype)
    for lyr in params["layers"]:
        h = checkpoint(_layer, h, lyr, batch, cfg.aggregator,
                       use_reentrant=False, preserve_rng_state=False)
    return h @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params: dict, batch: GraphBatch, cfg: SageConfig) -> torch.Tensor:
    logits = apply(params, batch, cfg)
    if cfg.out_kind == "graph":
        pooled = graph_pool(logits, batch, "mean")
        return torch.mean(torch.square(pooled[:, 0] - batch.labels))
    return node_xent(logits, batch.labels, batch.seed_mask
                     if batch.seed_mask is not None else batch.node_mask,
                     split=batch.split)
