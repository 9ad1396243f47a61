"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

Per layer: 4 aggregators (mean, max, min, std) × 3 degree scalers
(identity, amplification log(d+1)/δ, attenuation δ/log(d+1)) concatenated
(12·F) → linear tower, residual + norm. δ = mean of log(d+1) over the
training graph (passed in via config or computed from the batch).

A port of the JAX package's ``models/gnn/pna.py``: the same parameter tree
(``enc``, ``layers``, ``head``; ``w[d_in, d_out]``), per-layer
rematerialisation through ``torch.utils.checkpoint`` (non-reentrant) in
place of ``jax.checkpoint``, and the mean and std through
:func:`~repro_torch.models.gnn.common.segment_agg` over the batch's
:class:`~repro_torch.models.gnn.common.EdgeAgg`, so through the ``seg_mm``
kernel. The in-degree is the format's count of real edges. A sentinel
sender (``src = n``) gathers row ``n − 1``, as JAX clamps the index; its
message lands in the dropped segment ``n``. A batch split over the data
ranks (``batch.split``) gathers every rank's rows of ``h`` for its own
edges' messages, and its degree scalers read the global in-degree of its
own rows.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from . import parallel
from .common import (GraphBatch, dense_init, graph_pool, in_degree,
                     node_xent, params_to, segment_agg)

__all__ = ["PNAConfig", "init_params", "apply", "loss_fn"]

_AGGS = ("mean", "max", "min", "std")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_feat: int = 1433
    n_classes: int = 7
    delta: float = 2.5            # avg log-degree normalizer
    out_kind: str = "node"        # node | graph
    dtype: torch.dtype = torch.float32


def init_params(cfg: PNAConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` (the JAX
    package's come over with :func:`repro_torch.convert.
    gnn_params_from_numpy`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    enc = dense_init(gen, cfg.d_feat, cfg.d_hidden, cfg.dtype)
    layers = [dense_init(gen, 12 * cfg.d_hidden + cfg.d_hidden, cfg.d_hidden,
                         cfg.dtype) for _ in range(cfg.n_layers)]
    head = dense_init(gen, cfg.d_hidden, cfg.n_classes, cfg.dtype)
    return params_to(dict(enc=enc, layers=layers, head=head), dev)


def _layer(h: torch.Tensor, lyr: dict, batch: GraphBatch,
           scalers: tuple) -> torch.Tensor:
    src = torch.clamp(batch.src.long(), max=batch.n - 1)
    msgs = parallel.gather_nodes(h, batch.split).index_select(0, src)
    aggs = [segment_agg(msgs, batch.dst, batch.n, a, agg=batch.agg,
                        split=batch.split) for a in _AGGS]
    feats = [a * s[:, None] for a in aggs for s in scalers]
    z = torch.cat([h] + feats, dim=-1)
    return h + F.silu(z @ lyr["w"] + lyr["b"])


def apply(params: dict, batch: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    h = batch.x.to(cfg.dtype) @ params["enc"]["w"] + params["enc"]["b"]
    logd = torch.log(in_degree(batch).to(cfg.dtype) + 1.0)
    scalers = (torch.ones_like(logd), logd / cfg.delta,
               cfg.delta / torch.clamp(logd, min=1e-2))
    for lyr in params["layers"]:
        h = checkpoint(_layer, h, lyr, batch, scalers, use_reentrant=False,
                       preserve_rng_state=False)
    return h @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params: dict, batch: GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    logits = apply(params, batch, cfg)
    if cfg.out_kind == "graph":
        pooled = graph_pool(logits, batch, "mean")
        return torch.mean(torch.square(pooled[:, 0] - batch.labels))
    return node_xent(logits, batch.labels, batch.node_mask,
                     split=batch.split)
