"""NequIP — E(3)-equivariant interatomic potentials [arXiv:2101.03164].

Features are direct sums of real irreps {l: [N, 2l+1, C]} (l ≤ l_max = 2,
uniform multiplicity C = d_hidden). One interaction block:

  message  m_e^{l3} = Σ_{paths (l1,l2)} R_path(|r_e|) · CG^{l1 l2 l3}
                       · (x_src^{l1} ⊗ Y^{l2}(r̂_e))
  update   x^{l} ← SelfLinear_l( x^l + Σ_{e→v} m_e^l ),  gate nonlinearity
           (scalars: SiLU; l>0: sigmoid(scalar gates) scaling)

Radial R: Bessel basis (n_rbf) with polynomial cutoff envelope → MLP →
per-(path, channel) weights. Output: per-node scalar (energy) readout, or
graph-pooled regression for the ``molecule`` shape.

A port of the JAX package's ``models/gnn/nequip.py`` with its parameter
tree and guards (``+1e-12`` in the norm, ``max(dist, 1e-9)``, the clip in
:func:`_bessel`, the sentinel zero row of the features). Where the JAX
package scatters each path's messages with ``.at[dst].add``, the port sums
the paths of one output l on each edge and aggregates ``[E, (2l+1)·C]``
with one :func:`~repro_torch.models.gnn.common.segment_agg` (a ``seg_mm``
launch) per output l. A batch split over the data ranks gathers every
rank's positions and feature rows for its own edges.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ...device import resolve_device
from . import parallel, so3
from .common import (GraphBatch, dense_init, graph_pool, mlp_apply, mlp_init,
                     node_xent, params_to, segment_agg)

__all__ = ["NequIPConfig", "init_params", "apply", "loss_fn", "paths_for",
           "edge_geometry"]


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16              # input scalar features (species embed)
    out_kind: str = "graph"       # graph | node | node_class
    n_classes: int = 1
    dtype: torch.dtype = torch.float32


def paths_for(l_max: int) -> list[tuple[int, int, int]]:
    """All (l_in, l_filter, l_out) with every l ≤ l_max and CG-compatible."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, l3))
    return out


def _bessel(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel RBF with smooth polynomial envelope (DimeNet-style)."""
    rc = cutoff
    x = torch.clamp(r / rc, 1e-5, 1.0)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rbf = math.sqrt(2.0 / rc) * torch.sin(n * math.pi * x[..., None]) / (
        x[..., None] * rc)
    p = 6.0
    env = (1 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    return rbf * env[..., None]


def edge_geometry(batch: GraphBatch, dtype: torch.dtype):
    """(dist [E], r̂ [E, 3]) of every edge, sentinel edges included: the
    positions get a zero row at index n, so ``src = dst = n`` reads it."""
    pos_p = F.pad(parallel.gather_nodes(batch.pos.to(dtype), batch.split),
                  (0, 0, 0, 1))
    rvec = (pos_p.index_select(0, batch.src.long())
            - pos_p.index_select(0, batch.dst.long()))
    dist = torch.linalg.vector_norm(rvec + 1e-12, dim=-1)
    rhat = rvec / torch.clamp(dist[:, None], min=1e-9)
    return dist, rhat


def init_params(cfg: NequIPConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` (the JAX
    package's come over with :func:`repro_torch.convert.
    gnn_params_from_numpy`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    C = cfg.d_hidden
    n_paths = len(paths_for(cfg.l_max))
    embed = dense_init(gen, cfg.d_feat, C, cfg.dtype)
    layers = []
    for _ in range(cfg.n_layers):
        radial = mlp_init(gen, [cfg.n_rbf, 32, n_paths * C], cfg.dtype)
        self_lin = {f"l{l}": dense_init(gen, C, C, cfg.dtype)
                    for l in range(cfg.l_max + 1)}
        gates = dense_init(gen, C, cfg.l_max * C, cfg.dtype)
        layers.append(dict(radial=radial, self_lin=self_lin, gates=gates))
    head = mlp_init(gen, [C, 32, cfg.n_classes], cfg.dtype)
    return params_to(dict(embed=embed, layers=layers, head=head), dev)


def apply(params: dict, batch: GraphBatch, cfg: NequIPConfig) -> torch.Tensor:
    """→ per-node output [n, n_classes] (pool for graph tasks in loss)."""
    n, C, dt = batch.n_local, cfg.d_hidden, cfg.dtype
    paths = paths_for(cfg.l_max)
    src = batch.src.long()
    e = src.shape[0]
    dist, rhat = edge_geometry(batch, dt)
    ys = so3.sph_harm_all(cfg.l_max, rhat)          # per l: [E, 2l+1]
    rbf = _bessel(dist, cfg.n_rbf, cfg.cutoff)      # [E, n_rbf]

    # features: x[l] : [n, 2l+1, C]
    x = {0: (batch.x.to(dt) @ params["embed"]["w"]
             + params["embed"]["b"])[:, None, :]}
    for l in range(1, cfg.l_max + 1):
        x[l] = torch.zeros(n, 2 * l + 1, C, dtype=dt, device=batch.device)

    cg = {p: torch.as_tensor(so3.real_cg(*p), dtype=dt, device=batch.device)
          for p in paths}

    for lyr in params["layers"]:
        w = mlp_apply(lyr["radial"], rbf).reshape(-1, len(paths), C)  # [E,P,C]
        # the sentinel row n is zero, so src == n gathers zeros
        xs = {l: F.pad(parallel.gather_nodes(x[l], batch.split),
                       (0, 0, 0, 0, 0, 1)).index_select(0, src)
              for l in x}                            # [E, 2l+1, C]
        msgs = {}
        for pi, (l1, l2, l3) in enumerate(paths):
            msg = torch.einsum("pqr,epc,eq->erc", cg[(l1, l2, l3)], xs[l1],
                               ys[l2]) * w[:, pi][:, None, :]
            msgs[l3] = msg if l3 not in msgs else msgs[l3] + msg
        agg = {l: segment_agg(m.reshape(e, -1), batch.dst, batch.n, "sum",
                              agg=batch.agg, split=batch.split
                              ).reshape(n, 2 * l + 1, C)
               for l, m in msgs.items()}
        gates = torch.sigmoid(
            x[0][:, 0, :] @ lyr["gates"]["w"] + lyr["gates"]["b"]
        ).reshape(n, cfg.l_max, C)
        new_x = {}
        for l in range(cfg.l_max + 1):
            h = torch.einsum("nmc,cd->nmd", x[l] + agg[l],
                             lyr["self_lin"][f"l{l}"]["w"])
            if l == 0:
                h = F.silu(h + lyr["self_lin"]["l0"]["b"])
            else:
                h = h * gates[:, l - 1][:, None, :]
            new_x[l] = h
        x = new_x

    return mlp_apply(params["head"], x[0][:, 0, :])


def regression_or_class_loss(out: torch.Tensor, batch: GraphBatch,
                             out_kind: str) -> torch.Tensor:
    """The JAX package's NequIP / EquiformerV2 loss on per-node outputs:
    graph-pooled (sum) MSE, node cross-entropy or masked node MSE."""
    if out_kind == "graph":
        pooled = graph_pool(out, batch, "sum")[:, 0]
        return torch.mean(torch.square(pooled - batch.labels))
    if out_kind == "node_class":
        return node_xent(out, batch.labels, batch.node_mask,
                         split=batch.split)
    mask = (batch.node_mask if batch.node_mask is not None else
            torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
            ).to(torch.float32)
    return parallel.total(torch.sum(torch.square(out[:, 0] - batch.labels)
                                    * mask), batch.split) / \
        torch.clamp(parallel.total(mask.sum(), batch.split), min=1.0)


def loss_fn(params: dict, batch: GraphBatch, cfg: NequIPConfig
            ) -> torch.Tensor:
    return regression_or_class_loss(apply(params, batch, cfg), batch,
                                    cfg.out_kind)
