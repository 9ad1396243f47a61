"""EquiformerV2 — equivariant graph attention via eSCN convolutions
[arXiv:2306.12059].

Rotating each edge's irrep features into the edge frame makes the
tensor-product convolution block-diagonal in m, reducing the O(L⁶) CG
contraction to O(L³) dense matmuls. Per block:

  1. equivariant RMS norm (per-l, learned per-channel scale),
  2. rotate src/dst features to the edge frame with real Wigner matrices
     (``so3.wigner_real``), truncated to |m| ≤ m_max (columns sliced from D,
     so the truncation costs nothing),
  3. SO(2) convolution: one dense matmul per m (complex-structured W_r/W_i
     pairs for m > 0), modulated by a radial MLP,
  4. multi-head attention: logits from the m=0 (scalar) channels of src ⊕
     dst → segment-softmax over incoming edges,
  5. rotate messages back, scatter-sum onto destinations, per-l output
     linear, residual; then a gated equivariant FFN.

Wigner matrices are computed once per forward and shared across layers.

A port of the JAX package's ``models/gnn/equiformer_v2.py`` with its
parameter tree. The rotated-back messages of every l are concatenated into
one ``[E, (L+1)²·C]`` block and summed onto the receivers by one
:func:`~repro_torch.models.gnn.common.segment_agg`, a ``seg_mm`` launch at
d = 49·128 = 6,272 for the full config (the JAX package scatters each l
with ``.at[dst].add``). Each block is rematerialised in the backward pass
(``torch.utils.checkpoint``, non-reentrant): it moves no number, and keeps
one block's edge tensors (~3 GB at the ``molecule`` shape in f32) alive
instead of twelve. A batch split over the data ranks gathers every rank's
normed rows for its own edges' senders and receivers, and its segment
softmax takes each row's maximum and sum over every rank's edges.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from . import parallel, so3
from .common import (GraphBatch, dense_init, mlp_apply, mlp_init, params_to,
                     segment_agg, segment_softmax)
from .nequip import _bessel, edge_geometry, regression_or_class_loss

__all__ = ["EquiformerV2Config", "init_params", "apply", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16
    out_kind: str = "graph"        # graph | node | node_class
    n_classes: int = 1
    dtype: torch.dtype = torch.float32


def _m_layout(l_max: int, m_max: int):
    """Truncated per-l kept-m columns and per-m row groups."""
    kept_cols = []      # per l: indices of kept m within [0, 2l+1)
    trunc_lm = []       # (l, m) in truncated row order
    for l in range(l_max + 1):
        cols = [l + m for m in range(-min(l, m_max), min(l, m_max) + 1)]
        kept_cols.append(np.asarray(cols, np.int32))
        trunc_lm += [(l, m) for m in range(-min(l, m_max), min(l, m_max) + 1)]
    groups = {}
    for m in range(-m_max, m_max + 1):
        groups[m] = np.asarray(
            [i for i, (l, mm) in enumerate(trunc_lm) if mm == m], np.int32)
    km = len(trunc_lm)
    return kept_cols, groups, km


def init_params(cfg: EquiformerV2Config, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` (the JAX
    package's come over with :func:`repro_torch.convert.
    gnn_params_from_numpy`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    C, L, M, dt = cfg.d_hidden, cfg.l_max, cfg.m_max, cfg.dtype
    _, groups, _ = _m_layout(L, M)
    n0 = groups[0].shape[0]                       # #l's at m=0 (= L+1)
    embed = dense_init(gen, cfg.d_feat, C, dt)
    layers = []
    for _ in range(cfg.n_layers):
        lp = dict(
            norm_scale=torch.ones(L + 1, C, dtype=dt),
            w0=dense_init(gen, n0 * C, n0 * C, dt),
            alpha=mlp_init(gen, [2 * n0 * C, 64, cfg.n_heads], dt),
            radial=mlp_init(gen, [cfg.n_rbf, 32, (M + 1) * C], dt),
            out={f"l{l}": dense_init(gen, C, C, dt) for l in range(L + 1)},
            ffn_gate=dense_init(gen, C, L * C, dt),
            ffn={f"l{l}": dense_init(gen, C, C, dt) for l in range(L + 1)},
        )
        for m in range(1, M + 1):
            nm = groups[m].shape[0]
            lp[f"w{m}r"] = dense_init(gen, nm * C, nm * C, dt)
            lp[f"w{m}i"] = dense_init(gen, nm * C, nm * C, dt)
        layers.append(lp)
    head = mlp_init(gen, [C, 64, cfg.n_classes], dt)
    return params_to(dict(embed=embed, layers=layers, head=head), dev)


def _so2_conv(pieces, lp, C, m_max, radial, inv_order):
    """``pieces``: the edge-frame features [E, ·, C] of the m groups in the
    order 0, 1, −1, …, m_max, −m_max; radial: [E, M+1, C]. → [E, Km, C] in
    row order (``inv_order`` undoes the grouping: the groups partition the
    rows)."""
    e, n0 = pieces[0].shape[:2]
    y0 = pieces[0].reshape(e, n0 * C) @ lp["w0"]["w"] + lp["w0"]["b"]
    out = [y0.reshape(e, n0, C) * radial[:, 0][:, None, :]]
    for m in range(1, m_max + 1):
        nm = pieces[2 * m - 1].shape[1]
        a = pieces[2 * m - 1].reshape(e, nm * C)
        b = pieces[2 * m].reshape(e, nm * C)
        wr, wi = lp[f"w{m}r"]["w"], lp[f"w{m}i"]["w"]
        yp = (a @ wr - b @ wi).reshape(e, nm, C)
        yn = (a @ wi + b @ wr).reshape(e, nm, C)
        scale = radial[:, m][:, None, :]
        out += [yp * scale, yn * scale]
    return torch.cat(out, dim=1).index_select(1, inv_order)


def _block(x, lp, batch, dws, rbf, cfg, layout):
    """One attention block and its gated FFN: x [n, (L+1)², C] → same."""
    n, C, L, M, H = (batch.n_local, cfg.d_hidden, cfg.l_max, cfg.m_max,
                     cfg.n_heads)
    kept_cols, order, group_sizes, km, inv_order = layout
    # the per-l blocks of a [.., (L+1)², C] tensor (split, not sliced: the
    # backward of a split is one concatenation)
    sizes = [2 * l + 1 for l in range(L + 1)]
    src, dst = batch.src.long(), batch.dst.long()
    e = src.shape[0]

    # --- equivariant norm --------------------------------------------- #
    xs = []
    for l, blk in enumerate(torch.split(x, sizes, dim=1)):
        rms = torch.sqrt(torch.mean(torch.square(blk), dim=(1, 2),
                                    keepdim=True) + 1e-6)
        xs.append(blk / rms * lp["norm_scale"][l][None, None, :])
    # the sentinel row n is zero, so src == n and dst == n gather zeros
    xn_p = F.pad(parallel.gather_nodes(torch.cat(xs, dim=1), batch.split),
                 (0, 0, 0, 0, 0, 1))

    # --- rotate into edge frames (truncated) -------------------------- #
    def to_frame(feats):
        return torch.cat([torch.einsum("eak,eac->ekc", dws[l], blk)
                          for l, blk in enumerate(torch.split(feats, sizes,
                                                              dim=1))],
                         dim=1)                     # [E, Km, C]

    # the source's rows by m group (one gather), the receiver's m = 0 rows
    pieces = torch.split(to_frame(xn_p.index_select(0, src)).index_select(
        1, order), group_sizes, dim=1)
    g0_dst = to_frame(xn_p.index_select(0, dst)).index_select(
        1, order[:group_sizes[0]])

    # --- attention logits from scalar (m=0) channels ------------------ #
    feat = torch.cat([pieces[0].reshape(-1, (L + 1) * C),
                      g0_dst.reshape(-1, (L + 1) * C)], dim=-1)
    logits = mlp_apply(lp["alpha"], feat)           # [E, H]
    att = segment_softmax(logits, batch.dst, batch.n,
                          split=batch.split)         # [E, H]

    # --- SO(2) conv value + heads ------------------------------------- #
    radial = mlp_apply(lp["radial"], rbf).reshape(-1, M + 1, C)
    val = _so2_conv(pieces, lp, C, M, radial, inv_order)
    val = val.reshape(e, km, H, C // H)
    msg = (val * att[:, None, :, None]).reshape(-1, km, C)

    # --- rotate back + aggregate: one seg_mm over every l ------------- #
    kept = torch.split(msg, [k.shape[0] for k in kept_cols], dim=1)
    back = torch.cat([torch.einsum("eak,ekc->eac", dws[l], blk)
                      for l, blk in enumerate(kept)], dim=1)  # [E, (L+1)², C]
    agg = segment_agg(back.reshape(e, -1), batch.dst, batch.n, "sum",
                      agg=batch.agg, split=batch.split
                      ).reshape(n, (L + 1) ** 2, C)

    # per-l output linear + residual
    x = x + torch.cat([torch.einsum("nmc,cd->nmd", blk,
                                    lp["out"][f"l{l}"]["w"])
                       for l, blk in enumerate(torch.split(agg, sizes,
                                                           dim=1))], dim=1)

    # --- gated equivariant FFN ---------------------------------------- #
    gates = torch.sigmoid(x[:, 0] @ lp["ffn_gate"]["w"]
                          + lp["ffn_gate"]["b"]).reshape(n, L, C)
    f = []
    for l, blk in enumerate(torch.split(x, sizes, dim=1)):
        h = torch.einsum("nmc,cd->nmd", blk, lp["ffn"][f"l{l}"]["w"])
        if l == 0:
            h = F.silu(h + lp["ffn"]["l0"]["b"][None, None, :])
        else:
            h = h * gates[:, l - 1][:, None, :]
        f.append(h)
    return x + torch.cat(f, dim=1)


def apply(params: dict, batch: GraphBatch,
          cfg: EquiformerV2Config) -> torch.Tensor:
    n, C, L, M, dt = (batch.n_local, cfg.d_hidden, cfg.l_max, cfg.m_max,
                      cfg.dtype)
    dev = batch.device
    kept_cols, groups, km = _m_layout(L, M)
    grouped = [groups[0]] + [groups[s * m] for m in range(1, M + 1)
                             for s in (1, -1)]
    order = np.concatenate(grouped)
    layout = (kept_cols, torch.as_tensor(order, dtype=torch.long, device=dev),
              [g.shape[0] for g in grouped], km,
              torch.as_tensor(np.argsort(order), device=dev))

    dist, rhat = edge_geometry(batch, dt)
    rbf = _bessel(dist, cfg.n_rbf, cfg.cutoff)

    # Wigner matrices per l, truncated columns — once per forward
    alpha_ang, cb = so3.rotation_angles(rhat)
    dws = [so3.wigner_real(l, alpha_ang, cb)[:, :, torch.as_tensor(
        kept_cols[l], dtype=torch.long, device=dev)]
        for l in range(L + 1)]                       # [E, 2l+1, kl]

    # features: flat irreps [N, (L+1)^2, C]
    x0 = batch.x.to(dt) @ params["embed"]["w"] + params["embed"]["b"]
    x = torch.cat([x0[:, None, :], x0.new_zeros(n, (L + 1) ** 2 - 1, C)],
                  dim=1)
    for lp in params["layers"]:
        x = checkpoint(_block, x, lp, batch, dws, rbf, cfg, layout,
                       use_reentrant=False, preserve_rng_state=False)
    return mlp_apply(params["head"], x[:, 0])


def loss_fn(params: dict, batch: GraphBatch,
            cfg: EquiformerV2Config) -> torch.Tensor:
    return regression_or_class_loss(apply(params, batch, cfg), batch,
                                    cfg.out_kind)
