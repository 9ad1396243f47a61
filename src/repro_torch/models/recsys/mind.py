"""MIND — Multi-Interest Network with Dynamic routing [arXiv:1904.08030].

A port of the JAX package's ``models/recsys/mind.py``. User behaviour
sequence → item embeddings → **B2I dynamic capsule routing** (4 capsules,
3 routing iterations, squash) → label-aware attention (train) / max-dot
retrieval (serve). Shapes: train_batch 65,536 (sampled softmax), serve_p99
512 / serve_bulk 262,144 (interest extraction), retrieval_cand 1 user ×
10⁶ candidates (one batched product).

The item table (4M × 64) goes through :func:`~repro_torch.models.recsys.
embedding.sharded_lookup`; the user profile tags through the ragged
:func:`~repro_torch.models.recsys.embedding.embedding_bag` (the ``seg_mm``
kernel on a card). ``mesh`` is ``None`` (one device) or a
:class:`~repro_torch.launch.mesh.Mesh` whose ranks hold the row shards of
both tables (:func:`shard_params`) and their data row's users.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ...device import resolve_device
from .embedding import embedding_bag, model_ranks, sharded_lookup

__all__ = ["MINDConfig", "init_params", "param_specs", "shard_params",
           "user_interests",
           "train_loss", "loss_and_grads", "retrieval_scores"]


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 4_194_304
    n_profile: int = 131_072
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    profile_tags: int = 8          # avg multi-hot tags per user
    n_neg: int = 1024              # sampled-softmax negatives
    pow_p: float = 2.0             # label-aware attention sharpness
    dtype: torch.dtype = torch.float32


def init_params(cfg: MINDConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """The JAX package's tree and scales (tables N(0, 0.02²), the two
    d × d maps N(0, 1/d), ``b_init`` N(0, 1)) from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (not the JAX package's numbers:
    carry those over with :func:`repro_torch.convert.mind_params_from_jax`).
    ``b_init`` is the fixed routing-logit init: it gets no gradient."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    d = cfg.embed_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=cfg.dtype, device=dev)

    params = dict(
        item_emb=normal(cfg.n_items, d) * 0.02,
        profile_emb=normal(cfg.n_profile, d) * 0.02,
        bilinear=normal(d, d) / math.sqrt(d),
        profile_proj=normal(d, d) / math.sqrt(d),
        b_init=normal(cfg.n_interests, cfg.hist_len))
    return {k: v.requires_grad_() for k, v in params.items()}


def param_specs(cfg: MINDConfig) -> dict:
    """The JAX package's ``param_specs``: the two tables' rows over the
    model group (``P("model", None)``), the rest whole on every rank (the
    layout spec of :mod:`repro_torch.launch.mesh`)."""
    return dict(item_emb=("model", None), profile_emb=("model", None),
                bilinear=(None, None), profile_proj=(None, None),
                b_init=(None, None))


def shard_params(params: dict, mesh) -> dict:
    """This rank's parameters: its rows of ``item_emb`` and ``profile_emb``
    (the JAX package's ``P("model", None)``), the rest whole. Each leaf a
    new leaf tensor that requires grad."""
    mo = model_ranks(mesh)
    out = {}
    for k, v in params.items():
        if k in ("item_emb", "profile_emb") and mo > 1:
            if v.shape[0] % mo:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split over "
                                 f"{mo} model ranks")
            rows = v.shape[0] // mo
            v = v[mesh.col * rows:(mesh.col + 1) * rows]
        out[k] = v.detach().clone().requires_grad_()
    return out


def _squash(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n2 = torch.sum(z * z, dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


def user_interests(params, hist_ids, hist_mask, profile_ids, profile_bags,
                   cfg: MINDConfig, mesh=None, *,
                   profile_layout=None) -> torch.Tensor:
    """→ interest capsules f[B, K, d].

    hist_ids: i64[B, H]; hist_mask: bool[B, H]; profile_ids: i64[B·tags]
    ragged multi-hot; profile_bags: i64[B·tags] sorted; ``profile_layout``
    their :func:`~repro_torch.models.recsys.embedding.bag_layout`."""
    b = hist_ids.shape[0]
    K, H = cfg.n_interests, cfg.hist_len
    e = sharded_lookup(params["item_emb"], hist_ids, mesh)      # [B, H, d]
    e = e * hist_mask[..., None].to(e.dtype)
    eh = torch.matmul(e, params["bilinear"])                     # ê_i
    prof = embedding_bag(params["profile_emb"], profile_ids, profile_bags, b,
                         mode="mean", layout=profile_layout,
                         mesh=mesh) @ params["profile_proj"]     # [B, d]
    logit_mask = e.new_zeros(b, 1, H).masked_fill(~hist_mask[:, None, :],
                                                  -1e30)
    # the routing logits start at the fixed init, outside the gradient
    # (the JAX package's stop_gradient)
    bk = params["b_init"].detach()[None].expand(b, K, H)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(bk + logit_mask, dim=1)                # over K
        u = _squash(torch.bmm(w, eh))                            # [B, K, d]
        bk = bk + torch.bmm(u, eh.transpose(1, 2))
    return u + prof[:, None, :]                                  # fusion


def train_loss(params, batch: dict, cfg: MINDConfig,
               mesh=None) -> torch.Tensor:
    """Sampled-softmax loss, the mean over the batch's users. batch:
    hist_ids, hist_mask, profile_ids, profile_bags, pos_ids i64[B],
    neg_ids i64[B, n_neg], and optionally profile_layout."""
    u = user_interests(params, batch["hist_ids"], batch["hist_mask"],
                       batch["profile_ids"], batch["profile_bags"], cfg,
                       mesh, profile_layout=batch.get("profile_layout"))
    e_pos = sharded_lookup(params["item_emb"], batch["pos_ids"], mesh)
    e_neg = sharded_lookup(params["item_emb"], batch["neg_ids"], mesh)
    # label-aware attention: p_u = Σ_k softmax(|u_k · e_pos|^p sign) u_k
    att = torch.bmm(u, e_pos[:, :, None])[..., 0]                # [B, K]
    att = torch.softmax(torch.pow(torch.abs(att), cfg.pow_p)
                        * torch.sign(att), dim=-1)
    pu = torch.bmm(att[:, None, :], u)                           # [B, 1, d]
    lp = torch.sum(pu[:, 0] * e_pos, dim=-1, keepdim=True)       # [B, 1]
    # e_neg on the left: its gradient comes out contiguous, [B, n_neg, d]
    ln = torch.bmm(e_neg, pu.transpose(1, 2))[..., 0]            # [B, n_neg]
    logits = torch.cat([lp, ln], dim=-1)
    return torch.mean(torch.logsumexp(logits, dim=-1) - logits[:, 0])


def loss_and_grads(params: dict, batch: dict, cfg: MINDConfig,
                   mesh=None) -> tuple[torch.Tensor, dict]:
    """(loss, gradient of every leaf) of :func:`train_loss` over the whole
    batch. With a mesh of ``d`` data rows, each rank holds an equal share
    of the users: its loss counts 1/d, and the loss and every gradient are
    summed over its data column (a table shard's over the rows that used
    its ids). ``b_init``'s gradient is 0."""
    d = 1 if mesh is None else mesh.d
    loss = train_loss(params, batch, cfg, mesh)
    if d > 1:
        loss = loss / d
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
    loss = loss.detach()
    if d > 1:
        loss = mesh.all_reduce_src(loss)
        grads = {k: mesh.all_reduce_src(g) for k, g in grads.items()}
    return loss, grads


def retrieval_scores(params, interests: torch.Tensor, cand_ids: torch.Tensor,
                     cfg: MINDConfig, mesh=None) -> torch.Tensor:
    """Score the candidates against one user's interests, max over
    capsules. interests: f[K, d]; cand_ids: i64[n_cand] → f[n_cand]."""
    e = sharded_lookup(params["item_emb"], cand_ids, mesh)       # [n, d]
    return torch.amax(e @ interests.T, dim=-1)
