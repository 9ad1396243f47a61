"""Decoder-only transformer family (TinyLlama / Yi / Nemotron / Mixtral).

A port of the JAX package's ``models/transformer/model.py`` on one device:
the same parameter tree (layers stacked on a leading axis, ``w[d_in,
d_out]``), the same blocks, casts and MoE dispatch, as plain functions of
``(params, tokens, cfg)``. The JAX ``mesh`` argument and its sharding
(``param_specs``, ``cache_specs``, the ``shard_map`` of the MoE FFN) have no
counterpart here: one card, no tensor parallelism.

  * GQA attention (n_kv_heads < n_heads) with RoPE, through the three
    schedules of ``attention.py`` (banded O(S·W) for sliding-window configs),
  * SwiGLU or squared-ReLU (Nemotron) FFN,
  * top-k MoE (Mixtral) with capacity, a stable sort of the expert ids (the
    same tokens are dropped as in the JAX package) and a combine that sums
    each token's k contributions in a fixed order (no atomics),
  * gradient accumulation and per-layer rematerialisation
    (``torch.utils.checkpoint``, non-reentrant, where the JAX package has
    ``jax.checkpoint``).

Each call unbinds the stacked ``[L, …]`` leaves once (``torch.unbind``,
whose backward is one stack), so a layer's backward does not write a
full-size zero gradient. Serving (``make_prefill``, ``make_decode_step``)
runs without autograd; decode consumes its cache, writing the new token's
keys, values and position into it in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...train.optim import tree_leaves, tree_map
from .attention import attention

__all__ = ["MoECfg", "LMConfig", "init_params", "forward", "loss_fn",
           "make_train_step", "make_prefill", "make_decode_step",
           "init_cache", "count_params", "active_params"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    act: str = "swiglu"                  # "swiglu" | "sq_relu"
    moe: MoECfg | None = None
    sliding_window: int | None = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    accum_steps: int = 1
    optimizer: str = "adamw"             # "adafactor" for the ≥100B cells
    q_block: int = 512                   # flash attention block sizes
    k_block: int = 1024

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def count_params(cfg: LMConfig) -> int:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.moe:
        ffn = cfg.moe.n_experts * (3 if cfg.act == "swiglu" else 2) * d * f \
            + d * cfg.moe.n_experts
    else:
        ffn = (3 if cfg.act == "swiglu" else 2) * d * f
    return cfg.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d


def active_params(cfg: LMConfig) -> int:
    """Params touched per token (MoE: top-k experts) — for MODEL_FLOPS 6ND."""
    d, f = cfg.d_model, cfg.d_ff
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    n_ff = (3 if cfg.act == "swiglu" else 2) * d * f
    ffn = (cfg.moe.top_k * n_ff + d * cfg.moe.n_experts) if cfg.moe else n_ff
    return cfg.n_layers * (attn + ffn + 2 * d) + 2 * cfg.vocab * d + d


# --------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------- #
def init_params(cfg: LMConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's tree, shapes and scales, not its numbers: carry those
    over with :func:`repro_torch.convert.lm_params_from_numpy`). Every leaf
    is a tensor that requires grad."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype

    def dense(*shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[-2])
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(scale).to(pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    layer = dict(
        wq=dense(L, d, cfg.q_dim),
        wk=dense(L, d, cfg.kv_dim),
        wv=dense(L, d, cfg.kv_dim),
        wo=dense(L, cfg.q_dim, d),
        norm1=ones(L, d),
        norm2=ones(L, d),
    )
    if cfg.moe:
        E = cfg.moe.n_experts
        layer["router"] = dense(L, d, E)
        layer["w1"] = dense(L, E, d, f)
        layer["w2"] = dense(L, E, f, d, scale=1 / math.sqrt(f))
        if cfg.act == "swiglu":
            layer["w3"] = dense(L, E, d, f)
    else:
        layer["w1"] = dense(L, d, f)
        layer["w2"] = dense(L, f, d, scale=1 / math.sqrt(f))
        if cfg.act == "swiglu":
            layer["w3"] = dense(L, d, f)
    params = dict(embed=dense(v, d, scale=1.0), lm_head=dense(d, v),
                  final_norm=ones(d), layers=layer)
    return tree_map(lambda t: t.requires_grad_(), params)


def _unstack(layers: dict) -> list[dict]:
    """The stacked ``[L, …]`` leaves as L per-layer dicts."""
    keys = sorted(layers)
    return [dict(zip(keys, vals))
            for vals in zip(*(layers[k].unbind(0) for k in keys))]


# --------------------------------------------------------------------- #
# Building blocks
# --------------------------------------------------------------------- #
def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions, theta):
    """x: [B, S, H, Dh]; positions: [B, S] absolute token positions."""
    half = x.shape[-1] // 2
    freqs = (1.0 / theta) ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _moe_ffn(x, lp, cfg: LMConfig, drops: list | None = None):
    """Top-k MoE with capacity: the JAX package's dispatch at world size 1.
    Appends each expert's count of dropped assignments to ``drops`` (i64[E])
    when it is a list."""
    moe = cfg.moe
    E, K = moe.n_experts, moe.top_k
    b, s, d = x.shape
    tl = b * s
    xf = x.reshape(tl, d)
    logits = xf.float() @ lp["router"].float()
    gates, eidx = torch.topk(torch.softmax(logits, -1), K)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(8, int(K * tl / E * moe.capacity_factor))

    flat_e = eidx.reshape(-1)                             # [K·T]
    order = torch.argsort(flat_e, stable=True)
    tok = order // K
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(K * tl, device=x.device) - starts[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, E * cap)
    if drops is not None:
        drops.append(torch.clamp(counts - cap, min=0))

    buf = x.new_zeros(E * cap + 1, d).index_put((slot,), xf[tok])
    h = buf[:E * cap].reshape(E, cap, d)
    if cfg.act == "swiglu":
        hh = F.silu(torch.bmm(h, lp["w1"])) * torch.bmm(h, lp["w3"])
    else:
        hh = torch.square(F.relu(torch.bmm(h, lp["w1"])))
    y = torch.bmm(hh, lp["w2"]).reshape(E * cap, d)
    y = torch.cat([y, y.new_zeros(1, d)], 0)
    gath = y[slot] * gates.reshape(-1)[order][:, None].to(y.dtype)
    # each token's K rows back in (token, k) order, summed over k in order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(K * tl, device=x.device)
    out = gath[inv].reshape(tl, K, d).sum(1)
    return out.reshape(b, s, d)


def _dense_ffn(x, lp, cfg: LMConfig):
    if cfg.act == "swiglu":
        h = F.silu(x @ lp["w1"]) * (x @ lp["w3"])
    else:
        h = torch.square(F.relu(x @ lp["w1"]))
    return h @ lp["w2"]


def _ffn(x, lp, cfg: LMConfig, drops: list | None = None):
    return _moe_ffn(x, lp, cfg, drops) if cfg.moe else _dense_ffn(x, lp, cfg)


def _embed(params, tokens, cfg: LMConfig):
    return params["embed"][tokens].to(cfg.dtype)


def _head(x, params, cfg: LMConfig):
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(cfg.dtype)).float()


def _qkv(h, lp, positions, cfg: LMConfig):
    b, s, _ = h.shape
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _layer(x, lp, positions, cfg: LMConfig, drops: list | None = None):
    """One block over a whole sequence: → (x, k, v)."""
    h = _rms_norm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, positions, cfg)
    attn = attention(q, k, v, positions, positions,
                     window=cfg.sliding_window,
                     q_block=cfg.q_block, k_block=cfg.k_block)
    x = x + attn @ lp["wo"]
    x = x + _ffn(_rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg, drops)
    return x, k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


# --------------------------------------------------------------------- #
# Forward (train / prefill)
# --------------------------------------------------------------------- #
def forward(params, tokens, cfg: LMConfig, *, positions=None,
            moe_drops: list | None = None):
    """tokens: i64[B, S] → logits f32[B, S, V]. ``moe_drops``: a list that
    each MoE layer appends its dropped assignments per expert to (a
    rematerialised layer appends again when the backward recomputes it)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = _positions(b, s, tokens.device)
    for lp in _unstack(params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, lp, positions, cfg, moe_drops,
                           use_reentrant=False, preserve_rng_state=False)[0]
        else:
            x = _layer(x, lp, positions, cfg, moe_drops)[0]
    return _head(x, params, cfg)


def loss_fn(params, batch, cfg: LMConfig):
    logits = forward(params, batch["tokens"], cfg)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    # labels < 0 are masked out; any class stands in for them in the gather
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def _value_and_grad(params, batch, cfg: LMConfig):
    """(loss, gradient tree) of :func:`loss_fn`; a leaf the loss does not
    reach gets zeros, as under ``jax.value_and_grad``."""
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def make_train_step(cfg: LMConfig, optimizer):
    """train_step(params, opt_state, batch) → (params, opt_state, loss).

    ``cfg.accum_steps`` microbatches split on the batch axis; gradients are
    accumulated in float32 and, with the loss, divided by their count. The
    optimizer writes the new values into ``params`` in place."""

    def train_step(params, opt_state, batch):
        a = cfg.accum_steps
        if a > 1:
            micro = [{k: x.reshape(a, x.shape[0] // a, *x.shape[1:])[i]
                      for k, x in batch.items()} for i in range(a)]
            loss = None
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in micro:
                mb_loss, mb_grads = _value_and_grad(params, mb, cfg)
                tree_map(lambda ga, g: ga.add_(g.float()), grads, mb_grads)
                loss = mb_loss if loss is None else loss + mb_loss
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)
        else:
            loss, grads = _value_and_grad(params, batch, cfg)
        params, opt_state = optimizer.apply(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


# --------------------------------------------------------------------- #
# Serving: prefill + decode with (rolling) KV cache
# --------------------------------------------------------------------- #
def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda"):
    """Cache length = sliding window when set (rolling buffer), else
    max_len."""
    dev = resolve_device(device)
    c = min(max_len, cfg.sliding_window or max_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                pos=torch.full((batch, c), -1, dtype=torch.long, device=dev),
                t=0)


def make_prefill(cfg: LMConfig, *, max_len: int | None = None,
                 moe_drops: list | None = None):
    """prefill(params, tokens[B, S]) → (cache, logits[B, V] of last token).

    Fills the KV cache for subsequent decoding. Only the last position's
    logits are computed (never the [B, S, V] tensor). Sliding-window configs
    keep the last W positions (rolling buffer layout, slot = pos mod W).
    ``max_len`` sizes the cache for subsequent decoding (defaults to the
    prompt length — the pure-prefill benchmark shape). ``moe_drops`` as in
    :func:`forward`.
    """

    @torch.no_grad()
    def prefill(params, tokens):
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len or s, device=tokens.device)
        c = cache["pos"].shape[1]
        positions = _positions(b, s, tokens.device)
        x = _embed(params, tokens, cfg)
        for i, lp in enumerate(_unstack(params["layers"])):
            x, k, v = _layer(x, lp, positions, cfg, moe_drops)
            # rolling cache: last min(s, c) positions at slot = pos mod c
            if c <= s:
                cache["k"][i] = torch.roll(k[:, -c:], s % c, 1)
                cache["v"][i] = torch.roll(v[:, -c:], s % c, 1)
            else:                      # headroom for subsequent decode
                cache["k"][i, :, :s] = k
                cache["v"][i, :, :s] = v
        logits = _head(x[:, -1:], params, cfg)[:, 0]
        ar = torch.arange(s, device=tokens.device)
        if c <= s:
            cache["pos"][:] = torch.roll(ar[s - c:], s % c)
        else:
            cache["pos"][:, :s] = ar
        cache["t"] = s
        return cache, logits

    return prefill


def make_decode_step(cfg: LMConfig):
    """decode(params, cache, token[B]) → (cache, logits[B, V]).

    One new token against a cache of ``c`` slots; sliding-window configs use
    a rolling buffer (slot = t mod W): cost O(W) regardless of absolute
    position. The step consumes its cache: the new token's keys, values and
    position are written into ``cache`` in place, and ``cache`` itself is
    returned with ``t`` advanced (the JAX step is functional). To continue
    one cache two ways, decode the second way from a copy of its tensors.
    """

    @torch.no_grad()
    def decode(params, cache, token):
        b = token.shape[0]
        t = cache["t"]
        pos = torch.full((b, 1), t, dtype=torch.long, device=token.device)
        x = _embed(params, token, cfg)[:, None]
        c = cache["k"].shape[2]
        slot = t % c
        pos_cache = cache["pos"]
        pos_cache[:, slot] = t
        for i, lp in enumerate(_unstack(params["layers"])):
            h = _rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, pos, cfg)
            kc, vc = cache["k"][i], cache["v"][i]
            kc[:, slot] = k[:, 0]
            vc[:, slot] = v[:, 0]
            attn = attention(q, kc, vc, pos, pos_cache,
                             window=cfg.sliding_window,
                             k_valid=pos_cache >= 0)
            x = x + attn @ lp["wo"]
            x = x + _ffn(_rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg)
        logits = _head(x, params, cfg)[:, 0]
        cache["t"] = t + 1
        return cache, logits

    return decode
