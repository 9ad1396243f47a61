"""Decoder-only transformer family (TinyLlama / Yi / Nemotron / Mixtral).

A port of the JAX package's ``models/transformer/model.py``: the same
parameter tree (layers stacked on a leading axis, ``w[d_in, d_out]``), the
same blocks, casts and MoE dispatch, as plain functions of ``(params,
tokens, cfg, mesh=None)``. ``mesh=None`` runs on one device. With a
:class:`~repro_torch.launch.mesh.Mesh` every rank holds its shards of the
JAX package's layout (:func:`param_specs`, :func:`shard_params`): TP over
the model group on heads, ``d_ff`` and vocabulary, FSDP over the src group
(``pod`` × ``data``, the JAX ``dp_axes``) on a weight's other matrix
dimension when ``cfg.fsdp``; its batch rows are the rank's share of a batch
split over the src group (the whole batch on every rank where it does not
split, as the JAX cells replicate it); the collectives are those of
:mod:`.parallel`. Where a config has fewer KV heads than model ranks
(every full config against TP 16), a KV head's projection columns lie on
the ``mo / n_kv_heads`` model ranks whose query heads use it (the JAX
layout's column split); those ranks gather them (:func:`~.parallel.
span_gather`) and their gradients are summed over exactly those ranks. The
KV cache (:func:`cache_specs`) holds its batch over the src group and every
KV head on every model rank, as the JAX package holds it. The MoE FFN
dispatches each rank's tokens locally (capacity from the local token
count, as JAX's ``shard_map`` computes it), splits each expert's ``d_ff``
over the model group and sums the output over it once.

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
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...launch.mesh import DP, TP, SrcSum, shard_shape, split
from ...train.optim import ShardLayout, tree_leaves, tree_map
from .attention import attention
from .parallel import (from_tp, fsdp_gather, span_gather, to_tp,
                       vocab_embed, vocab_xent)

__all__ = ["MoECfg", "LMConfig", "init_params", "forward", "loss_fn",
           "make_train_step", "make_prefill", "make_decode_step",
           "init_cache", "count_params", "active_params", "param_specs",
           "cache_specs", "shard_params", "shard_batch", "local_batch",
           "param_layout", "shard_numel", "loss_and_grads"]

# the logits' (and so the loss's) dtype: float32, as the JAX package casts
# them
LOGITS_DTYPE = torch.float32


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
    fsdp: bool = True                    # shard weights over the batch axes

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def _serves_hybrid(fn):
    """``fn``; for a hybrid decoder's config (:class:`.hybrid.HybridConfig`)
    :mod:`.hybrid`'s function of the same name, given the same arguments
    but ``mesh`` (a hybrid decoder runs on one device). The one place where
    the family's entry points fork."""
    import inspect
    sig = inspect.signature(fn)
    at = list(sig.parameters).index("cfg")

    @functools.wraps(fn)
    def call(*args, **kwargs):
        from . import hybrid
        cfg = args[at] if len(args) > at else kwargs["cfg"]
        if not isinstance(cfg, hybrid.HybridConfig):
            return fn(*args, **kwargs)
        bound = sig.bind(*args, **kwargs).arguments
        if bound.pop("mesh", None) is not None:
            raise NotImplementedError(f"{cfg.name}: a hybrid decoder runs "
                                      "on one device (no mesh)")
        return getattr(hybrid, fn.__name__)(**bound)

    return call


@_serves_hybrid
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
# Params and their layout over a mesh
# --------------------------------------------------------------------- #
def _param_shapes(cfg: LMConfig) -> dict:
    """Every leaf's (shape, init scale; None for ones)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers

    def dense(*shape, scale=None):
        return (shape, scale or 1.0 / math.sqrt(shape[-2]))

    layer = dict(
        wq=dense(L, d, cfg.q_dim),
        wk=dense(L, d, cfg.kv_dim),
        wv=dense(L, d, cfg.kv_dim),
        wo=dense(L, cfg.q_dim, d),
        norm1=((L, d), None),
        norm2=((L, d), None),
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
    return dict(embed=dense(v, d, scale=1.0), lm_head=dense(d, v),
                final_norm=((d,), None), layers=layer)


@functools.lru_cache(maxsize=None)
def param_specs(cfg: LMConfig) -> dict:
    """The JAX package's ``param_specs``: each leaf's axis per dimension
    (``None``, :data:`TP` or :data:`DP`). TP on heads / d_ff / vocab; FSDP
    (the other matrix dim) on the src group, or nowhere when ``cfg.fsdp`` is
    off (weights replicated over the data ranks, e.g. TinyLlama)."""
    dp = DP if cfg.fsdp else None
    layer = dict(wq=(None, dp, TP), wk=(None, dp, TP), wv=(None, dp, TP),
                 wo=(None, TP, dp), norm1=(None, None), norm2=(None, None))
    if cfg.moe:
        layer["router"] = (None, None, None)
        layer["w1"] = (None, None, dp, TP)
        layer["w2"] = (None, None, TP, dp)
        if cfg.act == "swiglu":
            layer["w3"] = (None, None, dp, TP)
    else:
        layer["w1"] = (None, dp, TP)
        layer["w2"] = (None, TP, dp)
        if cfg.act == "swiglu":
            layer["w3"] = (None, dp, TP)
    return dict(embed=(TP, dp), lm_head=(dp, TP), final_norm=(None,),
                layers=layer)


def cache_specs(cfg: LMConfig) -> dict:
    """The JAX package's ``cache_specs``: the batch over the src group,
    every KV head on every model rank."""
    kv = (None, DP, None, None, None)
    return dict(k=kv, v=kv, pos=(DP, None), t=())


def _shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    shard_shape(x.shape, spec, mesh)
    for dim, axis in enumerate(spec):
        k, i = split(mesh, axis)
        if k > 1:
            x = x.chunk(k, dim)[i]
    return x


def shard_params(params: dict, cfg: LMConfig, mesh) -> dict:
    """This rank's shard of every leaf (:func:`param_specs`), each a new
    leaf tensor that requires grad."""
    return tree_map(lambda x, spec: _shard(x, spec, mesh).detach().clone()
                    .requires_grad_(), params, param_specs(cfg))


@_serves_hybrid
def init_params(cfg: LMConfig, seed: int = 0, *,
                device: str | torch.device = "cuda", mesh=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX package's tree, shapes and scales, not its numbers: carry those
    over with :func:`repro_torch.convert.lm_params_from_numpy`). Every leaf
    is a tensor that requires grad. With a mesh each leaf is drawn at this
    rank's shard shape (the same scales; not the numbers of a slice of the
    one-device draw: use :func:`shard_params` for those). A hybrid
    decoder's config draws :func:`.hybrid.init_params`' tree (one device,
    no mesh)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pd = cfg.param_dtype

    def draw(entry, spec):
        shape, scale = entry
        shape = shard_shape(shape, spec, mesh)
        if scale is None:
            return torch.ones(shape, dtype=pd, device=dev)
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(scale).to(pd)

    shapes, specs = _param_shapes(cfg), param_specs(cfg)
    # the one-device draw order: the layer leaves, then embed and lm_head
    layers = tree_map(draw, shapes["layers"], specs["layers"])
    params = {k: draw(shapes[k], specs[k])
              for k in ("embed", "lm_head", "final_norm")}
    params["layers"] = layers
    return tree_map(lambda t: t.requires_grad_(), params)


def local_batch(batch: int, mesh) -> int:
    """A rank's rows of a global batch: ``batch / d`` where it splits over
    the src group, else all of it (replicated, as the JAX cells' batch
    spec falls back to)."""
    if mesh is None or batch % mesh.d:
        return batch
    return batch // mesh.d


def shard_batch(x: torch.Tensor, mesh, accum: int = 1) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (leading axis) as the JAX
    program holds them: split into ``accum`` microbatches, each split over
    the src group; the rank's pieces in microbatch order (the whole batch
    where it does not split)."""
    if mesh is None or x.shape[0] % (accum * mesh.d):
        return x
    parts = x.reshape(accum, mesh.d, x.shape[0] // (accum * mesh.d),
                      *x.shape[1:])
    return parts[:, mesh.row].reshape(-1, *x.shape[1:])


def shard_numel(cfg: LMConfig, mesh) -> int:
    """Elements of one rank's shards of every parameter."""
    specs = tree_leaves(param_specs(cfg))
    return sum(math.prod(shard_shape(shape, spec, mesh)) for (shape, _), spec
               in zip(tree_leaves(_param_shapes(cfg)), specs))


def param_layout(cfg: LMConfig, mesh) -> ShardLayout:
    """The optimizer's ``layout=`` for parameters sharded by
    :func:`param_specs` (``init`` and ``apply`` take it)."""
    return ShardLayout(mesh, param_specs(cfg))


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


def _w(lp: dict, name: str, cfg: LMConfig, mesh):
    """Layer weight ``name`` with its FSDP dimension gathered."""
    w = lp[name]
    for dim, axis in enumerate(param_specs(cfg)["layers"][name][1:]):
        if axis == DP:
            w = fsdp_gather(w, mesh, dim)
    return w


def _kv_span(cfg: LMConfig, mesh) -> int:
    """Model ranks that share one KV head (1: each holds whole heads)."""
    mo = 1 if mesh is None else mesh.mo
    if cfg.n_kv_heads % mo == 0:
        return 1
    if mo % cfg.n_kv_heads:
        raise ValueError(f"{cfg.n_kv_heads} KV heads do not split over "
                         f"{mo} model ranks")
    return mo // cfg.n_kv_heads


def _moe_ffn(x, lp, cfg: LMConfig, drops: list | None = None, mesh=None):
    """Top-k MoE with capacity: the JAX package's dispatch of this rank's
    tokens. Appends each expert's count of dropped assignments to ``drops``
    (i64[E]) when it is a list."""
    moe = cfg.moe
    E, K = moe.n_experts, moe.top_k
    b, s, d = x.shape
    tl = b * s
    xf = x.reshape(tl, d)
    logits = xf.float() @ lp["router"].float()
    gates, eidx = torch.topk(torch.softmax(logits, -1), K)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(8, int(K * tl / E * moe.capacity_factor))

    def experts(h):
        w1 = _w(lp, "w1", cfg, mesh)
        if cfg.act == "swiglu":
            hh = F.silu(torch.bmm(h, w1)) * torch.bmm(h, _w(lp, "w3", cfg,
                                                            mesh))
        else:
            hh = torch.square(F.relu(torch.bmm(h, w1)))
        return torch.bmm(hh, _w(lp, "w2", cfg, mesh))

    out, counts = sorted_dispatch(xf, eidx, gates, E, cap, experts, mesh)
    if drops is not None:
        drops.append(torch.clamp(counts - cap, min=0))
    return out.reshape(b, s, d)


def sorted_dispatch(xf, eidx, gates, n_experts: int, cap: int, experts,
                    mesh=None):
    """Each (token, k) route of ``eidx`` i64[T, K] through its expert, the
    routes sorted by expert id (stable): an expert's first ``cap`` routes
    fill its buffer rows in token order, ``experts(h [E, cap, d]) → [E,
    cap, d]`` runs every buffer, and each token's K rows, weighted by their
    ``gates``, are summed in k order (no atomics). A route past its
    expert's capacity, or to the id ``n_experts`` (an expert held
    elsewhere), reads a zero row. → (out [T, d], routes an expert
    i64[n_experts])."""
    E = n_experts
    tl, K = eidx.shape
    d = xf.shape[1]
    flat_e = eidx.reshape(-1)                             # [K·T]
    order = torch.argsort(flat_e, stable=True)
    tok = order // K
    sorted_e = flat_e[order]
    counts = torch.zeros(E + 1, dtype=flat_e.dtype,
                         device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(K * tl, device=xf.device) - starts[sorted_e]
    keep = (pos < cap) & (sorted_e < E)
    slot = torch.where(keep, sorted_e * cap + pos, E * cap)

    buf = xf.new_zeros(E * cap + 1, d).index_put((slot,),
                                                 to_tp(xf, mesh)[tok])
    y = experts(buf[:E * cap].reshape(E, cap, d)).reshape(E * cap, d)
    y = torch.cat([y, y.new_zeros(1, d)], 0)
    # the gates enter the TP region at the wider of their float32 and the
    # activations' dtype: each rank's share of their cotangent is summed
    # there before it is rounded to float32 once, as on one device
    w = gates.reshape(-1)[order][:, None]
    w = to_tp(w.to(torch.promote_types(w.dtype, y.dtype)), mesh)
    gath = y[slot] * w.to(y.dtype)
    # each token's K rows back in (token, k) order, summed over k in order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(K * tl, device=xf.device)
    out = gath[inv].reshape(tl, K, d).sum(1)
    return from_tp(out, mesh), counts[:E]


def _dense_ffn(x, lp, cfg: LMConfig, mesh=None):
    x = to_tp(x, mesh)
    if cfg.act == "swiglu":
        h = F.silu(x @ _w(lp, "w1", cfg, mesh)) * (x @ _w(lp, "w3", cfg,
                                                         mesh))
    else:
        h = torch.square(F.relu(x @ _w(lp, "w1", cfg, mesh)))
    return from_tp(h @ _w(lp, "w2", cfg, mesh), mesh)


def _ffn(x, lp, cfg: LMConfig, drops: list | None = None, mesh=None):
    return (_moe_ffn(x, lp, cfg, drops, mesh) if cfg.moe
            else _dense_ffn(x, lp, cfg, mesh))


def _embed(params, tokens, cfg: LMConfig, mesh=None):
    table = params["embed"]
    if mesh is not None and cfg.fsdp:
        table = fsdp_gather(table, mesh, 1)
    return vocab_embed(table, tokens, mesh).to(cfg.dtype)


def _head(x, params, cfg: LMConfig, mesh=None):
    """Logits ``[..., V]`` (with a mesh this rank's ``V / mo`` columns)."""
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["lm_head"]
    if mesh is not None and cfg.fsdp:
        w = fsdp_gather(w, mesh, 0)
    return (to_tp(x, mesh) @ w.to(cfg.dtype)).to(LOGITS_DTYPE)


def _qkv(h, lp, positions, cfg: LMConfig, mesh=None):
    """This rank's query heads and the KV heads they read."""
    b, s, _ = h.shape
    h = to_tp(h, mesh)
    span = _kv_span(cfg, mesh)
    q = (h @ _w(lp, "wq", cfg, mesh)).reshape(b, s, -1, cfg.head_dim)
    k = (h @ span_gather(_w(lp, "wk", cfg, mesh), mesh, span, -1)).reshape(
        b, s, -1, cfg.head_dim)
    v = (h @ span_gather(_w(lp, "wv", cfg, mesh), mesh, span, -1)).reshape(
        b, s, -1, cfg.head_dim)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _all_kv_heads(k, cfg: LMConfig, mesh):
    """Every KV head ``[B, S, n_kv, Dh]`` from each model rank's (the cache
    layout): a model-group all-gather, one copy of a head a span."""
    if mesh is None or mesh.mo == 1:
        return k
    b, s, h, dh = k.shape
    g = mesh.all_gather_model(k).reshape(mesh.mo, b, s, h, dh)
    g = g.permute(1, 2, 0, 3, 4).reshape(b, s, mesh.mo * h, dh)
    return g[:, :, ::_kv_span(cfg, mesh)]


def _local_kv_heads(kc, cfg: LMConfig, mesh):
    """The KV heads of a whole-head cache ``[B, C, n_kv, Dh]`` that this
    rank's query heads read."""
    if mesh is None or mesh.mo == 1:
        return kc
    span = _kv_span(cfg, mesh)
    per = cfg.n_kv_heads * span // mesh.mo
    lo = mesh.col // span * per
    return kc[:, :, lo:lo + per]


def _layer(x, lp, positions, cfg: LMConfig, drops: list | None = None,
           mesh=None):
    """One block over a whole sequence: → (x, k, v), k and v the KV heads
    this rank's query heads read."""
    h = _rms_norm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, positions, cfg, mesh)
    attn = attention(q, k, v, positions, positions,
                     window=cfg.sliding_window,
                     q_block=cfg.q_block, k_block=cfg.k_block)
    x = x + from_tp(attn @ _w(lp, "wo", cfg, mesh), mesh)
    x = x + _ffn(_rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg, drops,
                 mesh)
    return x, k, v


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


# --------------------------------------------------------------------- #
# Forward (train / prefill)
# --------------------------------------------------------------------- #
@_serves_hybrid
def forward(params, tokens, cfg: LMConfig, mesh=None, *, positions=None,
            moe_drops: list | None = None):
    """tokens: i64[B, S] → logits [B, S, V] in ``LOGITS_DTYPE`` (with a
    mesh: this rank's rows and its ``V / mo`` vocabulary columns).
    ``moe_drops``: a list that each MoE layer appends its dropped
    assignments per expert to (a rematerialised layer appends again when
    the backward recomputes it). A hybrid decoder's config runs
    :func:`.hybrid.forward` (no mesh, no autograd)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, mesh)
    if positions is None:
        positions = _positions(b, s, tokens.device)
    for lp in _unstack(params["layers"]):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, lp, positions, cfg, moe_drops, mesh,
                           use_reentrant=False, preserve_rng_state=False)[0]
        else:
            x = _layer(x, lp, positions, cfg, moe_drops, mesh)[0]
    return _head(x, params, cfg, mesh)


def loss_fn(params, batch, cfg: LMConfig, mesh=None):
    """Mean next-token cross-entropy over the labels ≥ 0. With a mesh
    ``batch`` is this rank's share of a batch split over the src group: the
    sum over the rank's tokens is divided by the global count of labels and
    summed over the src group (the backward leaves each rank its own
    share's gradient)."""
    logits = forward(params, batch["tokens"], cfg, mesh)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    count = mask.sum()
    if mesh is not None and mesh.d > 1:
        count = mesh.all_reduce_src(count)
    loss = torch.sum(vocab_xent(logits, labels, mesh) * mask) / torch.clamp(
        count, min=1.0)
    if mesh is not None and mesh.d > 1:
        loss = SrcSum.apply(loss, mesh)
    return loss


def _value_and_grad(params, batch, cfg: LMConfig, mesh=None):
    """(loss, gradient tree) of :func:`loss_fn`; a leaf the loss does not
    reach gets zeros, as under ``jax.value_and_grad``."""
    leaves = tree_leaves(params)
    loss = loss_fn(params, batch, cfg, mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(p): (torch.zeros_like(p) if g is None else g)
             for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_id[id(p)], params)


def _sum_replicated(grads, cfg: LMConfig, mesh):
    """Sum over the src group the gradient of every leaf that is whole on
    each data rank (an FSDP leaf's came back summed from its gather), at
    float32 or wider."""
    if mesh is None or mesh.d == 1:
        return grads

    def total(g, spec):
        if DP in spec:
            return g
        return mesh.all_reduce_src(g.to(torch.promote_types(g.dtype,
                                                            torch.float32)))

    return tree_map(total, grads, param_specs(cfg))


def loss_and_grads(params, batch, cfg: LMConfig, mesh=None):
    """(loss, gradient tree) of :func:`loss_fn`, the gradients as the
    optimizer takes them: with a mesh each rank's shards, every one summed
    over the data ranks."""
    loss, grads = _value_and_grad(params, batch, cfg, mesh)
    return loss, _sum_replicated(grads, cfg, mesh)


def make_train_step(cfg: LMConfig, optimizer, mesh=None):
    """train_step(params, opt_state, batch) → (params, opt_state, loss).

    ``cfg.accum_steps`` microbatches split on the batch axis (with a mesh,
    the rank's rows hold its share of each microbatch in turn:
    :func:`shard_batch`); gradients are accumulated in float32 and, with the
    loss, divided by their count. With a mesh the replicated leaves'
    gradients are summed over the src group a microbatch (before the
    float32 accumulation, as an FSDP leaf's reduce-scatter sums it) and the
    optimizer takes :func:`param_layout` (its state made with it too). The
    optimizer writes the new values into ``params`` in place."""
    opt_kw = {} if mesh is None else dict(layout=param_layout(cfg, mesh))

    def train_step(params, opt_state, batch):
        a = cfg.accum_steps
        if a > 1:
            micro = [{k: x.reshape(a, x.shape[0] // a, *x.shape[1:])[i]
                      for k, x in batch.items()} for i in range(a)]
            loss = None
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in micro:
                mb_loss, mb_grads = loss_and_grads(params, mb, cfg, mesh)
                tree_map(lambda ga, g: ga.add_(g.float()), grads, mb_grads)
                loss = mb_loss if loss is None else loss + mb_loss
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)
        else:
            loss, grads = loss_and_grads(params, batch, cfg, mesh)
        params, opt_state = optimizer.apply(grads, opt_state, params,
                                            **opt_kw)
        return params, opt_state, loss

    return train_step


# --------------------------------------------------------------------- #
# Serving: prefill + decode with (rolling) KV cache
# --------------------------------------------------------------------- #
@_serves_hybrid
def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda", mesh=None):
    """Cache length = sliding window when set (rolling buffer), else
    max_len. With a mesh, this rank's shard (:func:`cache_specs`) of the
    cache of a global ``batch``. A hybrid decoder's config gets a cache a
    kind (:func:`.hybrid.init_cache`)."""
    dev = resolve_device(device)
    batch = local_batch(batch, mesh)
    c = min(max_len, cfg.sliding_window or max_len)
    shape = (cfg.n_layers, batch, c, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                pos=torch.full((batch, c), -1, dtype=torch.long, device=dev),
                t=0)


@_serves_hybrid
def make_prefill(cfg: LMConfig, mesh=None, *, max_len: int | None = None,
                 moe_drops: list | None = None):
    """prefill(params, tokens[B, S]) → (cache, logits[B, V] of last token).

    Fills the KV cache for subsequent decoding. Only the last position's
    logits are computed (never the [B, S, V] tensor). Sliding-window configs
    keep the last W positions (rolling buffer layout, slot = pos mod W).
    ``max_len`` sizes the cache for subsequent decoding (defaults to the
    prompt length — the pure-prefill benchmark shape). ``moe_drops`` as in
    :func:`forward`. With a mesh, ``tokens`` are this rank's rows, the cache
    its shard and the logits its vocabulary columns. A hybrid decoder's
    config gets :func:`.hybrid.make_prefill`'s, which also writes sessions
    into given rows of a cache.
    """

    @torch.no_grad()
    def prefill(params, tokens):
        b, s = tokens.shape
        cache = init_cache(cfg, b, max_len or s, device=tokens.device)
        c = cache["pos"].shape[1]
        positions = _positions(b, s, tokens.device)
        x = _embed(params, tokens, cfg, mesh)
        for i, lp in enumerate(_unstack(params["layers"])):
            x, k, v = _layer(x, lp, positions, cfg, moe_drops, mesh)
            for name, kv in (("k", k), ("v", v)):
                kv = _all_kv_heads(kv, cfg, mesh)
                # rolling cache: last min(s, c) positions at slot = pos mod c
                if c <= s:
                    cache[name][i] = torch.roll(kv[:, -c:], s % c, 1)
                else:                  # headroom for subsequent decode
                    cache[name][i, :, :s] = kv
            del k, v, kv               # free before the next layer runs
        logits = _head(x[:, -1:], params, cfg, mesh)[:, 0]
        ar = torch.arange(s, device=tokens.device)
        if c <= s:
            cache["pos"][:] = torch.roll(ar[s - c:], s % c)
        else:
            cache["pos"][:, :s] = ar
        cache["t"] = s
        return cache, logits

    return prefill


@_serves_hybrid
def make_decode_step(cfg: LMConfig, mesh=None):
    """decode(params, cache, token[B]) → (cache, logits[B, V]).

    One new token against a cache of ``c`` slots; sliding-window configs use
    a rolling buffer (slot = t mod W): cost O(W) regardless of absolute
    position. The step consumes its cache: the new token's keys, values and
    position are written into ``cache`` in place, and ``cache`` itself is
    returned with ``t`` advanced (the JAX step is functional). To continue
    one cache two ways, decode the second way from a copy of its tensors.
    With a mesh, as :func:`make_prefill`. A hybrid decoder's config gets
    :func:`.hybrid.make_decode_step`'s (a position a row).
    """

    @torch.no_grad()
    def decode(params, cache, token):
        b = token.shape[0]
        t = cache["t"]
        pos = torch.full((b, 1), t, dtype=torch.long, device=token.device)
        x = _embed(params, token, cfg, mesh)[:, None]
        c = cache["k"].shape[2]
        slot = t % c
        pos_cache = cache["pos"]
        pos_cache[:, slot] = t
        for i, lp in enumerate(_unstack(params["layers"])):
            h = _rms_norm(x, lp["norm1"], cfg.norm_eps)
            q, k, v = _qkv(h, lp, pos, cfg, mesh)
            kc, vc = cache["k"][i], cache["v"][i]
            kc[:, slot] = _all_kv_heads(k, cfg, mesh)[:, 0]
            vc[:, slot] = _all_kv_heads(v, cfg, mesh)[:, 0]
            attn = attention(q, _local_kv_heads(kc, cfg, mesh),
                             _local_kv_heads(vc, cfg, mesh), pos, pos_cache,
                             window=cfg.sliding_window,
                             k_valid=pos_cache >= 0)
            x = x + from_tp(attn @ _w(lp, "wo", cfg, mesh), mesh)
            x = x + _ffn(_rms_norm(x, lp["norm2"], cfg.norm_eps), lp, cfg,
                         mesh=mesh)
        logits = _head(x, params, cfg, mesh)[:, 0]
        cache["t"] = t + 1
        return cache, logits

    return decode
