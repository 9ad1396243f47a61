"""Hybrid decoders (MiMo-V2-Flash): attention layers of several kinds side
by side, leading dense layers, sigmoid-routed experts of which a device
holds a share, and a cache for each attention kind.

A :class:`HybridConfig` names each layer's attention kind. A kind
(:class:`AttnKind`) has its own KV heads, window, RoPE θ and, optionally, a
sink: one learnable logit a query head in the softmax's denominator, with
no value. Queries and keys are ``qk_head_dim`` wide, values ``v_head_dim``;
RoPE turns the first ``rotary_dim`` dims of each; ``value_scale``
multiplies the attention's probabilities. The first ``n_dense_layers``
layers have a dense SwiGLU FFN (``d_ff``), the others a routed one
(:class:`RoutedMoE`): σ = sigmoid(h W_r) over every expert, the top k of
σ + b (b the selection bias), weights σ_T / Σ_T σ, no capacity and no
dropped route. The layer is told which experts it holds and computes their
part of the result; what the other experts add is the part of the devices
that hold them (expert parallelism, whose exchange is not here).

Parameters are one stack a kind: ``attn[kind]`` (``wq``, ``wk``, ``wv``,
``wo``, ``norm``, and ``sink`` f32[n, H] where the kind has one) and
``ffn["dense"]`` / ``ffn["moe"]`` (``router``, the selection ``bias``
f32[n, E], ``w1``, ``w3``, ``w2`` over the held experts, ``norm``), each
matrix ``w[d_in, d_out]`` as in the rest of the family.
:func:`from_published` takes the published ``[d_out, d_in]`` tensors as
transposed views, with no copy.

The cache (:func:`init_cache`) has an entry a kind: ``k`` / ``v``
``[n, B, n_kv, C, D]`` (head-major, so a decode step reads each head's
slots in one run) and ``pos`` (the position a slot holds, −1 for none). A
kind without a window keeps every position (C = ``max_len``, slot =
position, ``pos`` i64[1, C]); a windowed kind keeps a ring of ``window``
slots (slot = position mod window, ``pos`` i64[B, window]). ``t`` i64[B]
is each row's next position: a row is a session with a history of its own
length. A prefill writes its sessions into the rows it is given;
:func:`snapshot` and :func:`rewind` bring a cache back to an earlier
state: ``t``, and the ring slots written since (a full kind's later slots
are past ``t`` and unread).

Serving runs without autograd on one device (no mesh). Spans:
``lm.prefill``, which always waits for its logits and puts its seconds in
the histogram ``lm_prefill_seconds`` (a process's set-up runs with no
tracer live); ``lm.decode_step``, and in it ``lm.attn.<kind>`` (a layer's
attention sub-layer) and ``lm.moe`` (a routed FFN), each waiting for its
output while a tracer is live (``Span.sync``). Counters, read only then (the
read waits for the device): ``lm_moe_routes_held`` (routes that land on a
held expert) and ``lm_moe_experts_idle`` (held experts a routed layer's
step sends no token); gauge ``lm_decode_attn_least_bytes`` (the least bytes
of one full layer's decode attention, :func:`~repro_torch.kernels.
decode_attn.least_bytes`). Gauge ``lm_kv_cache_bytes{kind}``, set when a
cache is built.

A full kind's decode attention on a bf16 cache on a card is the kernel
:func:`~repro_torch.kernels.decode_attn.decode_attention` (each row's
slots up to its own position); a windowed kind, another dtype or a CPU
tensor takes :func:`~.attention.cached_attention`.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...kernels import decode_attn
from ...obs import metrics as obs_metrics
from ...obs import trace as obs_trace
from .attention import attention, cached_attention
from .model import _embed, _head, _rms_norm, _rope, sorted_dispatch

__all__ = ["AttnKind", "RoutedMoE", "HybridConfig", "param_shapes",
           "init_params", "count_params", "from_published", "to_published",
           "forward", "init_cache", "make_prefill", "make_decode_step",
           "snapshot", "rewind", "cache_bytes"]

#: the float32 widened keys of one chunk of decode rows (bytes): where a
#: decode step takes :func:`cached_attention`, it goes through the rows in
#: chunks of this size, so its temporaries do not scale with the batch
DECODE_CHUNK_BYTES = 1 << 31

#: init scales of the two float32 vectors (the other leaves: 1/√d_in)
SINK_SCALE = 1.0
BIAS_SCALE = 0.05


@dataclasses.dataclass(frozen=True)
class AttnKind:
    n_kv_heads: int
    window: int | None = None        # None: causal over the whole context
    rope_theta: float = 1e4
    sink: bool = False


@dataclasses.dataclass(frozen=True)
class RoutedMoE:
    n_experts: int                   # the router's outputs
    top_k: int
    d_ff: int                        # an expert's width
    first_held: int = 0              # the held experts: a contiguous share
    n_held: int | None = None        # None: every expert

    @property
    def held(self) -> int:
        return self.n_experts if self.n_held is None else self.n_held


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    d_model: int
    n_heads: int
    qk_head_dim: int
    v_head_dim: int
    rotary_dim: int
    vocab: int
    layers: tuple[str, ...]          # each layer's attention kind
    kinds: tuple[tuple[str, AttnKind], ...]
    n_dense_layers: int
    d_ff: int                        # the dense FFN's width
    moe: RoutedMoE
    value_scale: float = 1.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.bfloat16
    q_block: int = 512
    k_block: int = 1024

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def kind(self, name: str) -> AttnKind:
        return dict(self.kinds)[name]

    def count(self, name: str) -> int:
        return self.layers.count(name)

    def plan(self) -> list[tuple[str, int, str, int]]:
        """Each layer's (attention kind, index in its stack, FFN kind,
        index in its stack)."""
        seen: dict[str, int] = {}
        out = []
        for i, name in enumerate(self.layers):
            a = seen.get(name, 0)
            seen[name] = a + 1
            dense = i < self.n_dense_layers
            out.append((name, a, "dense" if dense else "moe",
                        i if dense else i - self.n_dense_layers))
        return out


# --------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------- #
def param_shapes(cfg: HybridConfig) -> dict:
    """Every leaf's (shape, init scale; None for ones)."""
    d, h, v = cfg.d_model, cfg.n_heads, cfg.vocab
    dk, dv = cfg.qk_head_dim, cfg.v_head_dim
    tree = dict(embed=((v, d), 1.0), lm_head=((d, v), 1 / math.sqrt(d)),
                final_norm=((d,), None), attn={}, ffn={})
    for name, kind in cfg.kinds:
        n, kv = cfg.count(name), kind.n_kv_heads
        if not n:
            continue
        a = dict(wq=((n, d, h * dk), 1 / math.sqrt(d)),
                 wk=((n, d, kv * dk), 1 / math.sqrt(d)),
                 wv=((n, d, kv * dv), 1 / math.sqrt(d)),
                 wo=((n, h * dv, d), 1 / math.sqrt(h * dv)),
                 norm=((n, d), None))
        if kind.sink:
            a["sink"] = ((n, h), SINK_SCALE)
        tree["attn"][name] = a
    n, f = cfg.n_dense_layers, cfg.d_ff
    if n:
        tree["ffn"]["dense"] = dict(
            w1=((n, d, f), 1 / math.sqrt(d)), w3=((n, d, f), 1 / math.sqrt(d)),
            w2=((n, f, d), 1 / math.sqrt(f)), norm=((n, d), None))
    n, moe = cfg.n_layers - cfg.n_dense_layers, cfg.moe
    if n:
        e, fe = moe.held, moe.d_ff
        tree["ffn"]["moe"] = dict(
            router=((n, d, moe.n_experts), 1 / math.sqrt(d)),
            bias=((n, moe.n_experts), BIAS_SCALE),
            w1=((n, e, d, fe), 1 / math.sqrt(d)),
            w3=((n, e, d, fe), 1 / math.sqrt(d)),
            w2=((n, e, fe, d), 1 / math.sqrt(fe)), norm=((n, d), None))
    return tree


#: leaves kept in float32 whatever ``param_dtype`` is
_F32 = ("sink", "bias")


def _walk(tree: dict, path=()):
    """(path, leaf) of a nested dict, keys in sorted order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        else:
            yield path + (key,), val


def _put(tree: dict, path: tuple, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def init_params(cfg: HybridConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    leaves in sorted order (serving only: no leaf requires grad)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict = {}
    for path, (shape, scale) in _walk(param_shapes(cfg)):
        dtype = torch.float32 if path[-1] in _F32 else cfg.param_dtype
        if scale is None:
            leaf = torch.ones(shape, dtype=dtype, device=dev)
        else:
            leaf = torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=dev).mul_(scale).to(dtype)
        _put(params, path, leaf)
    return params


def count_params(cfg: HybridConfig) -> int:
    """Parameters this device holds (the held experts only)."""
    return sum(math.prod(shape) for _, (shape, _) in
               _walk(param_shapes(cfg)))


#: the published name of each leaf, by its group: a group's tensors are
#: the per-layer tensors of its layers stacked on a leading axis, each
#: matrix ``[d_out, d_in]``
PUBLISHED_NAMES = {
    "attn": dict(wq="q_proj", wk="k_proj", wv="v_proj", wo="o_proj",
                 norm="input_layernorm", sink="attention_sink_bias"),
    "dense": dict(w1="gate_proj", w3="up_proj", w2="down_proj",
                  norm="post_attention_layernorm"),
    "moe": dict(router="gate", bias="e_score_correction_bias",
                w1="gate_proj", w3="up_proj", w2="down_proj",
                norm="post_attention_layernorm"),
}
_VECTORS = ("norm", "sink", "bias")


def _group(path: tuple) -> tuple[str, dict]:
    """(published group, its leaf table) of a stacked leaf's path."""
    if path[0] == "attn":
        return f"attn.{path[1]}", PUBLISHED_NAMES["attn"]
    return f"mlp.{path[1]}", PUBLISHED_NAMES[path[1]]


def from_published(weights: dict, cfg: HybridConfig) -> dict:
    """The port's tree over published tensors: ``embed_tokens`` [V, d],
    ``lm_head`` [V, d], ``norm`` [d], and a dict a group (``attn.<kind>``,
    ``mlp.dense``, ``mlp.moe``) of stacked published tensors. Matrices are
    transposed views (no copy)."""
    params: dict = dict(embed=weights["embed_tokens"],
                        lm_head=weights["lm_head"].t(),
                        final_norm=weights["norm"])
    for path, _ in _walk(param_shapes(cfg)):
        if len(path) == 1:
            continue
        group, names = _group(path)
        w = weights[group][names[path[-1]]]
        _put(params, path, w if path[-1] in _VECTORS else w.transpose(-1, -2))
    return params


def to_published(params: dict, cfg: HybridConfig) -> dict:
    """:func:`from_published`'s inverse, as views."""
    out: dict = dict(embed_tokens=params["embed"],
                     lm_head=params["lm_head"].t(),
                     norm=params["final_norm"])
    for path, _ in _walk(param_shapes(cfg)):
        if len(path) == 1:
            continue
        group, names = _group(path)
        w = params[path[0]][path[1]][path[2]]
        out.setdefault(group, {})[names[path[-1]]] = (
            w if path[-1] in _VECTORS else w.transpose(-1, -2))
    return out


# --------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------- #
def _qkv(h, ap, a: int, kind: AttnKind, positions, cfg: HybridConfig):
    """Queries, keys and values of stack entry ``a``, RoPE on the first
    ``rotary_dim`` dims of q and k."""
    b, s, _ = h.shape
    q = (h @ ap["wq"][a]).reshape(b, s, cfg.n_heads, cfg.qk_head_dim)
    k = (h @ ap["wk"][a]).reshape(b, s, kind.n_kv_heads, cfg.qk_head_dim)
    v = (h @ ap["wv"][a]).reshape(b, s, kind.n_kv_heads, cfg.v_head_dim)
    r = cfg.rotary_dim

    def rope(x):
        turned = _rope(x[..., :r], positions, kind.rope_theta)
        return turned if r == x.shape[-1] else torch.cat([turned, x[..., r:]],
                                                         -1)

    return rope(q), rope(k), v


def _attn_extra(ap, a: int, kind: AttnKind, cfg: HybridConfig) -> dict:
    return dict(sink=ap["sink"][a] if kind.sink else None,
                v_scale=None if cfg.value_scale == 1.0 else cfg.value_scale)


def _dense_ffn(h, fp, j: int):
    return (F.silu(h @ fp["w1"][j]) * (h @ fp["w3"][j])) @ fp["w2"][j]


def _routed_ffn(h, mp, j: int, cfg: HybridConfig, *, sync_free: bool):
    """The held experts' part of the routed FFN of stack entry ``j``: →
    (y [B, S, d], routes a held expert i64[held], the picked experts
    i64[B·S, top_k] of every token). ``sync_free``: each
    expert's buffer has a row for every token (a token picks an expert
    once), so the call issues without a read from the device (decode);
    otherwise the buffers are sized to the busiest held expert, one read
    (prefill)."""
    moe = cfg.moe
    b, s, d = h.shape
    xf = h.reshape(b * s, d)
    scores = torch.sigmoid(xf.float() @ mp["router"][j].float())
    _, eidx = torch.topk(scores + mp["bias"][j].float(), moe.top_k)
    gates = scores.gather(1, eidx)
    gates = gates / gates.sum(-1, keepdim=True)
    local = eidx - moe.first_held
    local = torch.where((local >= 0) & (local < moe.held), local, moe.held)
    if sync_free:
        cap = b * s
    else:
        cap = max(1, int(torch.bincount(local.reshape(-1),
                                        minlength=moe.held + 1)[:moe.held]
                         .max()))

    def experts(x):
        hh = F.silu(torch.bmm(x, mp["w1"][j])) * torch.bmm(x, mp["w3"][j])
        return torch.bmm(hh, mp["w2"][j])

    y, counts = sorted_dispatch(xf, local, gates, moe.held, cap, experts)
    return y.reshape(b, s, d), counts, eidx


def _count_routes(counts) -> None:
    c = counts.tolist()
    obs_metrics.counter("lm_moe_routes_held",
                        "routes that land on an expert held here").inc(sum(c))
    obs_metrics.counter("lm_moe_experts_idle",
                        "held experts a routed layer's decode step sends no "
                        "token").inc(sum(1 for n in c if n == 0))


def _gauge_least_bytes(q, kc, vc, q_pos) -> None:
    obs_metrics.gauge("lm_decode_attn_least_bytes",
                      "least bytes of one decode-attention launch: each "
                      "row's live keys and values, the queries and the "
                      "output").set(decode_attn.least_bytes(q, kc, vc, q_pos))


def _sequence(params, tokens, cfg: HybridConfig, on_kv=None):
    """The layers over whole sequences: → x [B, S, d]. Past ``q_block``
    tokens the sequence is padded on the right to a multiple of it (token
    0), so the attention schedules get whole blocks; a real token never
    reads a padded one (causal), and the routed FFN has no capacity for
    them to take. ``on_kv(kind, a, k, v)`` sees each layer's keys and
    values of the real tokens."""
    b, s = tokens.shape
    pad = (-s) % cfg.q_block if s > cfg.q_block else 0
    if pad:
        tokens = F.pad(tokens, (0, pad))
    sp = s + pad
    positions = torch.arange(sp, device=tokens.device).expand(b, sp)
    x = _embed(params, tokens, cfg)
    for name, a, f, j in cfg.plan():
        kind, ap = cfg.kind(name), params["attn"][name]
        h = _rms_norm(x, ap["norm"][a], cfg.norm_eps)
        q, k, v = _qkv(h, ap, a, kind, positions, cfg)
        o = attention(q, k, v, positions, positions, window=kind.window,
                      q_block=cfg.q_block, k_block=cfg.k_block, prefix=True,
                      **_attn_extra(ap, a, kind, cfg))
        x = x + o @ ap["wo"][a]
        if on_kv is not None:
            on_kv(name, a, k[:, :s], v[:, :s])
        del q, k, v, o
        fp = params["ffn"][f]
        h = _rms_norm(x, fp["norm"][j], cfg.norm_eps)
        x = x + (_dense_ffn(h, fp, j) if f == "dense" else
                 _routed_ffn(h, fp, j, cfg, sync_free=False)[0])
    return x[:, :s]


@torch.no_grad()
def forward(params, tokens, cfg: HybridConfig):
    """tokens: i64[B, S] → logits [B, S, V] (float32)."""
    return _head(_sequence(params, tokens, cfg), params, cfg)


# --------------------------------------------------------------------- #
# Serving: a cache a kind, rows of their own lengths
# --------------------------------------------------------------------- #
def cache_bytes(entry: dict) -> int:
    return sum(x.numel() * x.element_size() for x in entry.values())


def init_cache(cfg: HybridConfig, batch: int, max_len: int, *,
               device: str | torch.device = "cuda") -> dict:
    """An empty cache of ``batch`` rows (sessions) for positions below
    ``max_len`` (module docstring); sets ``lm_kv_cache_bytes{kind}``."""
    dev = resolve_device(device)
    cache: dict = dict(t=torch.zeros(batch, dtype=torch.long, device=dev))
    gauge = obs_metrics.gauge("lm_kv_cache_bytes",
                              "bytes of a kind's cache (keys, values, "
                              "positions)", ("kind",))
    for name, kind in cfg.kinds:
        n = cfg.count(name)
        if not n:
            continue
        c = max_len if kind.window is None else min(kind.window, max_len)
        shape = (n, batch, kind.n_kv_heads, c)
        entry = dict(
            k=torch.zeros(*shape, cfg.qk_head_dim, dtype=cfg.dtype,
                          device=dev),
            v=torch.zeros(*shape, cfg.v_head_dim, dtype=cfg.dtype,
                          device=dev),
            pos=(torch.arange(c, device=dev)[None] if kind.window is None
                 else torch.full((batch, c), -1, dtype=torch.long,
                                 device=dev)))
        cache[name] = entry
        gauge.labels(kind=name).set(cache_bytes(entry))
    return cache


def make_prefill(cfg: HybridConfig, *, max_len: int | None = None):
    """prefill(params, tokens[B, S], cache=None, rows=None) → (cache,
    logits[B, V] of each row's last token). Writes the B sessions' keys and
    values into rows ``rows`` (i64[B]; 0..B−1 by default) of ``cache``
    (a new one of B rows for ``max_len`` positions, S by default, when
    None) and sets their ``t`` to S; a ring keeps a session's last
    ``window`` positions."""

    @torch.no_grad()
    def prefill(params, tokens, cache=None, rows=None):
        b, s = tokens.shape
        dev = tokens.device
        with obs_trace.span("lm.prefill") as sp:
            if cache is None:
                cache = init_cache(cfg, b, max_len or s, device=dev)
            rows = (torch.arange(b, device=dev) if rows is None
                    else torch.as_tensor(rows, device=dev))
            for name, kind in cfg.kinds:
                if kind.window is not None and name in cache:
                    lo = max(0, s - kind.window)
                    slots = torch.arange(lo, s, device=dev) % kind.window
                    ring = cache[name]["pos"]
                    ring[rows] = -1
                    ring[rows[:, None], slots[None]] = torch.arange(
                        lo, s, device=dev)

            def write(name, a, k, v):
                kind, c = cfg.kind(name), cache[name]
                if kind.window is None:
                    c["k"][a][rows, :, :s] = k.transpose(1, 2)
                    c["v"][a][rows, :, :s] = v.transpose(1, 2)
                else:
                    lo = max(0, s - kind.window)
                    slots = torch.arange(lo, s, device=dev) % kind.window
                    c["k"][a][rows[:, None], :, slots[None]] = k[:, lo:]
                    c["v"][a][rows[:, None], :, slots[None]] = v[:, lo:]

            x = _sequence(params, tokens, cfg, on_kv=write)
            logits = _head(x[:, -1:], params, cfg)[:, 0]
            cache["t"][rows] = s
            sp.sync(logits)
        obs_metrics.histogram(
            "lm_prefill_seconds", "seconds a prefill took, to its logits"
        ).observe(sp.duration_s)
        return cache, logits

    return prefill


def make_decode_step(cfg: HybridConfig):
    """decode(params, cache, token[B], routes=None) → (cache, logits[B,
    V]): one token a row, row r at position ``t[r]``. Consumes its cache:
    the token's keys, values and positions are written in place and ``t``
    advances (clone the cache's tensors, or :func:`snapshot` it, to
    continue it two ways). ``routes``: a list that gets each routed
    layer's picked experts i64[B, top_k], in layer order (no copy, no
    read from the device)."""
    plan = cfg.plan()

    @torch.no_grad()
    def decode(params, cache, token, routes=None):
        live = obs_trace.get_tracer().enabled
        with obs_trace.hot_span("lm.decode_step") as sp:
            t = cache["t"]
            b = token.shape[0]
            rows = torch.arange(b, device=token.device)
            qp = t[:, None]
            for name, kind in cfg.kinds:
                if kind.window is not None and name in cache:
                    cache[name]["pos"][rows, t % kind.window] = t
            x = _embed(params, token, cfg)[:, None]
            for name, a, f, j in plan:
                kind, ap, c = cfg.kind(name), params["attn"][name], \
                    cache[name]
                with obs_trace.hot_span(f"lm.attn.{name}") as sa:
                    h = _rms_norm(x, ap["norm"][a], cfg.norm_eps)
                    q, k, v = _qkv(h, ap, a, kind, qp, cfg)
                    slot = t if kind.window is None else t % kind.window
                    kc, vc = c["k"][a], c["v"][a]
                    kc[rows, :, slot] = k[:, 0]
                    vc[rows, :, slot] = v[:, 0]
                    if kind.window is None and kc.is_cuda and \
                            kc.dtype == torch.bfloat16:
                        o = decode_attn.decode_attention(
                            q, kc, vc, qp, **_attn_extra(ap, a, kind, cfg))
                    else:
                        per_row = kind.n_kv_heads * kc.shape[2] * \
                            cfg.qk_head_dim * 4
                        o = cached_attention(
                            q, kc, vc, qp, c["pos"], window=kind.window,
                            rows=max(1, DECODE_CHUNK_BYTES // per_row),
                            **_attn_extra(ap, a, kind, cfg))
                    x = x + o @ ap["wo"][a]
                    if sa is not None and live:
                        sa.sync(x)
                if kind.window is None and live:     # its read waits:
                    # kept out of the span that full_attn_ms reads
                    _gauge_least_bytes(q, kc, vc, qp)
                fp = params["ffn"][f]
                h = _rms_norm(x, fp["norm"][j], cfg.norm_eps)
                if f == "dense":
                    x = x + _dense_ffn(h, fp, j)
                    continue
                with obs_trace.hot_span("lm.moe") as sm:
                    y, counts, picked = _routed_ffn(h, fp, j, cfg,
                                                    sync_free=True)
                    x = x + y
                    if routes is not None:
                        routes.append(picked)
                    if sm is not None and live:
                        sm.sync(x)
                        _count_routes(counts)
            logits = _head(x, params, cfg)[:, 0]
            t.add_(1)
            if sp is not None and live:
                sp.sync(logits)
        return cache, logits

    return decode


def snapshot(cache: dict, cfg: HybridConfig) -> dict:
    """What :func:`rewind` restores: ``t`` and every ring (windowed kinds'
    keys, values and positions), copied."""
    return dict(t=cache["t"].clone(),
                rings={name: {key: x.clone() for key, x in
                              cache[name].items()}
                       for name, kind in cfg.kinds
                       if kind.window is not None and name in cache})


def rewind(cache: dict, snap: dict, steps: int) -> dict:
    """Back to ``snap`` after ``steps`` decode steps: ``t`` restored, and
    in each ring the slots those steps wrote (positions t₀ … t₀+steps−1
    of each row) copied back from the snapshot."""
    t0 = snap["t"]
    if steps:
        for name, ring in snap["rings"].items():
            w = ring["pos"].shape[1]
            rows = torch.arange(t0.shape[0], device=t0.device)[:, None]
            slots = (t0[:, None] + torch.arange(min(steps, w),
                                                device=t0.device)) % w
            entry = cache[name]
            entry["pos"][rows, slots] = ring["pos"][rows, slots]
            for key in ("k", "v"):
                entry[key][:, rows, :, slots] = ring[key][:, rows, :, slots]
    cache["t"].copy_(t0)
    return cache
