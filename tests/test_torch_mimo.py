"""The hybrid decoder (MiMo-V2-Flash) against its plain reference, and the
LM code it shares with the other configs.

The reference (``models/transformer/mimo_reference.py``, plain torch, no
cache) runs at float64 on the published tensors; the program at float32 on
the reduced config. Tolerances: logits rel L2 ≤ 1e-5 a row (float32
rounding through seven layers and the head: ~7e-7 observed); attention
schedules within 2e-6 of the dense one (the same float32 arithmetic in
another order); the expert shares' sum within 1e-12 of the program's whole
layer at float64 (each token's contributions summed in another order), and
that within 1e-6 of the reference's (the program's router scores are
float32); rewinds, tracing and the shared MoE and attention code bit for
bit.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs as tobs
from repro_torch.configs import ARCHS, get_arch, mimo_v2_flash
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import hybrid, model
from repro_torch.models.transformer import mimo_reference as ref

attn = importlib.import_module("repro_torch.models.transformer.attention")
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SPEC = dict(mimo_v2_flash.REDUCED, layers=list(range(7)))


def _rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


@pytest.fixture(scope="module")
def reduced():
    cfg = mimo_v2_flash.config(reduced=True)
    params = tf.init_params(cfg, 3, device="cpu")
    return cfg, params, hybrid.to_published(params, cfg)


@pytest.fixture
def sinks():
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracer=tobs.trace.NULL_TRACER)
    yield
    tobs.restore(prev)


def _reference(pub, tokens, **kw):
    return ref.forward(pub, tokens, SPEC, (0, 16), dtype=torch.float64, **kw)


def test_config_has_the_published_widths_and_counts():
    cfg = get_arch("mimo-v2-flash").config()
    assert (cfg.d_model, cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim,
            cfg.rotary_dim, cfg.vocab, cfg.d_ff) == (4096, 64, 192, 128, 64,
                                                     152576, 16384)
    assert cfg.kind("full") == tf.AttnKind(4, None, 5e6, False)
    assert cfg.kind("window") == tf.AttnKind(8, 128, 1e4, True)
    assert (cfg.layers.count("window"), cfg.layers.count("full")) == (39, 9)
    assert cfg.n_dense_layers == 1 and cfg.value_scale == 0.707
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff,
            cfg.moe.held) == (256, 8, 2048, 256)
    assert tf.count_params(cfg) == 308_778_780_864
    cut = mimo_v2_flash.config(layers=(0, 6, 7, 8, 9, 10, 11), n_held=16)
    assert cut.layers == ("full",) + ("window",) * 5 + ("full",)
    assert tf.count_params(cut) == 4_523_620_160
    with pytest.raises(ValueError):
        mimo_v2_flash.config(layers=(6, 0))
    # the port's own arch: not one of the JAX package's
    assert "mimo-v2-flash" not in ARCHS
    assert get_arch("mimo-v2-flash").family == "lm"


@pytest.mark.parametrize("window", [None, 20, 4])
@pytest.mark.parametrize("with_sink", [False, True])
def test_attention_schedules_agree_with_a_sink_and_narrow_values(window,
                                                                 with_sink):
    g = torch.Generator().manual_seed(5)
    b, s, h, kv, dk, dv = 2, 64, 8, 2, 24, 16
    q, k = torch.randn(b, s, h, dk, generator=g), torch.randn(
        b, s, kv, dk, generator=g)
    v = torch.randn(b, s, kv, dv, generator=g)
    pos = torch.arange(s).expand(b, s)
    sink = torch.randn(h, generator=g) if with_sink else None
    kw = dict(window=window, sink=sink, v_scale=0.7)
    dense = attn.attention(q, k, v, pos, pos, **kw)
    small = dict(q_block=16, k_block=16, dense_threshold=8)
    split = attn.attention(q, k, v, pos, pos, **small, **kw)
    assert split.shape == (b, s, h * dv)
    assert (split - dense).abs().max() <= 2e-6
    assert torch.equal(split, attn.attention(q, k, v, pos, pos, prefix=True,
                                             **small, **kw))
    # the decode schedule over a head-major cache, in chunks of rows
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    qp = torch.tensor([[40], [63]])
    rows = [attn.cached_attention(q[[0, 1], qp[:, 0]][:, None], kc, vc, qp,
                                  pos[:1], rows=n, **kw) for n in (None, 1)]
    assert torch.equal(rows[0], rows[1])
    want = dense[[0, 1], qp[:, 0]][:, None]
    assert (rows[0] - want).abs().max() <= 2e-6


def test_forward_matches_the_plain_reference(reduced):
    cfg, params, pub = reduced
    g = torch.Generator().manual_seed(11)
    for n in (40, 600):                       # 600 pads to whole blocks
        tokens = torch.randint(0, cfg.vocab, (n,), generator=g)
        got = tf.forward(params, tokens[None], cfg)[0]
        assert got.shape == (n, cfg.vocab)
        assert _rel(got, _reference(pub, tokens)) <= 1e-5


def _sessions(cfg, lengths, turn, seed=13):
    g = torch.Generator().manual_seed(seed)
    hist = [torch.randint(0, cfg.vocab, (n,), generator=g) for n in lengths]
    forced = torch.randint(0, cfg.vocab, (len(lengths), turn), generator=g)
    return hist, forced


def _prefilled(cfg, params, hist, turn):
    cache = tf.init_cache(cfg, len(hist), max(map(len, hist)) + turn,
                          device="cpu")
    prefill = tf.make_prefill(cfg)
    for r, h in enumerate(hist):
        prefill(params, h[None], cache, [r])
    return cache


def _turn(cfg, params, cache, forced):
    decode = tf.make_decode_step(cfg)
    return torch.stack([decode(params, cache, forced[:, j])[1]
                        for j in range(forced.shape[1])], 1)


def test_ragged_prefill_then_decode_matches_the_reference(reduced):
    cfg, params, pub = reduced
    lengths, turn = [5, 23, 41], 6              # the window is 8
    hist, forced = _sessions(cfg, lengths, turn)
    cache = _prefilled(cfg, params, hist, turn)
    assert cache["t"].tolist() == lengths
    assert cache["full"]["k"].shape == (2, 3, 2, 47, 24)
    assert cache["window"]["v"].shape == (5, 3, 4, 8, 16)
    got = _turn(cfg, params, cache, forced)
    assert cache["t"].tolist() == [n + turn for n in lengths]
    for r, h in enumerate(hist):
        want = _reference(pub, torch.cat([h, forced[r]]), last=turn)
        assert _rel(got[r], want) <= 1e-5, r


def test_a_rewound_cache_replays_a_turn_bit_for_bit(reduced):
    cfg, params, _ = reduced
    lengths, turn = [5, 23, 41], 6
    hist, forced = _sessions(cfg, lengths, turn)
    cache = _prefilled(cfg, params, hist, 3 * turn)
    before = {name: {k: x.clone() for k, x in e.items()}
              for name, e in cache.items() if name != "t"}
    snap = hybrid.snapshot(cache, cfg)
    first = _turn(cfg, params, cache, forced)
    hybrid.rewind(cache, snap, turn)
    assert cache["t"].tolist() == lengths
    for key in ("k", "v", "pos"):               # every ring slot is back
        assert torch.equal(cache["window"][key], before["window"][key])
    assert torch.equal(_turn(cfg, params, cache, forced), first)
    # a turn longer than the window overwrites whole rings
    longer = torch.cat([forced, forced, forced], 1)
    hybrid.rewind(cache, snap, turn)
    a = _turn(cfg, params, cache, longer)
    hybrid.rewind(cache, snap, 3 * turn)
    assert torch.equal(cache["window"]["k"], before["window"]["k"])
    assert torch.equal(_turn(cfg, params, cache, longer), a)


def test_expert_shares_add_up_to_the_whole_layer(reduced):
    cfg, params, pub = reduced
    cfg = dataclasses.replace(cfg, dtype=torch.float64,
                              param_dtype=torch.float64)
    moe = {k: v.double() for k, v in params["ffn"]["moe"].items()}
    h = torch.randn(2, 30, cfg.d_model, generator=torch.Generator()
                    .manual_seed(17), dtype=torch.float64)
    m = {k: v.double() for k, v in pub["mlp.moe"].items()}
    routes = []
    whole = ref.routed_ffn(
        h.reshape(-1, cfg.d_model), m["gate"][1], m["e_score_correction_bias"]
        [1], cfg.moe.top_k, 0, [(m["gate_proj"][1, e], m["up_proj"][1, e],
                                 m["down_proj"][1, e]) for e in range(16)],
        routes)
    parts, counts = [], 0
    for first in (0, 4, 8, 12):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_held=first, n_held=4))
        held = {k: (v[:, first:first + 4] if k in ("w1", "w2", "w3") else v)
                for k, v in moe.items()}
        y, c, _ = hybrid._routed_ffn(h, held, 1, share,
                                     sync_free=first % 8 == 0)
        parts.append(y)
        counts += int(c.sum())
    assert counts == h.shape[0] * h.shape[1] * cfg.moe.top_k
    y, _, picked = hybrid._routed_ffn(h, moe, 1, cfg, sync_free=True)
    y = y.reshape(-1, cfg.d_model)
    # the picks the layer hands back are the reference's top-8, as sets
    pick, select = routes[0]
    assert torch.equal(picked.sort(-1).values, pick.sort(-1).values)
    assert (ref.route_gap(select, picked) <= 0).all()
    assert (ref.route_gap(select, pick) <= 0).all()
    assert (sum(parts).reshape(-1, cfg.d_model) - y).abs().max() <= 1e-12
    # the program's router scores are float32 (as every LM's of the port)
    assert (y - whole).abs().max() <= 1e-6


def test_tracing_leaves_the_logits_bitwise_and_names_the_spans(reduced,
                                                               sinks):
    cfg, params, _ = reduced
    lengths, turn = [9, 30], 3
    hist, forced = _sessions(cfg, lengths, turn, seed=19)
    off = _turn(cfg, params, _prefilled(cfg, params, hist, turn), forced)
    tracer = tobs.Tracer()
    prev = tobs.trace.set_tracer(tracer)
    try:
        on = _turn(cfg, params, _prefilled(cfg, params, hist, turn), forced)
    finally:
        tobs.trace.set_tracer(prev)
    assert torch.equal(on, off)
    names = [s["name"] for s in tracer.spans]
    assert names.count("lm.decode_step") == turn
    assert names.count("lm.attn.full") == 2 * turn
    assert names.count("lm.attn.window") == 5 * turn
    assert names.count("lm.moe") == 6 * turn
    assert names.count("lm.prefill") == len(lengths)
    # every prefill puts its seconds in the histogram, traced or not
    prefills = tobs.metrics.get_registry().get("lm_prefill_seconds").merged()
    assert prefills.count == 2 * len(lengths) and prefills.sum > 0
    steps = {s["id"] for s in tracer.spans if s["name"] == "lm.decode_step"}
    assert all(s["parent"] in steps for s in tracer.spans
               if s["name"].startswith("lm.attn") or s["name"] == "lm.moe")
    reg = tobs.metrics.get_registry()
    assert reg.value("lm_moe_routes_held") == \
        turn * 6 * len(lengths) * cfg.moe.top_k     # every expert held
    assert reg.value("lm_moe_experts_idle") >= 0
    full = reg.value("lm_kv_cache_bytes", kind="full")
    slots = max(lengths) + turn                 # 2 layers, 2 KV heads, f32
    assert full == 2 * len(lengths) * 2 * slots * (24 + 16) * 4 + 8 * slots


def _parent_moe_ffn(x, lp, cfg):
    """The MoE FFN as it was before its dispatch became
    ``model.sorted_dispatch`` (one device)."""
    moe = cfg.moe
    E, K = moe.n_experts, moe.top_k
    b, s, d = x.shape
    tl = b * s
    xf = x.reshape(tl, d)
    logits = xf.float() @ lp["router"].float()
    gates, eidx = torch.topk(torch.softmax(logits, -1), K)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(8, int(K * tl / E * moe.capacity_factor))
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = order // K
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=flat_e.dtype).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(K * tl) - starts[sorted_e]
    slot = torch.where(pos < cap, sorted_e * cap + pos, E * cap)
    buf = x.new_zeros(E * cap + 1, d).index_put((slot,), xf[tok])
    h = buf[:E * cap].reshape(E, cap, d)
    hh = F.silu(torch.bmm(h, lp["w1"])) * torch.bmm(h, lp["w3"])
    y = torch.bmm(hh, lp["w2"]).reshape(E * cap, d)
    y = torch.cat([y, y.new_zeros(1, d)], 0)
    w = gates.reshape(-1)[order][:, None]
    gath = y[slot] * w.to(torch.promote_types(w.dtype, y.dtype)).to(y.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(K * tl)
    return gath[inv].reshape(tl, K, d).sum(1).reshape(b, s, d), \
        torch.clamp(counts - cap, min=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_mixtral_moe_and_attention_keep_their_bits(dtype):
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").config(reduced=True),
                              dtype=dtype, param_dtype=dtype)
    lp = model._unstack(tf.init_params(cfg, 0, device="cpu")["layers"])[0]
    lp = {k: v.detach() for k, v in lp.items()}
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(23)).to(dtype)
    drops = []
    want, want_drops = _parent_moe_ffn(x, lp, cfg)
    assert torch.equal(model._moe_ffn(x, lp, cfg, drops), want)
    assert torch.equal(drops[0], want_drops)
    # with no sink and no value scale, the schedules are those of before
    g = torch.Generator().manual_seed(29)
    q = torch.randn(1, 64, 1, 4, 8, generator=g).to(dtype)
    k, v = (torch.randn(1, 64, 1, 8, generator=g).to(dtype) for _ in "kv")
    pos = torch.arange(64)[None]
    m0 = q.new_full((1, 1, 4, 16), -1e30, dtype=torch.float32)
    carry = (m0, torch.zeros_like(m0), torch.zeros(1, 1, 4, 16, 8))
    for j in range(0, 64, 16):
        carry = attn._online_block(carry, k[:, j:j + 16], v[:, j:j + 16],
                                   q[:, 16:32], pos[:, 16:32],
                                   pos[:, j:j + 16], 24, 8 ** -0.5)
    old = (carry[2] / torch.clamp(carry[1], min=1e-30)[..., None]).to(dtype)
    new = attn._blocked(q, k, v, pos, pos, 24, 16, 16)[:, 16:32]
    assert torch.equal(new, old.permute(0, 3, 1, 2, 4))


def test_the_familys_entry_points_serve_a_hybrid_config_on_one_device(
        reduced):
    cfg, params, _ = reduced
    assert tf.count_params(cfg) == hybrid.count_params(cfg)
    again = tf.init_params(cfg, seed=3, device="cpu")
    for (path, a), (_, b) in zip(hybrid._walk(params),
                                 hybrid._walk(hybrid.init_params(
                                     cfg, 3, device="cpu"))):
        assert torch.equal(a, b), path
    tokens = torch.arange(12)[None] % cfg.vocab
    assert torch.equal(tf.forward(again, tokens, cfg),
                       hybrid.forward(params, tokens, cfg))
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    assert set(cache) == {"t", "full", "window"}
    mesh = object()
    for call in (lambda: tf.init_params(cfg, 3, device="cpu", mesh=mesh),
                 lambda: tf.forward(params, tokens, cfg, mesh),
                 lambda: tf.init_cache(cfg, 2, 16, device="cpu", mesh=mesh),
                 lambda: tf.make_prefill(cfg, mesh),
                 lambda: tf.make_decode_step(cfg, mesh=mesh)):
        with pytest.raises(NotImplementedError, match="one device"):
            call()


def test_published_tensors_are_taken_as_views(reduced):
    cfg, params, pub = reduced
    back = hybrid.from_published(pub, cfg)
    for (path, a), (_, b) in zip(hybrid._walk(params), hybrid._walk(back)):
        assert a.data_ptr() == b.data_ptr() and torch.equal(a, b), path


def test_serve_runs_the_arch_through_the_lm_loop(sinks):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "mimo-v2-flash", "--requests", "2",
                      "--device", "cpu"])
    assert [t.shape for t in out["tokens"]] == [(4, 8), (4, 8)]
    assert set(out["cache"]) == {"t", "full", "window"}
    assert out["cache_bytes"] == sum(
        hybrid.cache_bytes(e) for n, e in out["cache"].items() if n != "t") \
        + out["cache"]["t"].numel() * 8


def test_the_reference_is_plain_torch_and_the_benchmarks_copy_is_it():
    path = REPO / "src/repro_torch/models/transformer/mimo_reference.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "torch"}
    assert (REPO / "gpubench/reference/mimo.py").read_bytes() == \
        path.read_bytes()
