"""Decode attention over a full layer's cache (``kernels/decode_attn.py``):
the wrapper's plain path, its checks, the hybrid decode step's dispatch
and gauge on the CPU, and (marked ``cuda``, skipped without a card) the
kernel against its plain version. On a card::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_attn.py

This file imports only the port (the card's machine has no JAX).

Tolerance of the kernel against the plain version, an entry at a time:
``|kernel − plain| ≤ 2⁻⁶ (|plain| + rms)``, the rms over the entry's head.
Both round the output to bf16 (unit roundoff 2⁻⁸), so two nearby f32
values can land one ulp apart (≤ 2⁻⁷ relative); the plain version rounds
each probability to bf16 after normalising, the kernel before (an online
softmax does not know the sum yet), so each of P's roundings moves by
≤ 2⁻⁸ of its own size, a noise on the order of 2⁻⁸ of the head's typical
output, which the rms term takes where an entry is near zero.
:func:`_emulate` repeats the kernel's arithmetic (chunks, warps, tiles,
online state, merges) in plain PyTorch, so the CPU holds that bound too
(the worst of 60 draws read 0.78 of it).
"""
import math

import pytest
import torch

from repro_torch import obs as tobs
from repro_torch.configs import mimo_v2_flash
from repro_torch.kernels import decode_attn
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_plain,
                                             least_bytes)
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import hybrid
from repro_torch.models.transformer.attention import cached_attention

RTOL = 2.0 ** -6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_decode_attn.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def sinks():
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracer=tobs.trace.NULL_TRACER)
    yield
    tobs.restore(prev)


def _inputs(b, hq, hkv, c, dk, dv, q_pos, *, dtype=torch.bfloat16,
            sharp=1.0, seed=0, device="cpu"):
    """q, kc, vc, q_pos (N(0, 1) entries, q times ``sharp``) and a sink
    f32[hq], drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(b, 1, hq, dk, generator=g) * sharp).to(dtype)
    kc = torch.randn(b, hkv, c, dk, generator=g).to(dtype)
    vc = torch.randn(b, hkv, c, dv, generator=g).to(dtype)
    sink = torch.randn(hq, generator=g)
    pos = torch.tensor(q_pos, dtype=torch.long)[:, None]
    return [x.to(device) for x in (q, kc, vc, pos, sink)]


def _within(got, want, dv):
    """The worst entry's error as a share of ``RTOL (|want| + rms)``."""
    got, want = got.double(), want.double()
    heads = want.reshape(*want.shape[:-1], -1, dv)
    rms = heads.pow(2).mean(-1, keepdim=True).sqrt().expand_as(heads)
    err = (got.reshape(heads.shape) - heads).abs()
    return float((err / (RTOL * (heads.abs() + rms))).max())


def _emulate(q, kc, vc, q_pos, *, sink=None, v_scale=None, chunk=64,
             warps=2, tile=16):
    """The kernel's arithmetic in plain PyTorch: chunks of ``chunk`` slots,
    each warp every ``warps``-th tile of ``tile`` slots with an f32 online
    state (P rounded to bf16 for P·V), the warps merged in warp order, the
    chunks in chunk order from the sink (m = sink, l = 1)."""
    b, _, hq, dk = q.shape
    hkv, c, dv = kc.shape[1], kc.shape[2], vc.shape[-1]
    g = hq // hkv
    qf = q[:, 0].float().reshape(b, hkv, g, dk)
    kf, vf = kc.float(), vc.float()
    n = (q_pos[:, 0] + 1).clamp(0, c)
    scale = torch.tensor(1.0 / math.sqrt(dk), dtype=torch.float32)
    neg = torch.tensor(-math.inf)
    if sink is None:
        m = torch.full((b, hkv, g), -math.inf)
        l_ = torch.zeros(b, hkv, g)
    else:
        m = sink.float().reshape(1, hkv, g).expand(b, hkv, g).clone()
        l_ = torch.ones(b, hkv, g)
    acc = torch.zeros(b, hkv, g, dv)
    for c0 in range(0, c, chunk):
        end = torch.minimum(n, torch.tensor(c0 + chunk))
        states = []
        for w in range(warps):
            wm = torch.full((b, hkv, g), -math.inf)
            wl, wa = torch.zeros(b, hkv, g), torch.zeros(b, hkv, g, dv)
            for t0 in range(c0 + w * tile, min(c0 + chunk, c),
                            warps * tile):
                sl = slice(t0, min(t0 + tile, c))
                live = torch.arange(sl.start, sl.stop)[None] < end[:, None]
                on = live.any(-1)[:, None, None]
                s = torch.einsum("bhgd,bhkd->bhgk", qf, kf[:, :, sl]) * scale
                s = torch.where(live[:, None, None], s, neg)
                mn = torch.maximum(wm, s.amax(-1))
                mn = torch.where(on, mn, wm)
                alpha = torch.where(on, torch.exp(wm - mn), 1.0)
                p = torch.exp(s - mn[..., None])
                p = torch.where(on[..., None], p, 0.0)
                wl = torch.where(on, wl * alpha + p.sum(-1), wl)
                wa = wa * alpha[..., None] + torch.einsum(
                    "bhgk,bhkd->bhgd", p.bfloat16().float(), vf[:, :, sl])
                wm = mn
            states.append((wm, wl, wa))
        cm = torch.stack([s[0] for s in states]).amax(0)
        cl = torch.zeros_like(cm)
        ca = torch.zeros_like(acc)
        for wm, wl, wa in states:
            e = torch.nan_to_num(torch.exp(wm - cm), nan=0.0)
            cl, ca = cl + wl * e, ca + wa * e[..., None]
        live = (torch.tensor(c0) < n)[:, None, None]
        mn = torch.where(live, torch.maximum(m, cm), m)
        ea = torch.nan_to_num(torch.exp(m - mn), nan=0.0)
        eb = torch.where(live, torch.exp(cm - mn), 0.0)
        l_ = l_ * ea + torch.where(live, cl, 0.0) * eb
        acc = acc * ea[..., None] + torch.where(live[..., None], ca,
                                                0.0) * eb[..., None]
        m = mn
    out = acc / l_[..., None] * (1.0 if v_scale is None else v_scale)
    return out.to(q.dtype).reshape(b, 1, hq * dv)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_sink", [False, True])
@pytest.mark.parametrize("v_scale", [None, 0.707])
def test_the_plain_path_is_cached_attention_bit_for_bit(dtype, with_sink,
                                                        v_scale):
    q, kc, vc, pos, sink = _inputs(5, 16, 2, 70, 192, 128,
                                   [0, 15, 16, 40, 69], dtype=dtype)
    sink = sink if with_sink else None
    got = decode_attention(q, kc, vc, pos, sink=sink, v_scale=v_scale)
    want = cached_attention(q, kc, vc, pos, torch.arange(70)[None],
                            window=None, sink=sink, v_scale=v_scale)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("hq,hkv,with_sink,sharp", [
    (32, 2, False, 1.0), (32, 2, True, 1.0), (16, 2, True, 4.0),
    (32, 2, False, 8.0)])
def test_the_kernels_arithmetic_holds_the_stated_bound(hq, hkv, with_sink,
                                                       sharp):
    q_pos = [0, 63, 64, 65, 127, 128, 299, 150]
    q, kc, vc, pos, sink = _inputs(8, hq, hkv, 300, 192, 128, q_pos,
                                   sharp=sharp, seed=hq + int(sharp))
    sink = sink if with_sink else None
    want = cached_attention(q, kc, vc, pos, torch.arange(300)[None],
                            window=None, sink=sink, v_scale=0.707)
    got = _emulate(q, kc, vc, pos, sink=sink, v_scale=0.707)
    assert _within(got, want, 128) <= 1.0
    # a slot past a row's position moves nothing
    spoiled = [x.clone() for x in (kc, vc)]
    for r, p in enumerate(q_pos):
        for x in spoiled:
            x[r, :, p + 1:] = 1e4
    assert torch.equal(_emulate(q, *spoiled, pos, sink=sink, v_scale=0.707),
                       got)


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    q, kc, vc, pos, sink = _inputs(3, 16, 2, 40, 192, 128, [1, 2, 3])
    ok = dict(q=q, kc=kc, vc=vc, q_pos=pos)
    bad = [
        dict(ok, kc=kc.float()),                          # dtype
        dict(ok, q_pos=pos.int()),
        dict(ok, vc=vc[:, :, :39]),                       # shape
        dict(ok, q=q.reshape(3, 16, 1, 192)),
        dict(ok, q_pos=pos[:2]),
        dict(ok, kc=kc.transpose(2, 3).contiguous().transpose(2, 3)),
        dict(ok, q_pos=torch.stack([pos[:, 0], pos[:, 0]], 1)[:, :1]),
        dict(ok, q=torch.zeros(3, 1, 13, 192, dtype=q.dtype)),  # 13 / 2
        dict(ok, q=torch.zeros(3, 1, 6, 192, dtype=q.dtype),
             kc=kc[:, :1].repeat(1, 4, 1, 1), vc=vc[:, :1].repeat(1, 4, 1, 1)),
        dict(ok, kc=kc[..., :128].contiguous(),          # (128, 128)
             q=q[..., :128].contiguous()),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            decode_attention(**kw)
    with pytest.raises(ValueError):                       # group 17
        decode_attention(torch.zeros(3, 1, 34, 192, dtype=q.dtype),
                         kc, vc, pos)
    with pytest.raises(ValueError):
        decode_attention(**ok, sink=sink[:8])
    with pytest.raises(ValueError):
        decode_attention(**ok, sink=sink.double())
    # off the CPU the kernel takes bf16 alone (checked before any launch)
    meta = {k: v.to("meta") for k, v in ok.items()}
    with pytest.raises(ValueError):
        decode_attention(**dict(meta, q=meta["q"].float(),
                                kc=meta["kc"].float(), vc=meta["vc"].float()))


def _cpu_cfg():
    return mimo_v2_flash.config(reduced=True)


def test_the_cpu_decode_step_keeps_cached_attention(monkeypatch):
    cfg = _cpu_cfg()
    params = tf.init_params(cfg, 5, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 11),
                           generator=torch.Generator().manual_seed(2))
    cache, _ = tf.make_prefill(cfg, max_len=14)(params, tokens)
    seen = []
    real = hybrid.cached_attention

    def spy(*args, **kw):
        seen.append(kw["window"])
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper on a CPU step")

    monkeypatch.setattr(hybrid, "cached_attention", spy)
    monkeypatch.setattr(hybrid.decode_attn, "decode_attention", refuse)
    step = tf.make_decode_step(cfg)
    step(params, cache, tokens[:, -1])
    assert seen.count(None) == cfg.count("full") and \
        len(seen) == cfg.n_layers


def test_the_gauge_holds_one_launchs_least_bytes(sinks):
    cfg = _cpu_cfg()
    params = tf.init_params(cfg, 5, device="cpu")
    lengths, c = [3, 9, 12], 14
    cache = hybrid.init_cache(cfg, 3, c, device="cpu")
    prefill = tf.make_prefill(cfg)
    g = torch.Generator().manual_seed(4)
    for r, n in enumerate(lengths):
        prefill(params, torch.randint(0, cfg.vocab, (1, n), generator=g),
                cache, [r])
    reg = tobs.metrics.get_registry()
    step = tf.make_decode_step(cfg)
    step(params, cache, torch.zeros(3, dtype=torch.long))
    assert reg.get("lm_decode_attn_least_bytes") is None   # no tracer
    prev = tobs.trace.set_tracer(tobs.Tracer())
    try:
        step(params, cache, torch.zeros(3, dtype=torch.long))
    finally:
        tobs.trace.set_tracer(prev)
    hkv, dk, dv = cfg.kind("full").n_kv_heads, cfg.qk_head_dim, cfg.v_head_dim
    elem = torch.empty((), dtype=cfg.dtype).element_size()
    # the step read each row at position t = length + 1: t + 1 slots
    want = (sum(n + 2 for n in lengths) * hkv * (dk + dv)
            + 3 * cfg.n_heads * (dk + dv)) * elem
    assert reg.value("lm_decode_attn_least_bytes") == want
    q = torch.zeros(3, 1, cfg.n_heads, dk)
    kc, vc = cache["full"]["k"][0], cache["full"]["v"][0]
    pos = torch.tensor([[0], [c - 1], [c + 5]])      # the last clamps to C
    assert least_bytes(q.to(cfg.dtype), kc, vc, pos) == \
        ((1 + c + c) * hkv * (dk + dv) + 3 * cfg.n_heads * (dk + dv)) * elem


# ------------------------------------------------------------- the card
def _nan_past(x, q_pos):
    """A copy of cache ``x`` with every slot past each row's position NaN."""
    y = x.clone()
    for r, p in enumerate(q_pos):
        y[r, :, p + 1:] = float("nan")
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(64, 4), (32, 4)])
@pytest.mark.parametrize("with_sink", [False, True])
@pytest.mark.parametrize("v_scale,sharp", [(0.707, 1.0), (None, 8.0),
                                           (0.707, 0.25)])
def test_kernel_matches_plain_on_card(card, hq, hkv, with_sink, v_scale,
                                      sharp):
    ch = decode_attn.CHUNK
    c = 2 * ch + 100
    q_pos = [0, ch - 1, ch, ch + 1, c - 1, 37, 2 * ch - 1, 1500]
    q, kc, vc, pos, sink = _inputs(len(q_pos), hq, hkv, c, 192, 128, q_pos,
                                   sharp=sharp, seed=hq + int(8 * sharp),
                                   device=card)
    sink = sink if with_sink else None
    want = decode_attention_plain(q, kc, vc, pos, sink=sink, v_scale=v_scale)
    kn, vn = _nan_past(kc, q_pos), _nan_past(vc, q_pos)
    before = decode_attention.launches
    got = decode_attention(q, kn, vn, pos, sink=sink, v_scale=v_scale)
    again = decode_attention(q, kn, vn, pos, sink=sink, v_scale=v_scale)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert bool(torch.isfinite(got).all())
    assert _within(got, want, 128) <= 1.0
    assert torch.equal(got, again)


def _card_cfg():
    spec = dict(mimo_v2_flash.REDUCED, hidden_size=256, head_dim=192,
                v_head_dim=128, num_attention_heads=32,
                num_key_value_heads=2, swa_num_key_value_heads=4)
    return mimo_v2_flash.from_config(spec, n_held=16)


@pytest.mark.cuda
def test_decode_step_through_the_kernel_on_card(card, monkeypatch):
    """The step's logits through the kernel against the same step with
    ``cached_attention`` on the full layers, on one prefilled cache: rel L2
    a row ≤ 0.02, the cell's own limit on the logits against the f64
    reference (the rounding of P moves; nothing else does)."""
    cfg = _card_cfg()
    params = tf.init_params(cfg, 9, device=card)
    lengths, turn = [5, 1030, 2100, 700], 3
    cache = hybrid.init_cache(cfg, len(lengths), max(lengths) + turn,
                              device=card)
    prefill = tf.make_prefill(cfg)
    g = torch.Generator(device=card).manual_seed(6)
    for r, n in enumerate(lengths):
        prefill(params, torch.randint(0, cfg.vocab, (1, n), generator=g,
                                      device=card), cache, [r])
    forced = torch.randint(0, cfg.vocab, (len(lengths), turn), generator=g,
                           device=card)
    snap = hybrid.snapshot(cache, cfg)
    step = tf.make_decode_step(cfg)

    def turn_logits():
        out = torch.stack([step(params, cache, forced[:, j])[1]
                           for j in range(turn)], 1)
        hybrid.rewind(cache, snap, turn)
        return out

    before = decode_attention.launches
    got = turn_logits()
    assert decode_attention.launches == before + turn * cfg.count("full")
    monkeypatch.setattr(hybrid.decode_attn, "decode_attention",
                        decode_attention_plain)
    want = turn_logits()
    rel = ((got.double() - want.double()).norm(dim=-1)
           / want.double().norm(dim=-1)).max()
    assert float(rel) <= 0.02
