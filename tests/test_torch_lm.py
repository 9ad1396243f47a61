"""The port's LM family against the JAX package on the same inputs.

The JAX side runs under a (1, 1) mesh this file builds with
``axis_types=(AxisType.Auto,) * 2``: under jax 0.9 a plain
``jax.make_mesh`` makes Explicit axes, which the JAX model's
``with_sharding_constraint`` calls reject (that, not the model, is why the
JAX package's own LM tests fail here). Parameters go across with
``lm_params_from_numpy``.

Tolerances: attention schedules ≤ 2e-5 (f32; the JAX tests' own); norm and
RoPE ≤ 1e-6; logits rel ≤ 1e-5 and loss ≤ 1e-6 at f32; ≤ 1e-6 at f64 under
x64 (the scores are float32 in both packages whatever the inputs' dtype, so
f64 agrees only to f32 rounding); every gradient leaf rel L2 ≤ 1e-4 (f32);
prefill and decode as the JAX test holds its own (2e-4 / 2e-3), against
JAX's prefill and decode ≤ 1e-5.
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.configs.registry import ARCHS as J_ARCHS
from repro.data import PsiWeightedSampler as JSampler
from repro.data import TokenPipeline as JPipeline
from repro.models import transformer as jtf
from repro.models.transformer import model as jmodel
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data import PsiWeightedSampler, TokenPipeline
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import model
from repro_torch.train import optim

# the packages export the function ``attention`` under the module's name
jattn = importlib.import_module("repro.models.transformer.attention")
attn = importlib.import_module("repro_torch.models.transformer.attention")

LM_ARCHS = ["tinyllama-1.1b", "yi-9b", "nemotron-4-340b", "mixtral-8x22b",
            "mixtral-8x7b"]
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
               jnp.float64: torch.float64}


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _cfgs(arch, **kw):
    """(JAX config, port config) of ``arch``'s reduced config, both with
    the fields in ``kw`` replaced (``moe`` given as a JAX ``MoECfg``)."""
    jcfg = j_get_arch(arch).config(reduced=True)
    tcfg = get_arch(arch).config(reduced=True)
    tkw = dict(kw)
    if "moe" in kw:
        tkw["moe"] = tf.MoECfg(**dataclasses.asdict(kw["moe"]))
    for k in ("dtype", "param_dtype"):
        if k in kw:
            tkw[k] = TORCH_DTYPE[kw[k]]
    return (dataclasses.replace(jcfg, **kw),
            dataclasses.replace(tcfg, **tkw))


def _params(jcfg, seed=0):
    """(JAX params, the port's copy on the CPU)."""
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------- #
# Attention schedules
# --------------------------------------------------------------------- #
def _qkv(seed, b, s, hkv, g, dh, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hkv, g, dh)).astype(dtype)
    k = rng.normal(size=(b, s, hkv, dh)).astype(dtype)
    v = rng.normal(size=(b, s, hkv, dh)).astype(dtype)
    pos = np.broadcast_to(np.arange(s), (b, s)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("case", ["dense", "blocked", "banded"])
def test_attention_schedules_match_jax(case):
    """The shapes of the JAX tests test_blocked_attention_equals_dense and
    test_banded_swa_equals_dense_window; each port schedule against the
    same JAX schedule and against the port's own dense."""
    if case == "banded":
        q, k, v, pos = _qkv(1, 1, 1024, 2, 2, 16)
        window, args = 64, (128,)
    else:
        q, k, v, pos = _qkv(0, 2, 512, 2, 2, 32)
        window, args = None, (128, 64)
    jq, jk, jv, jpos = map(jnp.asarray, (q, k, v, pos))
    tq, tk, tv, tpos = map(_t, (q, k, v, pos))
    if case == "dense":
        want = jattn._dense(jq, jk, jv, jpos, jpos, window, None)
        got = attn._dense(tq, tk, tv, tpos, tpos, window, None)
    else:
        want = getattr(jattn, f"_{case}")(jq, jk, jv, jpos, jpos, window,
                                          *args)
        got = getattr(attn, f"_{case}")(tq, tk, tv, tpos, tpos, window,
                                        *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    own = attn._dense(tq, tk, tv, tpos, tpos, window, None)
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_attention_decode_with_k_valid_matches_jax():
    """One query against a rolling cache with empty slots (k_valid) and a
    window, through both dispatchers."""
    rng = np.random.default_rng(2)
    b, c, hq, hkv, dh, t = 2, 96, 8, 2, 16, 150
    q = rng.normal(size=(b, 1, hq, dh)).astype("float32")
    k = rng.normal(size=(b, c, hkv, dh)).astype("float32")
    v = rng.normal(size=(b, c, hkv, dh)).astype("float32")
    kpos = np.where(np.arange(c) < 70, t - 69 + np.arange(c), -1)
    kpos = np.broadcast_to(np.roll(kpos, 7), (b, c)).copy()
    qpos = np.full((b, 1), t)
    for window in (None, 64):
        want = jattn.attention(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                               window=window, k_valid=jnp.asarray(kpos >= 0))
        got = attn.attention(*map(_t, (q, k, v, qpos, kpos)), window=window,
                             k_valid=_t(kpos >= 0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_attention_scores_are_f32_at_f64():
    """At f64 the scores are float32 in both packages: the port equals JAX
    under x64 to f32 rounding, and the softmax weights are f32 values."""
    q, k, v, pos = _qkv(3, 1, 64, 2, 2, 16, "float64")
    with _x64():
        want = np.asarray(jattn._dense(*map(jnp.asarray, (q, k, v, pos,
                                                          pos)), 16, None))
    got = attn._dense(*map(_t, (q, k, v, pos, pos)), 16, None)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-6
    assert attn._scores("bqhgd,bkhd->bhgqk", _t(q), _t(k)).dtype == \
        torch.float32


# --------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------- #
def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 4, 16)).astype("float32")
    scale = rng.normal(size=(16,)).astype("float32")
    pos = rng.integers(0, 5000, (2, 9))
    np.testing.assert_allclose(
        model._rms_norm(_t(x), _t(scale), 1e-5).numpy(),
        np.asarray(jmodel._rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                    1e-5)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        model._rope(_t(x), _t(pos), 1e4).numpy(),
        np.asarray(jmodel._rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-6)


def test_init_params_has_the_jax_tree_shapes_and_scales():
    for arch in LM_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tf.init_params(tcfg, 0, device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jp)
        tl = optim.tree_leaves(tp)
        assert len(jl) == len(tl)
        for (path, a), b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape), path
            assert b.requires_grad and b.dtype == torch.float32
            # the same scale: std within 10% (or exactly ones)
            sa, sb = float(jnp.std(a)), float(b.detach().std())
            assert abs(sa - sb) <= 0.1 * max(sa, 1e-3) + 1e-6, (path, sa, sb)
        assert tf.count_params(tcfg) == jtf.count_params(jcfg) == sum(
            x.numel() for x in tl)
        assert tf.active_params(tcfg) == jtf.active_params(jcfg)


def test_configs_and_registry_match_jax():
    """The five archs resolve with the JAX package's full and reduced
    values (torch dtypes), shapes and skips; every JAX arch id resolves
    in the port."""
    assert set(ARCHS) == set(J_ARCHS)
    for arch in LM_ARCHS:
        te, je = get_arch(arch), j_get_arch(arch)
        assert te.family == je.family == "lm"
        assert [dataclasses.asdict(s) for s in te.shapes] == \
            [dataclasses.asdict(s) for s in je.shapes]
        for reduced in (False, True):
            tc, jc = te.config(reduced=reduced), je.config(reduced=reduced)
            td, jd = dataclasses.asdict(tc), dataclasses.asdict(jc)
            for k in ("dtype", "param_dtype"):
                assert td.pop(k) == TORCH_DTYPE[jd.pop(k)]
            assert td.pop("fsdp") == jd.pop("fsdp")
            assert jd.pop("unroll_layers") is False
            assert td == jd
    assert get_arch("tinyllama-1.1b").shape("long_500k").skip
    assert get_arch("mixtral-8x7b").shape("long_500k").skip is None


def test_bf16_params_cross_bit_for_bit():
    jcfg = j_get_arch("tinyllama-1.1b").config(reduced=True)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16,
                               param_dtype=jnp.bfloat16)
    jp, tp = _params(jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(jp), optim.tree_leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(a).view(np.int16), b.detach().view(torch.int16))
    back = jax.tree.map(lambda x: jnp.asarray(x.view(jnp.bfloat16)),
                        lm_params_to_numpy(tp))
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))


# --------------------------------------------------------------------- #
# Forward, loss and gradients
# --------------------------------------------------------------------- #
def _batch(cfg, b=4, s=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_and_grads_match_jax_f32(arch, mesh):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks, labels = _batch(jcfg)
    labels = labels.copy()
    labels[0, :3] = -1                               # masked positions
    jb = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    tb = dict(tokens=_t(toks), labels=_t(labels))
    want = np.asarray(jtf.forward(jp, jb["tokens"], jcfg, mesh))
    got = tf.forward(tp, tb["tokens"], tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.detach().numpy(), want) <= 1e-5
    jloss, jgrads = jax.value_and_grad(jtf.loss_fn)(jp, jb, jcfg, mesh)
    tloss, tgrads = model._value_and_grad(tp, tb, tcfg)
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            optim.tree_leaves(tgrads)):
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_match_jax_f64(arch, mesh):
    with _x64():
        jcfg, tcfg = _cfgs(arch, dtype=jnp.float64, param_dtype=jnp.float64)
        jp, tp = _params(jcfg)
        toks, labels = _batch(jcfg, seed=1)
        jb = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
        want = np.asarray(jtf.forward(jp, jb["tokens"], jcfg, mesh))
        jloss = float(jtf.loss_fn(jp, jb, jcfg, mesh))
    tb = dict(tokens=_t(toks), labels=_t(labels))
    with torch.no_grad():
        got = tf.forward(tp, tb["tokens"], tcfg)
        tloss = float(tf.loss_fn(tp, tb, tcfg))
    assert got.dtype == torch.float32          # logits are f32, as in JAX
    assert _rel(got.numpy(), want) <= 1e-6
    assert abs(tloss - jloss) <= 1e-6 * abs(jloss)


def test_remat_changes_no_gradient():
    _, tcfg = _cfgs("mixtral-8x7b")
    tp = tf.init_params(tcfg, 3, device="cpu")
    toks, labels = _batch(tcfg, seed=2)
    tb = dict(tokens=_t(toks), labels=_t(labels))
    _, g1 = model._value_and_grad(tp, tb, tcfg)
    _, g2 = model._value_and_grad(
        tp, tb, dataclasses.replace(tcfg, remat=False))
    for a, b in zip(optim.tree_leaves(g1), optim.tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
def test_moe_capacity_drops_match_jax(mesh):
    """test_moe_capacity_drops_tokens's config (capacity factor 0.1): the
    MoE layer's output equals JAX's on the same input, and the same tokens
    are dropped (the counts from JAX's own routing of that input)."""
    jcfg = jtf.LMConfig(name="m", n_layers=1, d_model=32, n_heads=2,
                        n_kv_heads=1, d_ff=64, vocab=64,
                        moe=jtf.MoECfg(2, 2, capacity_factor=0.1),
                        dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = tf.LMConfig(name="m", n_layers=1, d_model=32, n_heads=2,
                       n_kv_heads=1, d_ff=64, vocab=64,
                       moe=tf.MoECfg(2, 2, capacity_factor=0.1),
                       dtype=torch.float32, param_dtype=torch.float32)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(0).integers(0, 64, (2, 16))
    want = np.asarray(jtf.forward(jp, jnp.asarray(toks), jcfg, mesh))
    drops = []
    got = tf.forward(tp, _t(toks), tcfg, moe_drops=drops)
    assert np.all(np.isfinite(got.detach().numpy()))
    assert _rel(got.detach().numpy(), want) <= 1e-5
    # the MoE layer alone on a shared input
    rng = np.random.default_rng(5)
    h = rng.normal(size=(2, 16, 32)).astype("float32")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = model._unstack(tp["layers"])[0]
    jout = np.asarray(jmodel._moe_ffn(jnp.asarray(h), jlp, jcfg, mesh))
    tdrops = []
    tout = model._moe_ffn(_t(h), tlp, tcfg, tdrops)
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    logits = jnp.asarray(h).reshape(32, 32) @ jlp["router"]
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), 2)
    counts = np.bincount(np.asarray(eidx).ravel(), minlength=2)
    cap = max(8, int(2 * 32 / 2 * 0.1))
    np.testing.assert_array_equal(tdrops[0].numpy(),
                                  np.maximum(counts - cap, 0))
    # top-2 of 2 experts: every token picks both, each expert keeps cap
    assert int(tdrops[0].sum()) == 64 - 2 * cap > 0
    assert len(drops) == 1 and int(drops[0].sum()) > 0


def test_moe_combine_equals_a_per_token_sum():
    """Capacity large enough for every assignment: the layer equals the
    per-token sum over its top-k experts of gate × expert FFN."""
    _, tcfg = _cfgs("mixtral-8x7b", moe=jtf.MoECfg(4, 2, 8.0))
    tp = tf.init_params(tcfg, 1, device="cpu")
    lp = model._unstack(tp["layers"])[0]
    x = torch.randn(3, 5, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    drops = []
    with torch.no_grad():
        out = model._moe_ffn(x, lp, tcfg, drops).reshape(15, -1)
        xf = x.reshape(15, -1)
        gates, eidx = torch.topk(torch.softmax(xf @ lp["router"], -1), 2)
        gates = gates / gates.sum(-1, keepdim=True)
        want = torch.zeros_like(out)
        for t in range(15):
            for j in range(2):
                e = int(eidx[t, j])
                h = F.silu(xf[t] @ lp["w1"][e]) * (xf[t] @ lp["w3"][e])
                want[t] += gates[t, j] * (h @ lp["w2"][e])
    assert int(drops[0].sum()) == 0
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,S", [("tinyllama-1.1b", 12),
                                    ("mixtral-8x7b", 12),
                                    ("mixtral-8x7b", 80)])
def test_prefill_then_decode_matches_jax_and_forward(arch, S, mesh):
    """The JAX test's setup (capacity factor 8, 4 decode steps), plus a
    mixtral prompt longer than its window of 64, so the rolling cache is
    rolled. Against JAX's prefill and decode (≤ 1e-5) and the port's own
    forward (the JAX test's 2e-4 / 2e-3)."""
    kw = {}
    if arch.startswith("mixtral"):
        kw["moe"] = jtf.MoECfg(4, 2, capacity_factor=8.0)
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=1)
    seq = np.random.default_rng(1).integers(0, jcfg.vocab, (2, S + 4))
    jprefill = jax.jit(jtf.make_prefill(jcfg, mesh, max_len=S + 4))
    jdecode = jax.jit(jtf.make_decode_step(jcfg, mesh))
    prefill = tf.make_prefill(tcfg, max_len=S + 4)
    decode = tf.make_decode_step(tcfg)
    with torch.no_grad():
        full = tf.forward(tp, _t(seq), tcfg).numpy()
    jcache, jlg = jprefill(jp, jnp.asarray(seq[:, :S]))
    cache, lg = prefill(tp, _t(seq[:, :S]))
    c = min(S + 4, tcfg.sliding_window or S + 4)
    assert cache["k"].shape == (tcfg.n_layers, 2, c, tcfg.n_kv_heads,
                                tcfg.head_dim)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert cache["t"] == int(jcache["t"]) == S
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lg.numpy(), full[:, S - 1], rtol=2e-4,
                               atol=2e-4)
    for t in range(S, S + 4):
        jcache, jlg = jdecode(jp, jcache, jnp.asarray(seq[:, t]))
        cache, lg = decode(tp, cache, _t(seq[:, t]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lg.numpy(), full[:, t], rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert cache["t"] == S + 4


@pytest.mark.parametrize("arch,S", [("tinyllama-1.1b", 12),
                                    ("mixtral-8x7b", 80)])
def test_decode_consumes_its_cache_and_a_copy_branches(arch, S, mesh):
    """Two continuations of one prefill: the JAX step is functional, so
    both decode from the same JAX cache; the port's step consumes its cache
    (keys, values, pos and t advance together, in place), so the second
    continuation decodes from a copy taken before the first. Both against
    JAX ≤ 1e-5, for two steps each; the mixtral prompt fills its rolling
    cache, so each step overwrites a live slot."""
    kw = {}
    if arch.startswith("mixtral"):
        kw["moe"] = jtf.MoECfg(4, 2, capacity_factor=8.0)
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.default_rng(2)
    seq = rng.integers(0, jcfg.vocab, (2, S))
    branches = rng.integers(0, jcfg.vocab, (2, 2, 2))   # [way, step, B]
    jprefill = jax.jit(jtf.make_prefill(jcfg, mesh, max_len=S + 2))
    jdecode = jax.jit(jtf.make_decode_step(jcfg, mesh))
    decode = tf.make_decode_step(tcfg)
    jcache0, _ = jprefill(jp, jnp.asarray(seq))
    cache0, _ = tf.make_prefill(tcfg, max_len=S + 2)(tp, _t(seq))
    copy = {k: v.clone() if torch.is_tensor(v) else v
            for k, v in cache0.items()}
    for way, cache in enumerate((cache0, copy)):
        jcache = jcache0
        for step in range(2):
            tok = branches[way, step]
            jcache, jlg = jdecode(jp, jcache, jnp.asarray(tok))
            out, lg = decode(tp, cache, _t(tok))
            assert out is cache and cache["t"] == S + step + 1
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(cache["pos"].numpy(),
                                          np.asarray(jcache["pos"]))
            np.testing.assert_allclose(cache["k"].numpy(),
                                       np.asarray(jcache["k"]), rtol=1e-5,
                                       atol=1e-5)


def test_init_cache_matches_jax():
    for arch in ("tinyllama-1.1b", "mixtral-8x7b"):
        jcfg, tcfg = _cfgs(arch)
        for max_len in (16, 200):
            jc = jtf.init_cache(jcfg, 3, max_len)
            tc = tf.init_cache(tcfg, 3, max_len, device="cpu")
            assert tuple(tc["k"].shape) == jc["k"].shape
            np.testing.assert_array_equal(tc["pos"].numpy(),
                                          np.asarray(jc["pos"]))
            assert tc["t"] == int(jc["t"]) == 0
            assert tc["k"].data_ptr() != tc["v"].data_ptr()


# --------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------- #
def test_token_pipeline_and_sampler_are_the_jax_packages():
    for kw in (dict(vocab=256, seq_len=64, global_batch=8),
               dict(vocab=32000, seq_len=17, global_batch=6, seed=3)):
        tp, jp = TokenPipeline(**kw), JPipeline(**kw)
        for step in (0, 5):
            a, b = tp.batch(step), jp.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            for k, v in tp.host_batch(step, 1, 2).items():
                np.testing.assert_array_equal(v, jp.host_batch(step, 1, 2)[k])
    psi = np.random.default_rng(0).random(500)
    ts, js = PsiWeightedSampler(psi, temperature=0.5, seed=4), \
        JSampler(psi, temperature=0.5, seed=4)
    np.testing.assert_array_equal(ts.sample_users(1000),
                                  js.sample_users(1000))
    assert ts.mixture_stats(2000) == js.mixture_stats(2000)
