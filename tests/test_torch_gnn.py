"""The port's GNN slice (sampler, segment helpers, GraphSAGE, AdamW, the
trainer) against the JAX package on the same numpy-seeded inputs.

Tolerances: the sampler is held bit for bit (the same numpy code). f32
values at rtol 2e-5 / atol 2e-6 (the JAX package's own kernel sweeps: sums
taken in another order than XLA's ``segment_sum``), every gradient at
relative L2 1e-4, AdamW parameters after 5 steps at rtol 1e-6, and the
trainer's first 5 losses at relative 1e-3 (Adam's g/√v magnifies f32
sum-order differences where gradients are near 0).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
import repro_torch.graphs as tg
from repro.graphs.sampler import fanout_sample as j_fanout_sample
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models.gnn import common as jcommon
from repro.models.gnn import sage as jsage
from repro.configs import get_arch as j_get_arch
from repro import train as joptim
from repro_torch.configs import get_arch
from repro_torch.convert import sage_params_from_numpy
from repro_torch.graphs.sampler import fanout_sample, subgraph_budget
from repro_torch.launch import specs, train
from repro_torch.models.gnn import common, sage
from repro_torch.train import optim

F32 = dict(rtol=2e-5, atol=2e-6)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------- #
# Sampler
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 6])
def test_fanout_sample_matches_jax_bit_for_bit(seed):
    g_t, g_j = tg.erdos_renyi(500, 4000, seed=5), jg.erdos_renyi(500, 4000,
                                                                 seed=5)
    seeds = np.arange(16)
    a = fanout_sample(g_t, seeds, (4, 3), seed=seed)
    b = j_fanout_sample(g_j, seeds, (4, 3), seed=seed)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(x, y) and np.asarray(x).dtype == \
            np.asarray(y).dtype, f.name
    assert (a.n_pad, a.e_pad) == subgraph_budget(16, (4, 3))


# --------------------------------------------------------------------- #
# Segment helpers
# --------------------------------------------------------------------- #
def _edges(n=60, m=300, seed=3, sentinels=7):
    """dst-sorted edges of a random graph followed by sentinel edges."""
    g = tg.erdos_renyi(n, m, seed=seed)
    src, dst = g.edges_by_dst
    src = np.concatenate([src, np.full(sentinels, n)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(sentinels, n)]).astype(np.int32)
    return n, src, dst


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min", "std"])
@pytest.mark.parametrize("width", [None, 8])
def test_segment_agg_matches_jax(kind, width):
    """Every kind at f32 against JAX's at f32, except ``std``: the port
    takes the two-pass variance, the JAX package mean(x²) − mean², the same
    function; so ``std`` is held at f64 against JAX at x64 (1e-12) and at
    f32 against that f64 value (JAX's own f32 misses it by 3.5e-3 relative
    where a node's messages nearly agree)."""
    n, _, dst = _edges()
    shape = (dst.shape[0],) if width is None else (dst.shape[0], width)
    vals = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = common.segment_agg(torch.as_tensor(vals), torch.as_tensor(dst), n,
                             kind)
    if kind != "std":
        want = jcommon.segment_agg(jnp.asarray(vals), jnp.asarray(dst), n,
                                   kind)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        return
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jcommon.segment_agg(
            jnp.asarray(vals, jnp.float64), jnp.asarray(dst), n, kind))
    finally:
        jax.config.update("jax_enable_x64", prev)
    got64 = common.segment_agg(torch.as_tensor(vals, dtype=torch.float64),
                               torch.as_tensor(dst), n, kind)
    assert got.shape == got64.shape == want.shape
    np.testing.assert_allclose(got64.numpy(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_segment_agg_sum_differentiates_through_seg_mm():
    n, _, dst = _edges()
    vals = np.random.default_rng(2).normal(size=(dst.shape[0], 4))
    w = np.random.default_rng(3).normal(size=(n, 4))
    v = torch.tensor(vals, dtype=torch.float32, requires_grad=True)
    (common.segment_agg(v, torch.as_tensor(dst), n, "mean")
     * torch.as_tensor(w, dtype=torch.float32)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jcommon.segment_agg(
        x, jnp.asarray(dst), n, "mean") * jnp.asarray(w, jnp.float32)))(
        jnp.asarray(vals, jnp.float32))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_matches_jax(heads):
    n, _, dst = _edges()
    shape = (dst.shape[0],) if heads is None else (dst.shape[0], heads)
    logits = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    got = common.segment_softmax(torch.as_tensor(logits),
                                 torch.as_tensor(dst), n)
    want = jcommon.segment_softmax(jnp.asarray(logits), jnp.asarray(dst), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_graph_pool_matches_jax(kind):
    rng = np.random.default_rng(5)
    n, n_graphs = 30, 4
    vals = rng.normal(size=(n, 5)).astype(np.float32)
    gid = np.sort(rng.integers(0, n_graphs, n)).astype(np.int32)
    mask = rng.random(n) > 0.2
    t = common.GraphBatch(n=n, x=torch.zeros(n, 1), src=torch.zeros(0),
                          dst=torch.zeros(0), node_mask=torch.as_tensor(mask),
                          graph_ids=torch.as_tensor(gid), n_graphs=n_graphs)
    j = jcommon.GraphBatch(n=n, x=jnp.zeros((n, 1)), src=jnp.zeros(0),
                           dst=jnp.zeros(0), node_mask=jnp.asarray(mask),
                           graph_ids=jnp.asarray(gid), n_graphs=n_graphs)
    np.testing.assert_allclose(
        common.graph_pool(torch.as_tensor(vals), t, kind).numpy(),
        np.asarray(jcommon.graph_pool(jnp.asarray(vals), j, kind)), **F32)


def test_mlp_apply_matches_jax():
    rng = np.random.default_rng(6)
    dims = [5, 7, 3]
    layers = [dict(w=rng.normal(size=(a, b)).astype(np.float32),
                   b=rng.normal(size=b).astype(np.float32))
              for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(4, 5)).astype(np.float32)
    got = common.mlp_apply([{k: torch.as_tensor(v) for k, v in lyr.items()}
                            for lyr in layers], torch.as_tensor(x))
    want = jcommon.mlp_apply([{k: jnp.asarray(v) for k, v in lyr.items()}
                              for lyr in layers], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    shapes = [(lyr["w"].shape, lyr["b"].shape) for lyr in common.mlp_init(
        torch.Generator().manual_seed(0), dims)]
    assert shapes == [((5, 7), (7,)), ((7, 3), (3,))]


def test_edge_agg_slots_hold_each_edge_once():
    n, src, dst = _edges()
    agg = common.edge_agg(src, dst, n, tiles=(32, 1, 32), device="cpu")
    real = int((dst < n).sum())
    assert agg.edge_ids.numel() == real and agg.slots.numel() == real
    flat = agg.fmt.src_idx.reshape(-1)
    assert torch.equal(flat[agg.slots].long(),
                       torch.as_tensor(src)[agg.edge_ids].long())
    assert int((flat != n).sum()) == real
    assert agg.padding == flat.numel() / real
    assert torch.equal(agg.in_degree, torch.as_tensor(
        np.bincount(dst[dst < n], minlength=n)))


# --------------------------------------------------------------------- #
# GraphSAGE
# --------------------------------------------------------------------- #
def _params():
    cfg_j = j_get_arch("graphsage-reddit").config(reduced=True)
    tree = jax.tree.map(np.asarray, jsage.init_params(cfg_j,
                                                      jax.random.PRNGKey(0)))
    return cfg_j, get_arch("graphsage-reddit").config(reduced=True), tree


def _toy_batches(cfg):
    rng = np.random.default_rng(0)
    g_t, g_j = tg.erdos_renyi(48, 200, seed=1), jg.erdos_renyi(48, 200, seed=1)
    x = rng.normal(size=(g_t.n, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, g_t.n)
    return (common.batch_from_graph(g_t, x, labels=labels, device="cpu"),
            jcommon.batch_from_graph(g_j, x, labels=labels))


def _sampled_batches(cfg):
    """A fanout-sampled minibatch padded past the sampler's budget (sentinel
    edges present): the trainer's minibatch path against the same padded
    batch built from the JAX package's sampler."""
    g_t, g_j = tg.erdos_renyi(500, 4000, seed=5), jg.erdos_renyi(500, 4000,
                                                                 seed=5)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(g_t.n, cfg.d_feat)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, g_t.n)
    seeds = np.arange(16)
    n, e = subgraph_budget(16, (4, 3))
    e_big = e + 40
    mb, _ = train.sample_minibatch(g_t, seeds, (4, 3), n=n, e=e_big, seed=0)
    data = train.NodeData(g_t, torch.as_tensor(feats),
                          torch.as_tensor(labels))
    sub = j_fanout_sample(g_j, seeds, (4, 3), seed=0)
    ids = np.maximum(sub.node_ids, 0)
    jb = jcommon.GraphBatch(
        n=sub.n_pad, x=jnp.asarray(feats[ids] * sub.node_mask[:, None]),
        src=jnp.asarray(sub.src), dst=jnp.asarray(sub.dst),
        node_mask=jnp.asarray(sub.node_mask),
        labels=jnp.asarray(np.where(sub.node_mask, labels[ids], -1)),
        seed_mask=jnp.asarray(sub.seed_mask))
    return mb.batch(data), jcommon.pad_graph_batch(jb, n, e_big)


@pytest.mark.parametrize("make", [_toy_batches, _sampled_batches],
                         ids=["er48", "sampled-padded"])
def test_sage_logits_loss_and_grads_match_jax(make):
    cfg_j, cfg, tree = _params()
    bt, bj = make(cfg)
    params = sage_params_from_numpy(tree, device="cpu")
    logits = sage.apply(params, bt, cfg)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(jsage.apply, static_argnums=2)(tree, bj, cfg_j)),
        **F32)
    loss = sage.loss_fn(params, bt, cfg)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jsage.loss_fn),
                              static_argnums=2)(tree, bj, cfg_j)
    assert abs(loss.item() - float(loss_j)) <= 2e-5 * abs(float(loss_j))
    loss.backward()
    got = optim.tree_leaves(optim.tree_map(lambda p: p.grad, params))
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_l2(g.numpy(), w) <= 1e-4


def test_sage_init_params_shapes_and_device_rule():
    cfg = get_arch("graphsage-reddit").config()
    p = sage.init_params(cfg, 0, device="cpu")
    assert p["layers"][0]["w_self"]["w"].shape == (602, 128)
    assert p["layers"][1]["w_neigh"]["w"].shape == (128, 128)
    assert p["head"]["w"].shape == (128, 41)
    assert all(x.requires_grad for x in optim.tree_leaves(p))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sage.init_params(cfg, 0)


# --------------------------------------------------------------------- #
# Optimizer and schedules
# --------------------------------------------------------------------- #
def test_schedules_match_jax():
    for t_sched, j_sched in [
            (optim.cosine_schedule(1e-3, 10_000, 100),
             joptim.cosine_schedule(1e-3, 10_000, 100)),
            (optim.cosine_schedule(3e-3, 5, 2), joptim.cosine_schedule(3e-3,
                                                                      5, 2)),
            (optim.linear_schedule(1e-2, 50, 5), joptim.linear_schedule(1e-2,
                                                                       50, 5)),
            (optim.constant_schedule(5e-3), joptim.constant_schedule(5e-3))]:
        for step in (0, 1, 2, 3, 5, 6, 100, 101, 9_999, 20_000):
            want = np.asarray(j_sched(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(float(t_sched(step)), want, rtol=1e-6)


def test_adamw_matches_jax_over_five_steps():
    rng = np.random.default_rng(8)
    tree = dict(a=rng.normal(size=(6, 4)).astype(np.float32),
                b=[rng.normal(size=3).astype(np.float32),
                   dict(c=rng.normal(size=(2, 2)).astype(np.float32))])
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3
                                     ).astype(np.float32), tree)
             for _ in range(5)]
    j_opt = joptim.adamw(joptim.cosine_schedule(1e-2, 20, 2))
    t_opt = optim.adamw(optim.cosine_schedule(1e-2, 20, 2))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = optim.tree_map(lambda x: torch.tensor(x), tree)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for g in grads:
        jp, js = j_opt.apply(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.apply(optim.tree_map(torch.as_tensor, g), ts, tp)
    assert ts["step"] == int(js["step"]) == 5
    for a, b in zip(optim.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    norm_t = optim.global_norm(optim.tree_map(torch.as_tensor, grads[0]))
    norm_j = joptim.global_norm(jax.tree.map(jnp.asarray, grads[0]))
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)


# --------------------------------------------------------------------- #
# Registry, specs, trainer
# --------------------------------------------------------------------- #
def test_registry_and_cell_dims_match_jax():
    entry = get_arch("graphsage-reddit")
    j_entry = j_get_arch("graphsage-reddit")
    assert [dataclasses.asdict(s) for s in entry.shapes] == \
        [dataclasses.asdict(s) for s in j_entry.shapes]
    for shape in entry.shapes:
        assert specs._gnn_shape_dims(shape) == jspecs._gnn_shape_dims(shape)
    cfg, params, dims = train.cell()
    assert (dims["n"], dims["e"]) == (169_984, 169_984)
    assert (cfg.d_feat, cfg.d_hidden, cfg.n_classes, cfg.n_layers,
            cfg.aggregator) == (602, 128, 41, 2, "mean")
    j_cfg = jspecs._gnn_cfg_for(j_entry, dims)
    assert specs._gnn_model_flops("graphsage-reddit", cfg, 169_984,
                                  169_984) == jspecs._gnn_model_flops(
        "graphsage-reddit", j_cfg, 169_984, 169_984)
    assert get_arch("psi-score").config().dataset == "twitter"
    assert get_arch("pna").family == "gnn"
    assert get_arch("mind").family == j_get_arch("mind").family == "recsys"


def test_unported_archs_name_their_roadmap_item_by_title():
    """No arch of the JAX package is left unported: every JAX arch id
    resolves in the port, to an entry of the same family and shapes."""
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS
    assert set(ARCHS) == set(J_ARCHS)
    for arch, j_entry in J_ARCHS.items():
        entry = get_arch(arch)
        assert entry.family == j_entry.family, arch
        assert [dataclasses.asdict(s) for s in entry.shapes] == \
            [dataclasses.asdict(s) for s in j_entry.shapes], arch


def test_reduced_trainer_matches_jax_trainer_losses(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "graphsage-reddit",
                                      "--steps", "5"])
    jtrain.main()
    want = [float(line.split()[-1]) for line in
            capsys.readouterr().out.splitlines() if line.startswith("[train]")]
    _, cfg, tree = _params()
    got = train.train_reduced(5, "cpu",
                              params=sage_params_from_numpy(tree,
                                                            device="cpu"),
                              log=lambda s: None)
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_train_cli_on_cpu_and_refusals(capsys):
    losses = train.main(["--arch", "graphsage-reddit", "--reduced",
                         "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.count("[train] step") == 3
    mind = train.main(["--arch", "mind", "--steps", "2", "--device", "cpu"])
    assert len(mind["losses"]) == 2 and all(np.isfinite(mind["losses"]))
    with pytest.raises(SystemExit, match="launch.serve"):
        train.main(["--arch", "psi-score", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "graphsage-reddit", "--steps", "1"])
