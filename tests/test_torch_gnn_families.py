"""The port's other GNN families (PNA, NequIP, EquiformerV2), Adafactor and
SGD, their specs, configs and trainer against the JAX package on the same
numpy-seeded inputs and the JAX package's own parameters.

Tolerances: at float64 (JAX at x64) the loss, every output and every
gradient leaf within 1e-10 (relative; sums taken in another order, the
port's aggregation through ``seg_mm``'s plain version); at float32 the
outputs at ``F32`` (rtol 2e-5 / atol 2e-6, the GraphSAGE slice's) and each
gradient leaf at relative L2 1e-4. A leaf whose true gradient is 0 (the
last bias of EquiformerV2's attention MLP: the segment softmax ignores a
shift of a head's logits) has a relative error of rounding noise, so each
leaf is held against the larger of its own norm and 1e-6 of the whole
gradient's. The reduced trainers' first 5 losses at relative 1e-3, as the
GraphSAGE slice's; SGD and Adafactor after 5 steps at rtol 1e-6.
"""
import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.graphs as tg
from repro import train as joptim
from repro.configs import get_arch as j_get_arch
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models.gnn import common as jcommon
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import nequip as jnq
from repro.models.gnn import pna as jpna
from repro_torch.configs import get_arch
from repro_torch.convert import gnn_params_from_numpy, sage_params_from_numpy
from repro_torch.launch import specs, train
from repro_torch.models.gnn import common, equiformer_v2, nequip, pna
from repro_torch.train import optim

F32 = dict(rtol=2e-5, atol=2e-6)
ARCHS = ["pna", "nequip", "equiformer-v2"]
JMODS = {"pna": jpna, "nequip": jnq, "equiformer-v2": jeq}
TMODS = {"pna": pna, "nequip": nequip, "equiformer-v2": equiformer_v2}


@contextlib.contextmanager
def _x64():
    """JAX at float64 for the duration."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _cfgs(arch, dtype):
    """(JAX config, port config) of ``arch``'s reduced config at ``dtype``
    (torch.float32 or torch.float64)."""
    cfg_j = j_get_arch(arch).config(reduced=True)
    cfg_t = get_arch(arch).config(reduced=True)
    assert {k: v for k, v in dataclasses.asdict(cfg_j).items()
            if k != "dtype"} == {k: v for k, v in dataclasses.asdict(
                cfg_t).items() if k != "dtype"}
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (dataclasses.replace(cfg_j, dtype=jdt),
            dataclasses.replace(cfg_t, dtype=dtype))


def _jax_batch(b: common.GraphBatch) -> jcommon.GraphBatch:
    """The JAX package's GraphBatch of the same arrays."""
    def a(t):
        return None if t is None else jnp.asarray(t.numpy())
    return jcommon.GraphBatch(
        n=b.n, x=a(b.x), src=a(b.src), dst=a(b.dst), pos=a(b.pos),
        node_mask=a(b.node_mask), graph_ids=a(b.graph_ids),
        n_graphs=b.n_graphs, labels=a(b.labels), seed_mask=a(b.seed_mask))


def _toy_batch(cfg, geometric):
    """A 48-node random graph padded to 56 nodes and 420 edges (sentinel
    edges and pad rows present)."""
    rng = np.random.default_rng(0)
    g = tg.erdos_renyi(48, 200, seed=1)
    x = rng.normal(size=(g.n, cfg.d_feat)).astype(np.float32)
    pos = (rng.normal(size=(g.n, 3)).astype(np.float32) * 2 if geometric
           else None)
    labels = (np.zeros(1, np.float32) if cfg.out_kind == "graph" else
              np.r_[rng.integers(0, cfg.n_classes, g.n), -np.ones(8, int)])
    b = common.batch_from_graph(g, x, labels=labels, pos=pos, device="cpu")
    return common.pad_graph_batch(b, 56, 420)


def _molecule_batch(cfg):
    """Six small molecules (10 atoms, 16 bonds) padded past their size;
    graph-level labels (PNA reads them as graph labels too)."""
    return train.molecule_batch(6, 10, 16, cfg.d_feat, "cpu", n_pad=64,
                                e_pad=200, seed=4)


def _z_batch(cfg):
    """Two molecules of :func:`_molecule_batch` with one bond each along
    ±z (atoms 0-1 and 10-11 stacked vertically: r̂ at a pole, where
    sin β/2 or cos β/2 is 0), padded with sentinel edges (r̂ = 0)."""
    b = _molecule_batch(cfg)
    pos = b.pos.clone()
    pos[1] = pos[0] + torch.tensor([0.0, 0.0, 1.3])
    pos[11] = pos[10] + torch.tensor([0.0, 0.0, -1.3])
    e = b.src.shape[0]
    src = np.concatenate([[0, 1, 10, 11], b.src.numpy()])
    dst = np.concatenate([[1, 0, 11, 10], b.dst.numpy()])
    order = np.argsort(dst, kind="stable")[:e]    # drops 4 sentinel edges
    src, dst = src[order], dst[order]
    assert int((dst == b.n).sum()) > 0
    return dataclasses.replace(
        b, pos=pos, src=torch.as_tensor(src, dtype=torch.int32),
        dst=torch.as_tensor(dst, dtype=torch.int32),
        agg=common.edge_agg(src, dst, b.n, device="cpu"))


BATCHES = {"toy": _toy_batch,
           "molecule": lambda cfg, geometric: _molecule_batch(cfg),
           "z-axis": lambda cfg, geometric: _z_batch(cfg)}


def _params(arch, cfg_j, seed=0):
    tree = jax.tree.map(np.asarray, JMODS[arch].init_params(
        cfg_j, jax.random.PRNGKey(seed)))
    return tree, gnn_params_from_numpy(tree, device="cpu")


def _graph_cfgs(arch, cfg_j, cfg_t, batch_name):
    """The molecule batches carry graph labels: PNA reads them with
    ``out_kind="graph"``."""
    if batch_name != "toy" and arch == "pna":
        return (dataclasses.replace(cfg_j, out_kind="graph", n_classes=1),
                dataclasses.replace(cfg_t, out_kind="graph", n_classes=1))
    return cfg_j, cfg_t


def _check_grads(got_tree, want_tree, tol):
    got = optim.tree_leaves(optim.tree_map(
        lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
        got_tree))
    want = [np.asarray(w, np.float64)
            for w in jax.tree_util.tree_leaves(want_tree)]
    assert len(got) == len(want)
    total = np.sqrt(sum(float(np.sum(w * w)) for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.linalg.norm(g.detach().numpy().astype(np.float64) - w)
        assert np.isfinite(g.detach().numpy()).all()
        assert err <= tol * max(np.linalg.norm(w), 1e-6 * total)


def _as_f64(b):
    return dataclasses.replace(
        b, x=b.x.double(), pos=None if b.pos is None else b.pos.double(),
        labels=(b.labels.double() if b.labels.is_floating_point()
                else b.labels))


def _jax_value_and_grad(arch, tree, bj, cfg_j):
    """JAX's (apply output, loss, gradient tree), in one compiled call."""
    mod = JMODS[arch]

    def loss_and_out(p, b):
        return mod.loss_fn(p, b, cfg_j), mod.apply(p, b, cfg_j)

    (loss, out), grads = jax.jit(jax.value_and_grad(
        loss_and_out, has_aux=True))(tree, bj)
    return np.asarray(out), float(loss), grads


# the geometric nets on the molecule batch with its bonds along ±z (a
# molecule batch besides), PNA on it without them (it reads no positions)
@pytest.mark.parametrize("arch,batch_name", [
    ("pna", "toy"), ("pna", "molecule"), ("nequip", "toy"),
    ("nequip", "z-axis"), ("equiformer-v2", "toy"),
    ("equiformer-v2", "z-axis")])
def test_apply_loss_and_grads_match_jax_f64(arch, batch_name):
    cfg_j, cfg_t = _cfgs(arch, torch.float64)
    cfg_j, cfg_t = _graph_cfgs(arch, cfg_j, cfg_t, batch_name)
    bt = _as_f64(BATCHES[batch_name](cfg_t, arch != "pna"))
    with _x64():
        tree, params = _params(arch, cfg_j)
        out_j, loss_j, grads_j = _jax_value_and_grad(arch, tree,
                                                     _jax_batch(bt), cfg_j)
    mod = TMODS[arch]
    out = mod.apply(params, bt, cfg_t)
    assert out.dtype == torch.float64 and np.isfinite(out_j).all()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-10,
                               atol=1e-10 * np.abs(out_j).max())
    loss = mod.loss_fn(params, bt, cfg_t)
    assert abs(loss.item() - loss_j) <= 1e-10 * abs(loss_j)
    loss.backward()
    _check_grads(params, grads_j, 1e-10)


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_position_gradient_at_the_poles(arch):
    """The port's gradient of the loss in the positions is finite with
    bonds along ±z and sentinel edges, and equals JAX's on every atom off
    those bonds. JAX's is NaN on the four atoms of the two bonds (its
    ``atan2`` at r̂ = ±ẑ; ROADMAP queue 3): no parameter gradient reaches
    the positions, so training is untouched."""
    cfg_j, cfg_t = _cfgs(arch, torch.float64)
    bt = _as_f64(_z_batch(cfg_t))
    with _x64():
        tree, params = _params(arch, cfg_j)
        bj = _jax_batch(bt)
        want = np.asarray(jax.jit(jax.grad(lambda p: JMODS[arch].loss_fn(
            tree, dataclasses.replace(bj, pos=p), cfg_j)))(bj.pos))
    pos = bt.pos.clone().requires_grad_()
    TMODS[arch].loss_fn(params, dataclasses.replace(bt, pos=pos),
                        cfg_t).backward()
    got = pos.grad.numpy()
    assert np.isfinite(got).all()
    bad = ~np.isfinite(want).all(axis=1)
    assert np.flatnonzero(bad).tolist() == [0, 1, 10, 11]
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=0,
                               atol=1e-10 * np.abs(want[~bad]).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_loss_and_grads_match_jax_f32(arch):
    cfg_j, cfg_t = _cfgs(arch, torch.float32)
    bt = _toy_batch(cfg_t, arch != "pna")
    tree, params = _params(arch, cfg_j, seed=1)
    out_j, loss_j, grads_j = _jax_value_and_grad(arch, tree, _jax_batch(bt),
                                                 cfg_j)
    mod = TMODS[arch]
    out = mod.apply(params, bt, cfg_t)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=F32["rtol"],
                               atol=F32["atol"] * max(1.0,
                                                      np.abs(out_j).max()))
    loss = mod.loss_fn(params, bt, cfg_t)
    assert abs(loss.item() - loss_j) <= 2e-5 * abs(loss_j)
    loss.backward()
    _check_grads(params, grads_j, 1e-4)


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_rotation_invariance(arch):
    """The port's version of the JAX test: the same graph, features and
    rotation (tests/test_models_gnn.py), float32."""
    cfg = get_arch(arch).config(reduced=True)
    rng = np.random.default_rng(2)
    g = tg.erdos_renyi(40, 160, seed=3)
    x = rng.normal(size=(g.n, cfg.d_feat)).astype(np.float32)
    pos = rng.normal(size=(g.n, 3)).astype(np.float32) * 2
    from repro_torch.models.gnn import so3
    D1 = so3.wigner_real(1, torch.tensor([1.1]), torch.tensor([0.4]))[0]
    M = np.array([[0., -1, 0], [0, 0, 1], [1, 0, 0]])
    R = np.linalg.inv(M) @ D1.numpy() @ M
    params = TMODS[arch].init_params(cfg, 4, device="cpu")
    outs = [TMODS[arch].apply(params, common.batch_from_graph(
        g, x, labels=np.zeros(1, np.float32), pos=p, device="cpu"), cfg
    ).detach() for p in (pos, (pos @ R.T).astype(np.float32))]
    scale = max(1e-3, float(outs[0].abs().max()))
    assert float((outs[0] - outs[1]).abs().max()) / scale < 1e-4


# ------------------------------------------------------------------- #
# The trainer
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_trainer_matches_jax_trainer_losses(arch, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--steps",
                                      "5"])
    jtrain.main()
    want = [float(line.split()[-1]) for line in
            capsys.readouterr().out.splitlines() if line.startswith("[train]")]
    cfg_j = j_get_arch(arch).config(reduced=True)
    tree = jax.tree.map(np.asarray, JMODS[arch].init_params(
        cfg_j, jax.random.PRNGKey(0)))
    got = train.train_reduced(5, "cpu", arch=arch,
                              params=gnn_params_from_numpy(tree,
                                                           device="cpu"),
                              log=lambda s: None)
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_reduced_on_cpu_and_device_rule(arch, capsys):
    losses = train.main(["--arch", arch, "--reduced", "--steps", "3",
                         "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert capsys.readouterr().out.count("[train] step") == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", arch, "--steps", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            TMODS[arch].init_params(get_arch(arch).config(), 0)


def test_train_cli_full_graph_sm_pna_on_cpu_and_refusals():
    run = train.main(["--arch", "pna", "--shape", "full_graph_sm", "--steps",
                      "2", "--device", "cpu"])
    assert len(run["losses"]) == 2 and all(np.isfinite(run["losses"]))
    b = run["batch"]
    assert (b.n, b.src.shape[0], b.x.shape[1]) == (4096, 22528, 1433)
    assert int(b.node_mask.sum()) == 2708
    assert b.agg.edge_ids.numel() == 2 * 10_556
    assert int((b.labels >= 0).sum()) == 2708 and int(b.labels.max()) < 7
    with pytest.raises(SystemExit, match="37 GB"):
        train.main(["--arch", "pna", "--shape", "ogb_products",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="no positions"):
        train.main(["--arch", "nequip", "--shape", "minibatch_lg",
                    "--device", "cpu"])


def test_molecule_cell_batch():
    cfg, _, dims = train.cell("equiformer-v2", "molecule")
    b = train.synthetic_molecules(cfg, "cpu")
    assert (b.n, b.src.shape[0], b.n_graphs) == (4096, 16384, 128)
    assert (dims["n"], dims["e"]) == (4096, 16384)
    assert b.x.shape == (4096, 16) and b.labels.shape == (128,)
    assert b.labels.dtype == torch.float32
    assert int(b.node_mask.sum()) == 3840
    real = b.dst < b.n
    assert int(real.sum()) == 16384
    gid = b.graph_ids.long()
    src, dst = b.src[real].long(), b.dst[real].long()
    assert bool((gid[src] == gid[dst]).all())            # bonds stay inside
    assert torch.equal(torch.bincount(gid[:3840]), torch.full((128,), 30))
    bond = (b.pos[src] - b.pos[dst]).norm(dim=-1)
    assert float(bond.max()) < 0.5 * cfg.cutoff
    for k in range(0, 128, 31):                          # no two atoms meet
        p = b.pos[k * 30:(k + 1) * 30]
        d = torch.cdist(p, p) + torch.eye(30) * 10
        assert float(d.min()) >= 1.0 - 1e-6
    # each bond in both directions
    pairs = set(zip(src.tolist(), dst.tolist()))
    assert all((d_, s_) in pairs for s_, d_ in pairs)


# ------------------------------------------------------------------- #
# Registry, configs, specs, conversion
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_jax(arch, reduced):
    a = dataclasses.asdict(get_arch(arch).config(reduced=reduced))
    b = dataclasses.asdict(j_get_arch(arch).config(reduced=reduced))
    assert a.pop("dtype") == torch.float32 and b.pop("dtype") == jnp.float32
    assert a == b
    assert [dataclasses.asdict(s) for s in get_arch(arch).shapes] == \
        [dataclasses.asdict(s) for s in j_get_arch(arch).shapes]


@pytest.mark.parametrize("arch", ARCHS + ["graphsage-reddit"])
@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_specs_match_jax(arch, shape):
    entry, j_entry = get_arch(arch), j_get_arch(arch)
    dims = specs._gnn_shape_dims(entry.shape(shape))
    assert dims == jspecs._gnn_shape_dims(
        next(s for s in j_entry.shapes if s.name == shape))
    cfg, j_cfg = specs._gnn_cfg_for(entry, dims), jspecs._gnn_cfg_for(
        j_entry, dims)
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(j_cfg)
    a.pop("dtype"), b.pop("dtype")
    assert a == b
    assert specs._gnn_model_flops(arch, cfg, dims["n"], dims["e"]) == \
        jspecs._gnn_model_flops(arch, j_cfg, dims["n"], dims["e"])
    assert (arch in specs._GEOMETRIC) == (arch in jspecs._GEOMETRIC)
    assert specs._GNN_MODS[arch].__name__.rsplit(".", 1)[1] == \
        jspecs._GNN_MODS[arch].__name__.rsplit(".", 1)[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_params_from_numpy_keeps_the_tree(arch):
    cfg_j, cfg_t = _cfgs(arch, torch.float32)
    tree, params = _params(arch, cfg_j)
    leaves = optim.tree_leaves(params)
    want = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.requires_grad and a.dtype == torch.float32
        assert np.array_equal(a.detach().numpy(), b)
    ours = optim.tree_leaves(TMODS[arch].init_params(cfg_t, 0,
                                                     device="cpu"))
    assert [tuple(a.shape) for a in ours] == [b.shape for b in want]
    sage_tree = {"layers": [], "head": {"w": np.ones((2, 3), np.float32),
                                        "b": np.zeros(3, np.float32)}}
    assert sage_params_from_numpy(sage_tree, device="cpu")["head"][
        "w"].shape == (2, 3)


# ------------------------------------------------------------------- #
# SGD and Adafactor
# ------------------------------------------------------------------- #
def _opt_tree(rng):
    """A factored leaf (both trailing dims ≥ 8), a batched factored leaf,
    a narrow matrix and a vector."""
    return dict(w=rng.normal(size=(12, 9)).astype(np.float32),
                stack=rng.normal(size=(2, 8, 10)).astype(np.float32),
                layers=[dict(n=rng.normal(size=(4, 16)).astype(np.float32)),
                        rng.normal(size=7).astype(np.float32)])


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", dict(momentum=0.5, clip_norm=1.0)),
    ("adafactor", {}), ("adafactor", dict(weight_decay=0.1, clip_norm=None,
                                          clip_threshold=0.5))])
def test_optimizer_matches_jax_over_five_steps(name, kw):
    rng = np.random.default_rng(9)
    tree = _opt_tree(rng)
    grads = [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3
                                     ).astype(np.float32), tree)
             for _ in range(5)]
    j_opt = getattr(joptim, name)(joptim.cosine_schedule(1e-2, 20, 2), **kw)
    t_opt = getattr(optim, name)(optim.cosine_schedule(1e-2, 20, 2), **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = optim.tree_map(lambda x: torch.tensor(x), tree)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    if name == "adafactor":
        for a, b in zip(optim.tree_leaves(ts["stats"]),
                        jax.tree_util.tree_leaves(js["stats"])):
            assert tuple(a.shape) == b.shape
        assert set(ts["stats"]["w"]) == {"vr", "vc"}
        assert set(ts["stats"]["layers"][0]["n"]) == {"v"}
    for g in grads:
        jp, js = j_opt.apply(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = t_opt.apply(optim.tree_map(torch.as_tensor, g), ts, tp)
    assert ts["step"] == int(js["step"]) == 5
    for a, b in zip(optim.tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    state_j = js["m"] if name == "sgd" else js["stats"]
    state_t = ts["m"] if name == "sgd" else ts["stats"]
    for a, b in zip(optim.tree_leaves(state_t),
                    jax.tree_util.tree_leaves(state_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adafactor_trains_equiformer_params_in_place():
    cfg = get_arch("equiformer-v2").config(reduced=True)
    params = equiformer_v2.init_params(cfg, 0, device="cpu")
    batch = train.reduced_batch(cfg, "cpu", geometric=True)
    opt = optim.adafactor(optim.constant_schedule(1e-2))
    state = opt.init(params)
    leaves = optim.tree_leaves(params)
    losses = []
    for _ in range(3):
        params, state, loss = train.train_step(params, state, batch, cfg,
                                               opt, equiformer_v2)
        losses.append(float(loss))
    assert optim.tree_leaves(params)[0] is leaves[0]   # written in place
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
