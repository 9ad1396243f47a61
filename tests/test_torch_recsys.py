"""The port's recsys family (MIND and its embedding substrate) against the
JAX package on the same inputs.

The JAX side runs under a (1, 1) mesh built with ``axis_types=(AxisType.
Auto,) * 2``: under jax 0.9 a plain ``jax.make_mesh`` makes Explicit axes,
on which the JAX train step's gradient raises (that, not the model, is why
the JAX package's ``test_train_converges`` fails here). Inputs come from
numpy seeds; JAX parameters go across with ``mind_params_from_jax``.

Tolerances (relative to the largest entry, or relative L2 for a gradient
leaf): ``embedding_bag`` ≤ 1e-12 at f64 and ≤ 1e-6 at f32; interests,
loss and every gradient ≤ 1e-10 at f64 (JAX at x64) and ≤ 1e-5 at f32;
retrieval scores ≤ 1e-5 (the JAX test's own); the reduced trainer's 15
losses within rel 1e-4 of the JAX step's.
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as j_get_arch
from repro.launch import specs as jspecs
from repro.models.recsys import embedding as jemb
from repro.models.recsys import mind as jmind
from repro.train import adamw as j_adamw
from repro.train import constant_schedule as j_constant
from repro.train import cosine_schedule as j_cosine
from repro_torch.configs import get_arch
from repro_torch.convert import mind_params_from_jax
from repro_torch.launch import serve, specs, train
from repro_torch.models.recsys import embedding, mind
from repro_torch.train.optim import adamw, constant_schedule

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}
B = 8


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@contextlib.contextmanager
def _x64(on: bool = True):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def _cfgs(dtype):
    jcfg = dataclasses.replace(j_get_arch("mind").config(reduced=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_arch("mind").config(reduced=True),
                               dtype=TORCH_DTYPE[dtype])
    return jcfg, tcfg


def _setup(dtype, seed=0):
    """(JAX config, port config, JAX params, port params, host batch): the
    reduced config at ``dtype``, JAX's ``init_params(PRNGKey(0))`` carried
    across, the JAX test's batch (numpy seed ``seed``, 8 users, 4 tags)."""
    jcfg, tcfg = _cfgs(dtype)
    jp = _jinit(jcfg, jax.random.PRNGKey(0))
    tp = mind_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    hb = train.recsys_host_batch(tcfg, B, np.random.default_rng(seed),
                                 tags=4)
    return jcfg, tcfg, jp, tp, hb


# the JAX functions, compiled (op by op a reduced value_and_grad takes ~13 s
# here); the config and the mesh are static
_jinit = jax.jit(jmind.init_params, static_argnums=0)
_jinterests = jax.jit(jmind.user_interests, static_argnums=(5, 6))
_jvalue_and_grad = jax.jit(jax.value_and_grad(jmind.train_loss),
                           static_argnums=(2, 3))


def _jbatch(hb):
    return {k: jnp.asarray(v) for k, v in hb.items()}


# --------------------------------------------------------------------- #
# embedding_bag
# --------------------------------------------------------------------- #
def _bag_inputs(seed=3, v=50, d=8, n_bags=12):
    """Ragged bags with sentinels (= v), ids above the sentinel, empty
    bags (including the last ones) and a bag of sentinels only."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 6, n_bags)
    sizes[[2, n_bags - 1]] = 0
    bags = np.repeat(np.arange(n_bags), sizes)
    ids = rng.integers(0, v, bags.size)
    ids[rng.random(bags.size) < 0.2] = v
    ids[3] = v + 4
    sentinel_bag = int(np.flatnonzero(sizes)[0])
    ids[bags == sentinel_bag] = v
    table = rng.normal(size=(v, d))
    return table, ids, bags, n_bags, sentinel_bag


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_embedding_bag_matches_jax(mode, dtype):
    """Forward and the table's gradient (of a weighted sum) against JAX."""
    table, ids, bags, n_bags, sentinel_bag = _bag_inputs()
    tdt = TORCH_DTYPE[dtype]
    w = np.random.default_rng(4).normal(size=(n_bags, table.shape[1]))
    with _x64(dtype == jnp.float64):
        jt = jnp.asarray(table, dtype)

        def f(t):
            return jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(bags),
                                      n_bags, mode=mode)

        want = np.asarray(f(jt))
        want_g = np.asarray(jax.grad(lambda t: jnp.sum(
            f(t) * jnp.asarray(w, dtype)))(jt))
    tt = torch.tensor(table, dtype=tdt, requires_grad=True)
    got = embedding.embedding_bag(tt, torch.as_tensor(ids),
                                  torch.as_tensor(bags), n_bags, mode=mode)
    (got * torch.as_tensor(w, dtype=tdt)).sum().backward()
    tol = 1e-12 if dtype == jnp.float64 else 1e-6
    assert got.dtype == tdt and got.shape == want.shape
    assert _rel(got.detach(), want) <= tol
    assert _rel(tt.grad, want_g) <= tol
    assert not got[sentinel_bag].any() and not got[2].any()
    assert not got[n_bags - 1].any()


def test_embedding_bag_layout_built_once_equals_built_per_call():
    """A layout built on the host once gives the same bits as the one the
    call builds itself; every bag's divisor is its count of valid ids."""
    table, ids, bags, n_bags, _ = _bag_inputs(seed=5)
    tt = torch.tensor(table)
    lay = embedding.bag_layout(ids, bags, n_bags, table.shape[0],
                               device="cpu")
    want_cnt = np.bincount(bags[ids < table.shape[0]], minlength=n_bags)
    assert np.array_equal(lay.in_degree.numpy(), want_cnt)
    a = embedding.embedding_bag(tt, torch.as_tensor(ids),
                                torch.as_tensor(bags), n_bags, layout=lay)
    b = embedding.embedding_bag(tt, torch.as_tensor(ids),
                                torch.as_tensor(bags), n_bags)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        embedding.embedding_bag(tt, torch.as_tensor(ids),
                                torch.as_tensor(bags), n_bags, mode="max")


def test_embedding_bag_modes():
    """The JAX package's ``test_embedding_bag_modes``, on the port."""
    tbl = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    ids = torch.tensor([0, 1, 10, 5])       # 10 = sentinel
    bags = torch.tensor([0, 0, 1, 2])
    s = embedding.embedding_bag(tbl, ids, bags, 3, mode="sum")
    m = embedding.embedding_bag(tbl, ids, bags, 3, mode="mean")
    np.testing.assert_allclose(s[0].numpy(), (tbl[0] + tbl[1]).numpy())
    np.testing.assert_allclose(m[0].numpy(), ((tbl[0] + tbl[1]) / 2).numpy())
    np.testing.assert_allclose(s[1].numpy(), 0.0)   # sentinel-only bag


def test_sharded_lookup_without_a_mesh_is_the_plain_gather():
    rng = np.random.default_rng(6)
    table = torch.tensor(rng.normal(size=(64, 8)), requires_grad=True)
    ids = torch.as_tensor(rng.integers(0, 64, (8, 3)))
    out = embedding.sharded_lookup(table, ids)
    assert torch.equal(out, table[ids])
    params = {k: torch.ones(4, 2, requires_grad=True)
              for k in ("item_emb", "b_init")}
    shard = mind.shard_params(params, None)
    assert all(torch.equal(shard[k], params[k]) and shard[k].is_leaf
               and shard[k].requires_grad for k in params)


# --------------------------------------------------------------------- #
# MIND against the JAX functions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_interests_loss_and_grads_match_jax(jmesh, dtype):
    tol = 1e-10 if dtype == jnp.float64 else 1e-5
    with _x64(dtype == jnp.float64):
        jcfg, tcfg, jp, tp, hb = _setup(dtype)
        jb = _jbatch(hb)
        ju = np.asarray(_jinterests(
            jp, jb["hist_ids"], jb["hist_mask"], jb["profile_ids"],
            jb["profile_bags"], jcfg, jmesh))
        jloss, jgrads = _jvalue_and_grad(jp, jb, jcfg, jmesh)
        jgrads = jax.tree.map(np.asarray, jgrads)
    tb = train.recsys_device_batch(hb, tcfg, "cpu")
    tu = mind.user_interests(tp, tb["hist_ids"], tb["hist_mask"],
                             tb["profile_ids"], tb["profile_bags"], tcfg,
                             profile_layout=tb["profile_layout"])
    assert tu.shape == (B, tcfg.n_interests, tcfg.embed_dim)
    assert tu.dtype == TORCH_DTYPE[dtype]
    assert _rel(tu.detach(), ju) <= tol
    loss, grads = mind.loss_and_grads(tp, tb, tcfg)
    assert abs(float(loss) - float(jloss)) <= tol * abs(float(jloss))
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        assert g.dtype == TORCH_DTYPE[dtype]
        if k == "b_init":
            assert not g.any() and not np.any(jgrads[k])
        else:
            assert _rel_l2(g, jgrads[k]) <= tol, k


def test_fully_masked_history_stays_finite(jmesh):
    """The JAX test's ``test_capsule_routing_mask``: a history masked out
    everywhere gives finite interests, loss and gradients, as JAX's."""
    jcfg, tcfg, jp, tp, hb = _setup(jnp.float32)
    hb["hist_mask"][:] = False
    jb = _jbatch(hb)
    ju = np.asarray(_jinterests(
        jp, jb["hist_ids"], jb["hist_mask"], jb["profile_ids"],
        jb["profile_bags"], jcfg, jmesh))
    tb = train.recsys_device_batch(hb, tcfg, "cpu")
    tu = mind.user_interests(tp, tb["hist_ids"], tb["hist_mask"],
                             tb["profile_ids"], tb["profile_bags"], tcfg)
    assert torch.isfinite(tu).all() and _rel(tu.detach(), ju) <= 1e-5
    loss, grads = mind.loss_and_grads(tp, tb, tcfg)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert not grads["bilinear"].any()      # no history reaches ê


def test_retrieval_scores_match_jax_and_per_interest_max(jmesh):
    jcfg, tcfg, jp, tp, hb = _setup(jnp.float32)
    jb = _jbatch(hb)
    ju = _jinterests(jp, jb["hist_ids"], jb["hist_mask"],
                     jb["profile_ids"], jb["profile_bags"], jcfg, jmesh)
    cands = np.arange(jcfg.n_items)
    want = np.asarray(jmind.retrieval_scores(jp, ju[0], jnp.asarray(cands),
                                             jcfg, jmesh))
    got = mind.retrieval_scores(tp, torch.tensor(np.asarray(ju[0])),
                                torch.as_tensor(cands), tcfg).detach()
    assert got.shape == (jcfg.n_items,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    per = tp["item_emb"].detach().numpy() @ np.asarray(ju[0]).T
    np.testing.assert_allclose(got.numpy(), per.max(axis=1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_reduced_trainer_matches_jax_step_losses(jmesh, schedule):
    """15 AdamW steps on the JAX test's batch from the same parameters,
    JAX's under an Auto mesh: at a constant 1e-2 (the step the JAX
    ``test_train_converges`` runs) through the port's ``recsys_step``, and
    at the JAX launcher's ``cosine_schedule(1e-2, 15, 2)`` through the
    port's reduced trainer."""
    jcfg, tcfg, jp, tp, hb = _setup(jnp.float32)
    opt = j_adamw(j_constant(1e-2) if schedule == "constant"
                  else j_cosine(1e-2, 15, 2))
    state = opt.init(jp)

    @jax.jit
    def step(p, st, b):
        loss, g = jax.value_and_grad(jmind.train_loss)(p, b, jcfg, jmesh)
        p, st = opt.apply(g, st, p)
        return p, st, loss

    want, p, jb = [], jp, _jbatch(hb)
    for _ in range(15):
        p, state, loss = step(p, state, jb)
        want.append(float(loss))
    if schedule == "cosine":
        got = train.train_recsys("mind", 15, "cpu", params=tp,
                                 log=lambda s: None)["losses"]
    else:
        topt = adamw(constant_schedule(1e-2))
        tstate, b, got = topt.init(tp), train.recsys_device_batch(
            hb, tcfg, "cpu"), []
        for _ in range(15):
            tp, tstate, loss = train.recsys_step(tp, tstate, b, tcfg, topt)
            got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and np.isfinite(got[-1])


def test_serve_loop_matches_jax_top5(jmesh, capsys):
    """``serve --arch mind``'s requests on JAX's parameters: the same top-5
    candidate indices as the JAX launcher's loop (seed 2, 4 users, 4 tags,
    1,000 candidates), run here under the Auto mesh."""
    jcfg, tcfg, jp, tp, _ = _setup(jnp.float32)
    rng = np.random.default_rng(2)
    interests = jax.jit(lambda p, h, m, i, b: jmind.user_interests(
        p, h, m, i, b, jcfg, jmesh))
    score = jax.jit(lambda p, u, c: jmind.retrieval_scores(p, u, c, jcfg,
                                                           jmesh))
    want = []
    for _ in range(2):
        hist = jnp.asarray(rng.integers(0, jcfg.n_items, (4, jcfg.hist_len)))
        mask = jnp.asarray(rng.random((4, jcfg.hist_len)) > 0.2)
        pids = jnp.asarray(rng.integers(0, jcfg.n_profile, (16,)))
        bags = jnp.asarray(np.repeat(np.arange(4), 4))
        u = interests(jp, hist, mask, pids, bags)
        cands = jnp.asarray(rng.integers(0, jcfg.n_items, (1000,)))
        want.append(np.asarray(jnp.argsort(-score(jp, u[0], cands))[:5]))
    out = serve.serve_recsys("mind", 2, "cpu", params=tp)
    assert [t.tolist() for t in want] == [
        json.loads(line.split("items ")[1].split(" (")[0]) for line in
        capsys.readouterr().out.splitlines() if line.startswith("[serve]")]
    assert out["top"].tolist() == want[-1].tolist()


# --------------------------------------------------------------------- #
# Registry, configs, cell sizing, the CLIs
# --------------------------------------------------------------------- #
def test_registry_configs_and_specs_match_jax(jmesh):
    te, je = get_arch("mind"), j_get_arch("mind")
    assert te.family == je.family == "recsys"
    assert [dataclasses.asdict(s) for s in te.shapes] == \
        [dataclasses.asdict(s) for s in je.shapes]
    for reduced in (False, True):
        td = dataclasses.asdict(te.config(reduced=reduced))
        jd = dataclasses.asdict(je.config(reduced=reduced))
        assert td.pop("dtype") == TORCH_DTYPE[jd.pop("dtype")]
        assert td == jd
    for shape in te.shapes:
        cell = specs.build_recsys_cell(te, shape)
        jcell = jspecs.build_recsys_cell(je, shape, jmesh)
        assert cell.meta == jcell.meta, shape.name
        jstructs = (jcell.args[2] if shape.kind == "train"
                    else dict(zip(cell.batch, jcell.args[1:])))
        for k, (shp, dt) in cell.batch.items():
            assert tuple(jstructs[k].shape) == shp, (shape.name, k)
            assert str(jstructs[k].dtype) == str(dt).removeprefix("torch.")


def test_train_and_serve_cli_on_cpu_and_refusals(capsys):
    run = train.main(["--arch", "mind", "--steps", "3", "--device", "cpu"])
    assert len(run["losses"]) == 3 and all(np.isfinite(run["losses"]))
    assert capsys.readouterr().out.count("[train] step") == 3
    out = serve.main(["--arch", "mind", "--device", "cpu"])
    assert len(out["ms"]) == 4
    assert capsys.readouterr().out.count("[serve] req") == 4
    with pytest.raises(SystemExit, match="launch.serve"):
        train.main(["--arch", "mind", "--shape", "serve_p99",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="has no shape"):
        serve.main(["--arch", "mind", "--shape", "prefill_32k",
                    "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "mind", "--steps", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", "mind", "--requests", "1"])


def test_shape_branches_on_a_patched_cell(monkeypatch, capsys):
    """``train --shape train_batch`` and ``serve --shape serve_p99 |
    serve_bulk | retrieval_cand`` with the registry's ``mind`` config
    patched to the reduced one (the full tables are for the card), the
    batch cut to 16 users: each prints its metric line and its cut."""
    import repro_torch.configs.mind as cmind
    small = cmind.config(reduced=True)
    monkeypatch.setattr(cmind, "config", lambda reduced=False: small)
    run = train.main(["--arch", "mind", "--shape", "train_batch",
                      "--batch", "16", "--steps", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "cut: batch 65536 -> 16" in text and len(run["losses"]) == 2
    assert run["batch"]["neg_ids"].shape == (16, small.n_neg)
    assert run["batch"]["profile_ids"].shape == (16 * small.profile_tags,)
    for shape in ("serve_p99", "serve_bulk"):
        out = serve.main(["--arch", "mind", "--shape", shape, "--batch",
                          "16", "--requests", "1", "--device", "cpu"])
        text = capsys.readouterr().out
        assert "interests of 16 users" in text and "users/s" in text
        assert out["interests"].shape == (16, small.n_interests,
                                          small.embed_dim)
    out = serve.main(["--arch", "mind", "--shape", "retrieval_cand",
                      "--requests", "1", "--device", "cpu"])
    assert "scored 1000000 candidates" in capsys.readouterr().out
    assert out["scores"].shape == (1_000_000,)
    # candidates repeat (10^6 draws of 2,048 items): held by value
    best = torch.sort(out["scores"], descending=True).values[:5]
    assert torch.equal(out["scores"][torch.as_tensor(out["top"])], best)
