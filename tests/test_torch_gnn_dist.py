"""The GNN families on a batch split over the data ranks
(``repro_torch.models.gnn.parallel``), on 8 gloo ranks, against world 1 and
the JAX package.

One ``mp.spawn`` of 8 ranks (``file://`` rendezvous in a temporary
directory) runs every case on an ``(8, 1)`` and a ``(2, 4)`` mesh at
float64 and on the ``(2, 4)`` mesh at float32 (a collective of 8 ranks
waits for the slowest, and under the suite's load each run costs seconds):
two AdamW steps (constant learning rate, the clip
and the weight decay on) of the reduced config of each family on a
``full_graph`` batch (:func:`repro_torch.launch.train.full_graph_shard`,
each rank drawing only its shard), NequIP on a batch of molecules and
GraphSAGE on a batch with a ``seed_mask`` (each rank's shard cut by
:func:`~repro_torch.models.gnn.parallel.shard_batch`). The sizes are
chosen so that every split occurs: PNA's 60 nodes do not split over 8
ranks (its nodes whole on every rank, its edges split), NequIP's 388 edges
do not split over 8 (its edges whole, its nodes split), the rest split
both ways.

* The two losses and every parameter equal world 1's (``mesh=None`` on the
  whole batch): the losses within 1e-10 relative at float64 and 1e-5 at
  float32; the parameters the same (relative to the larger of 1 and the
  leaf's largest entry; the worst seen 2.9e-13 and 9.2e-7). At float32 a
  leaf whose true gradient is 0, EquiformerV2's last attention bias (a
  shift of a head's logits leaves the softmax as it is), holds rounding
  noise in its gradient, in both runs, which AdamW's normalisation turns
  into a step of up to the learning rate: that leaf is held to the
  learning rate (1.2e-4 seen).
* The float64 losses equal the JAX package's ``loss_fn`` and
  ``optim.adamw`` at x64 on the same parameters (carried across with
  ``repro_torch.convert``) and the whole batch, within
  ``tests/test_torch_gnn_families.py``'s float64 tolerance (1e-10
  relative; the float32 forward against JAX is that file's). JAX runs in a
  subprocess beside the ranks: its compiles are the file's critical path.
* ``mesh=(1, 1)`` gives the bits of ``mesh=None``.
* A full graph's shards, drawn rank by rank, are the whole graph's rows and
  edges, as :func:`shard_batch` cuts them.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import nequip as jnq
from repro.models.gnn import pna as jpna
from repro.models.gnn import sage as jsage
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn import parallel
from repro_torch.train import optim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"8x1": (8, 1), "2x4": (2, 4)}
DTYPES = ("float64", "float32")
# the (mesh, dtype) runs of every case on the ranks
RUNS = (("8x1", "float64"), ("2x4", "float64"), ("2x4", "float32"))
LOSS_TOL = {"float64": 1e-10, "float32": 1e-5}
PARAM_TOL = {"float64": 1e-10, "float32": 1e-5}
JAX_RTOL = 1e-10
JMODS = {"graphsage-reddit": jsage, "pna": jpna, "nequip": jnq,
         "equiformer-v2": jeq}

_COMMON = """
import dataclasses
import numpy as np
import torch

LR = 1e-3
# name, arch, batch kind, padded nodes, padded edges
CASES = [("sage", "graphsage-reddit", "full", 64, 384),
         ("pna", "pna", "full", 60, 384),
         ("nequip", "nequip", "full", 64, 388),
         ("equiformer", "equiformer-v2", "full", 64, 384),
         ("nequip_mol", "nequip", "molecule", 64, 200),
         ("sage_seed", "graphsage-reddit", "seed", 64, 384)]
GEOMETRIC = ("nequip", "equiformer-v2")


def cfg_kw(arch, kind):
    if kind == "molecule":
        return dict(out_kind="graph", n_classes=1, d_feat=16)
    return dict(out_kind="node_class" if arch in GEOMETRIC else "node",
                n_classes=5, d_feat=12)


def port_cfg(arch, kind, dtype):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).config(reduced=True),
                               dtype=getattr(torch, dtype),
                               **cfg_kw(arch, kind))


def as_dtype(b, dtype):
    dt = getattr(torch, dtype)
    return dataclasses.replace(
        b, x=b.x.to(dt), pos=None if b.pos is None else b.pos.to(dt),
        labels=(b.labels.to(dt) if b.labels.is_floating_point()
                else b.labels))


def batch(case, cfg, dtype, mesh=None):
    # the case's batch: the whole one (mesh None) or this rank's shard
    from repro_torch.launch import train
    from repro_torch.models.gnn.parallel import shard_batch
    name, arch, kind, n, e = case
    if kind == "molecule":
        b = shard_batch(train.molecule_batch(6, 10, 16, cfg.d_feat, "cpu",
                                             n_pad=n, e_pad=e, seed=4), mesh)
    elif kind == "full":
        b = train.full_graph_shard(n - 8, e - 40, n, e, cfg.d_feat,
                                   cfg.n_classes, "cpu", mesh=mesh,
                                   geometric=arch in GEOMETRIC, seed=11)
    else:                                   # seeds: a fifth of the nodes
        b = train.full_graph_shard(n - 8, e - 40, n, e, cfg.d_feat,
                                   cfg.n_classes, "cpu", seed=11)
        seeds = np.zeros(n, bool)
        seeds[np.random.default_rng(12).choice(n - 8, 12, replace=False)] = 1
        b = shard_batch(dataclasses.replace(b, seed_mask=torch.as_tensor(
            seeds)), mesh)
    return as_dtype(b, dtype)


def two_steps(case, dtype, tree, mesh=None):
    # two AdamW steps from the JAX parameters `tree` (numpy);
    # -> (losses, parameter leaves as numpy)
    from repro_torch.convert import gnn_params_from_numpy
    from repro_torch.launch import specs, train
    from repro_torch.train import optim
    name, arch, kind, n, e = case
    cfg = port_cfg(arch, kind, dtype)
    params = gnn_params_from_numpy(tree, dtype=getattr(torch, dtype),
                                   device="cpu")
    b = batch(case, cfg, dtype, mesh)
    opt = optim.adamw(optim.constant_schedule(LR))
    state = opt.init(params)
    losses = []
    for _ in range(2):
        params, state, loss = train.train_step(
            params, state, b, cfg, opt, specs._GNN_MODS[arch], mesh)
        losses.append(float(loss))
    return losses, [p.detach().numpy() for p in optim.tree_leaves(params)]
"""

_RANK_SCRIPT = _COMMON + """
import json, pickle, sys
import torch.distributed as dist
import torch.multiprocessing as mp
MESHES, RUNS = %r, %r


def rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/pg",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_mesh
    with open(tmp + "/params.pkl", "rb") as fh:
        trees = pickle.load(fh)
    arrays, res = {}, {}
    for mname, shape in MESHES.items():
        mesh = make_mesh(tuple(shape), device="cpu")
        for case in CASES:
            for dtype in [dt for m, dt in RUNS if m == mname]:
                tag = "%%s/%%s/%%s" %% (mname, case[0], dtype)
                losses, leaves = two_steps(case, dtype, trees[case[0]], mesh)
                res[tag] = losses
                for i, x in enumerate(leaves):
                    arrays[tag + "/%%d" %% i] = x
        mesh.close()
    np.savez(tmp + "/rank%%d.npz" %% rank, **arrays)
    with open(tmp + "/rank%%d.json" %% rank, "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8, sys.argv[1]), nprocs=8, join=True)
""" % (MESHES, RUNS)

_JAX_SCRIPT = _COMMON + """
import json, pickle, sys
import jax
import jax.numpy as jnp
from repro import train as joptim
from repro.configs import get_arch as j_get_arch
from repro.models.gnn import common as jcommon
from repro.models.gnn import equiformer_v2, nequip, pna, sage
JMODS = {"graphsage-reddit": sage, "pna": pna, "nequip": nequip,
         "equiformer-v2": equiformer_v2}


def jax_batch(b):
    def a(t):
        return None if t is None else jnp.asarray(t.numpy())
    return jcommon.GraphBatch(
        n=b.n, x=a(b.x), src=a(b.src), dst=a(b.dst), pos=a(b.pos),
        node_mask=a(b.node_mask), graph_ids=a(b.graph_ids),
        n_graphs=b.n_graphs, labels=a(b.labels), seed_mask=a(b.seed_mask))


def jax_losses(case, dtype, tree):
    # two steps of the JAX package's loss_fn and optim.adamw
    name, arch, kind, n, e = case
    cfg = dataclasses.replace(
        j_get_arch(arch).config(reduced=True),
        dtype=jnp.float64 if dtype == "float64" else jnp.float32,
        **cfg_kw(arch, kind))
    bj = jax_batch(batch(case, port_cfg(arch, kind, dtype), dtype))
    params = jax.tree.map(lambda x: jnp.asarray(x, cfg.dtype), tree)
    opt = joptim.adamw(joptim.constant_schedule(LR))
    state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bt: JMODS[arch].loss_fn(p, bt, cfg)))
    losses = []
    for _ in range(2):
        loss, grads = grad_fn(params, bj)
        params, state = opt.apply(grads, state, params)
        losses.append(float(loss))
    return losses


tmp = sys.argv[1]
with open(tmp + "/params.pkl", "rb") as fh:
    trees = pickle.load(fh)
jax.config.update("jax_enable_x64", True)
out = {case[0]: jax_losses(case, "float64", trees[case[0]])
       for case in CASES}
with open(tmp + "/jax.json", "w") as fh:
    json.dump(out, fh)
"""

_NS: dict = {}
exec(_COMMON, _NS)
CASES = _NS["CASES"]
CASE = {c[0]: c for c in CASES}


def _jax_cfg(arch, kind, dtype):
    return dataclasses.replace(
        j_get_arch(arch).config(reduced=True),
        dtype=jnp.float64 if dtype == "float64" else jnp.float32,
        **_NS["cfg_kw"](arch, kind))


def _jax_params(case):
    """The JAX package's parameters of the case's config, as numpy."""
    _, arch, kind, _, _ = case
    cfg = _jax_cfg(arch, kind, "float32")
    return jax.tree.map(np.asarray, JMODS[arch].init_params(
        cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trees():
    return {c[0]: _jax_params(c) for c in CASES}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """Every case on the 8 gloo ranks, beside the JAX package's float64
    run of every case in a subprocess (one thread each); → (per rank
    (losses, arrays), JAX losses)."""
    tmp = str(tmp_path_factory.mktemp("gnn8"))
    with open(os.path.join(tmp, "params.pkl"), "wb") as fh:
        pickle.dump(trees, fh)
    paths = {}
    for key, text in (("ranks", _RANK_SCRIPT), ("jax", _JAX_SCRIPT)):
        paths[key] = os.path.join(tmp, key + "_run.py")
        with open(paths[key], "w") as fh:
            fh.write(textwrap.dedent(text))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    jproc = subprocess.Popen([sys.executable, paths["jax"], tmp], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        proc = subprocess.run([sys.executable, paths["ranks"], tmp], env=env,
                              capture_output=True, text=True, timeout=600)
        _, jerr = jproc.communicate(timeout=600)
    finally:
        jproc.kill()
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert jproc.returncode == 0, jerr[-4000:]
    out = []
    for r in range(8):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            res = json.load(fh)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            out.append((res, {k: z[k] for k in z.files}))
    with open(os.path.join(tmp, "jax.json")) as fh:
        return out, json.load(fh)


@pytest.fixture(scope="module")
def world1(trees):
    """The one-device run of every case and dtype."""
    return {(c[0], dt): _NS["two_steps"](c, dt, trees[c[0]])
            for c in CASES for dt in DTYPES}


def _close(got, want, tol, what):
    assert abs(got - want) <= tol * abs(want), (what, got, want)


@pytest.mark.parametrize("name", list(CASE))
@pytest.mark.parametrize("mname,dtype", RUNS)
def test_gloo8_split_steps_equal_world1(runs, world1, mname, dtype, name):
    want_losses, want_leaves = world1[(name, dtype)]
    tag = f"{mname}/{name}/{dtype}"
    lr_leaf = [False] * len(want_leaves)
    if dtype == "float32" and name == "equiformer":
        # the attention MLP's last bias: a zero true gradient (a shift of a
        # head's logits leaves the softmax as it is)
        cfg = _NS["port_cfg"]("equiformer-v2", "full", dtype)
        from repro_torch.models.gnn import equiformer_v2
        tree = equiformer_v2.init_params(cfg, 0, device="cpu")
        ids = {id(lp["alpha"][-1]["b"]) for lp in tree["layers"]}
        lr_leaf = [id(p) in ids for p in optim.tree_leaves(tree)]
    for res, arrays in runs[0]:
        for got, want in zip(res[tag], want_losses):
            _close(got, want, LOSS_TOL[dtype], f"{tag} loss")
        for i, want in enumerate(want_leaves):
            got = arrays[f"{tag}/{i}"]
            assert got.shape == want.shape
            tol = (_NS["LR"] if lr_leaf[i] else
                   PARAM_TOL[dtype] * max(1.0, float(np.abs(want).max())))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"{tag} leaf {i}")


@pytest.mark.parametrize("name", list(CASE))
def test_split_losses_match_jax(runs, name):
    want = runs[1][name]
    for mname in ("8x1", "2x4"):
        got = runs[0][0][0][f"{mname}/{name}/float64"]
        np.testing.assert_allclose(got, want, rtol=JAX_RTOL, atol=0.0,
                                   err_msg=f"{mname} {name}")


@pytest.mark.parametrize("name", ["sage", "pna", "nequip", "equiformer"])
def test_mesh_1x1_is_bitwise_mesh_none(trees, name):
    case = CASE[name]
    want = _NS["two_steps"](case, "float32", trees[name])
    mesh = make_mesh((1, 1), device="cpu")
    try:
        got = _NS["two_steps"](case, "float32", trees[name], mesh)
    finally:
        mesh.close()
    assert got[0] == want[0]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_full_graph_shards_assemble_the_whole_graph(d):
    """Each rank's draw of a full graph is its cut of the whole graph (the
    stub mesh: a src group of ``d``, no collective is issued)."""
    n, e = 64, 384
    whole = train.full_graph_shard(50, 330, n, e, 7, 3, "cpu",
                                   geometric=True, seed=2)
    assert int(whole.agg.in_degree.sum()) == 330
    assert bool((whole.dst[:330] < whole.dst[1:331]).logical_or(
        whole.dst[:330] == whole.dst[1:331]).all())
    parts = []
    for row in range(d):
        mesh = types.SimpleNamespace(d=d, row=row)
        got = train.full_graph_shard(50, 330, n, e, 7, 3, "cpu", mesh=mesh,
                                     geometric=True, seed=2)
        cut = parallel.shard_batch(whole, mesh)
        for f in ("x", "src", "dst", "pos", "node_mask", "labels"):
            assert torch.equal(getattr(got, f), getattr(cut, f)), f
        assert torch.equal(got.split.in_degree, cut.split.in_degree)
        assert (got.split.nodes, got.split.edges) == (True, True)
        assert got.agg.edge_ids.numel() == int((got.dst < n).sum())
        parts.append(got)
    for f in ("x", "src", "dst", "labels"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(whole, f)), f
    assert torch.equal(torch.cat([p.split.in_degree for p in parts]),
                       whole.agg.in_degree)
