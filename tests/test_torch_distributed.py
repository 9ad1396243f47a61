"""The port's distributed Power-ψ (``repro_torch.core.distributed`` over
``torch.distributed``), its mesh, the ``distributed`` engine and the
synchronous driver, against the JAX package's.

* In this process (a world-1 gloo group, the code that runs on one card
  over NCCL): ``partition_2d`` bitwise JAX's; ``DistributedPsi`` and
  ``PsiDriver`` at float64 on a ``(1, 1)`` mesh with JAX's iteration counts
  and ψ within 1e-12 (relative L∞) of JAX's and 1e-6 (L∞) of
  ``exact_psi``; dispatch∘finalize bitwise the fused step; the engine's
  edge patches held against the port's ``reference`` engine and
  ``exact_psi`` (never against the JAX ``distributed`` patch).
* Across 8 gloo ranks in spawned processes (``file://`` rendezvous in a
  temporary directory, no port): meshes ``(2, 4)`` and ``("pod", "data",
  "model") = (2, 2, 2)`` and ``(4, 2)``, each rank's block bitwise the JAX
  package's (a JAX subprocess with 8 forced host devices at float64), its
  iteration counts JAX's, ψ within 1e-6 of ``exact_psi``; a remesh from
  ``(2, 4)`` to ``(4, 2)``; the 1-D baseline; a driver restart.
"""
import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro.graphs.partition import partition_2d as j_partition_2d
from repro_torch import obs as tobs
from repro_torch.convert import dist_arrays_from_numpy
from repro_torch.core import PsiService, exact_psi, heterogeneous, make_engine
from repro_torch.core.distributed import (BlockOverflowError, DistPsiArrays,
                                          DistributedPsi)
from repro_torch.graphs.partition import partition_2d
from repro_torch.graphs.structure import Graph
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import PsiDriver

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = dict(device="cpu")
FIELDS = [f.name for f in dataclasses.fields(DistPsiArrays)]
JAX_FIELDS = ["src_local", "dst_local", "inv_w_src", "mu_piece", "c_piece",
              "c_src", "lam_piece", "d_piece"]


@contextlib.contextmanager
def _x64():
    """JAX at float64 for the duration, in every thread."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _fresh_sinks():
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracker=tobs.ConvergenceTracker(keep=4096),
                          decisions=tobs.DecisionLog())
    yield
    tobs.restore(prev)


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), **CPU)


@pytest.fixture(scope="module")
def platform():
    g = tg.powerlaw_configuration(300, 1800, seed=3)
    act = heterogeneous(g.n, seed=4)
    return g, act, exact_psi(g, act)[0]


# --------------------------------------------------------------------- #
# partition_2d: bitwise the JAX package's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("d,mo", [(1, 1), (2, 4), (4, 2), (8, 1), (3, 5)])
def test_partition_2d_bitwise_equal_to_jax(d, mo):
    """(4, 2) is also the ("pod", "data", "model") = (2, 2, 2) fold."""
    g_t, g_j = tg.erdos_renyi(600, 4500, seed=4), jg.erdos_renyi(600, 4500,
                                                                 seed=4)
    p, q = partition_2d(g_t, d, mo), j_partition_2d(g_j, d, mo)
    assert (p.n, p.n_pad, p.d, p.mo, p.q, p.nc, p.e_max) == (
        q.n, q.n_pad, q.d, q.mo, q.q, q.nc, q.e_max)
    for name in ("src_local", "dst_local", "e_counts"):
        a, b = getattr(p, name), getattr(q, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    v = np.random.default_rng(0).uniform(size=600)
    assert np.array_equal(p.to_src_layout(v), q.to_src_layout(v))
    assert np.array_equal(p.to_piece_layout(v), q.to_piece_layout(v))
    src = p.to_src_layout(v)
    assert np.array_equal(p.from_src_layout(src), q.from_src_layout(src))


# --------------------------------------------------------------------- #
# The mesh
# --------------------------------------------------------------------- #
def test_make_mesh_checks_axes_and_world():
    with pytest.raises(ValueError, match="mesh axes"):
        make_mesh((1, 1), ("model", "data"), **CPU)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh((1, 1, 1), ("data", "model"), **CPU)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2, 1), **CPU)             # world 1 (or none yet)


def test_world1_mesh_opens_and_closes_twice(mesh):
    for _ in range(2):
        m = make_mesh((1, 1, 1), ("pod", "data", "model"), **CPU)
        assert (m.row, m.col, m.d, m.mo) == (0, 0, 1, 1)
        assert m.src_axes == ("pod", "data")
        x = torch.arange(4.0)
        assert torch.equal(m.reduce_scatter_src(x), x)
        assert torch.equal(m.all_gather_model(x), x)
        assert float(m.all_reduce_src(x.sum().reshape(1))[0]) == 6.0
        m.barrier()
        m.close()
    # the module's mesh still works after the others closed
    assert torch.equal(mesh.all_gather_world(torch.ones(2)), torch.ones(2))


# --------------------------------------------------------------------- #
# World 1 in this process: DistributedPsi and PsiDriver against JAX, f64
# --------------------------------------------------------------------- #
def _jax_dist(n=600, m=4500, seed=4, act_seed=9):
    from repro.core.distributed import DistributedPsi as JDist
    g_j = jg.erdos_renyi(n, m, seed=seed)
    return JDist.from_graph(g_j, jc.heterogeneous(n, seed=act_seed),
                            _jmesh(), dtype=jnp.float64), g_j


@pytest.mark.parametrize("tol,chunk", [(1e-9, 8), (1e-7, 16)])
def test_world1_distributed_psi_matches_jax_f64(mesh, tol, chunk):
    g = tg.erdos_renyi(600, 4500, seed=4)
    act = heterogeneous(600, seed=9)
    dp = DistributedPsi.from_graph(g, act, mesh, dtype=torch.float64)
    with _x64():
        jd, g_j = _jax_dist()
        fields = {k: np.asarray(getattr(jd.arrays, k)) for k in JAX_FIELDS}
        psi_j, it_j, gap_j = jd.run_to_convergence(tol=tol, chunk_iters=chunk)
    ref = dist_arrays_from_numpy(fields, row=0, col=0, **CPU)
    for name in FIELDS:                      # the rank's block, bitwise
        assert torch.equal(getattr(dp.arrays, name), getattr(ref, name)), \
            name
    psi, it, gap = dp.run_to_convergence(tol=tol, chunk_iters=chunk)
    assert it == it_j and gap <= tol
    assert np.abs(psi - psi_j).max() <= 1e-12 * np.abs(psi_j).max()
    assert np.abs(psi - exact_psi(g, act)[0]).max() <= 1e-6


def test_dispatch_finalize_bitwise_equal_to_fused_step(mesh):
    g = tg.erdos_renyi(600, 4500, seed=4)
    dp = DistributedPsi.from_graph(g, heterogeneous(600, seed=9), mesh)
    step, dispatch, finalize = (dp.make_step(), dp.make_dispatch(),
                                dp.make_finalize())
    s = dp.arrays.c_src
    for _ in range(5):
        s_fused, gap_fused = step(s, dp.arrays)
        s_split, gap_split = finalize(dispatch(s, dp.arrays), dp.arrays)
        assert torch.equal(s_split, s_fused)
        assert torch.equal(gap_split, gap_fused)
        s = s_fused


def test_world1_psi_driver_matches_jax_f64_and_restarts(mesh, tmp_path):
    from repro.runtime import PsiDriver as JDriver
    g = tg.erdos_renyi(600, 4500, seed=4)
    act = heterogeneous(600, seed=9)
    dp = DistributedPsi.from_graph(g, act, mesh, dtype=torch.float64)
    with _x64():
        jd, _ = _jax_dist()
        rep_j = JDriver(jd, chunk_iters=8).run(tol=1e-9)
    clean = PsiDriver(dp, chunk_iters=8).run(tol=1e-9)
    assert clean.iterations == rep_j.iterations
    assert clean.chunks == rep_j.chunks
    assert np.abs(clean.psi - rep_j.psi).max() \
        <= 1e-12 * np.abs(rep_j.psi).max()
    # restart from the last checkpoint at chunks 1 and 3: bitwise the clean
    # run (the checkpoint holds the iterate exactly)
    rep = PsiDriver(dp, ckpt_dir=str(tmp_path), chunk_iters=8).run(
        tol=1e-9, fail_hook=lambda c: c in (1, 3))
    assert rep.restarts == 2 and rep.iterations == clean.iterations
    assert np.array_equal(rep.psi, clean.psi)
    top, _ = rep.queries().top_k(5)
    assert np.array_equal(top, np.argsort(-clean.psi, kind="stable")[:5])


def test_psi_driver_remesh_world1_carries_warm_state(mesh):
    g = tg.erdos_renyi(640, 5000, seed=7)
    act = heterogeneous(640, seed=8)
    dp = DistributedPsi.from_graph(g, act, mesh)
    run = dp.make_run(chunk_iters=8)
    s = dp.arrays.c_src
    for _ in range(3):
        s, _ = run(s, dp.arrays)
    other = make_mesh((1, 1, 1), ("pod", "data", "model"), **CPU)
    try:
        warm = PsiDriver(dp, chunk_iters=8).remesh(other, g, act, s).run(
            tol=1e-7)
        cold = PsiDriver(DistributedPsi.from_graph(g, act, other),
                         chunk_iters=8).run(tol=1e-7)
    finally:
        other.close()
    assert warm.iterations < cold.iterations
    assert np.abs(warm.psi - cold.psi).max() <= 1e-6


# --------------------------------------------------------------------- #
# The distributed engine: counts, patches, acceleration, the service
# --------------------------------------------------------------------- #
def test_distributed_engine_matches_jax_engine_f64(mesh, platform):
    g, act, psi_true = platform
    eng = make_engine("distributed", graph=g, activity=act, mesh=mesh,
                      dtype=torch.float64, **CPU)
    res = eng.run(tol=1e-10)
    with _x64():
        g_j = jg.powerlaw_configuration(300, 1800, seed=3)
        res_j = jc.make_engine("distributed", graph=g_j,
                               activity=jc.heterogeneous(300, seed=4),
                               mesh=_jmesh(), dtype=jnp.float64
                               ).run(tol=1e-10)
    assert res.iterations == int(res_j.iterations)
    assert res.matvecs == int(res_j.matvecs)
    np.testing.assert_allclose(res.s.numpy(), np.asarray(res_j.s),
                               rtol=1e-12, atol=0)
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6


def test_distributed_patch_edges_block_local(mesh, platform, monkeypatch):
    """The delta hook never re-partitions: new edges merge into their
    node-stable blocks; the warm fixed point is the reference engine's and
    exact ψ on the patched graph."""
    import repro_torch.core.distributed as dist_mod
    g, act, _ = platform
    eng = make_engine("distributed", graph=g, activity=act, mesh=mesh,
                      **CPU)
    prev = eng.run(tol=1e-9)

    def boom(*a, **k):
        raise AssertionError("re-partition on the delta path")

    monkeypatch.setattr(dist_mod, "partition_2d", boom)
    src = np.asarray([0, 1, 2, 0], np.int32)
    dst = np.asarray([10, 11, 12, 10], np.int32)   # dup collapses
    assert eng.patch_edges(src, dst) is True
    res = eng.run(tol=1e-9, s0=prev.s)
    g2 = Graph(g.n, np.concatenate([g.src, src]),
               np.concatenate([g.dst, dst])).dedup()
    ref = make_engine("reference", graph=g2, activity=act, **CPU).run(
        tol=1e-9)
    assert np.abs(res.psi.numpy() - ref.psi.numpy()).max() <= 1e-6
    assert np.abs(res.psi.numpy() - exact_psi(g2, act)[0]).max() <= 1e-6
    # the patched block holds the edges a fresh partition of g2 holds, in
    # the same dst runs (an insert goes to the end of its run)
    monkeypatch.undo()
    fresh = DistributedPsi.from_graph(g2, act, mesh)
    a, b = eng.dist.arrays, fresh.arrays
    assert torch.equal(a.lengths, b.lengths)
    # the patch writes the host's f64 1/w cast once; a fresh build sums w in
    # the working dtype: equal to f32 rounding
    torch.testing.assert_close(a.inv_w_src, b.inv_w_src, rtol=1e-6, atol=0)
    dst = torch.repeat_interleave(torch.arange(a.lengths.numel()), a.lengths)
    assert torch.equal(torch.sort(dst * g.n + a.src_local).values,
                       torch.sort(dst * g.n + b.src_local).values)


def test_distributed_patch_edges_overflow_regrows_with_warning(mesh):
    """A full block (e_max exhausted) regrows the partition — warning with
    the overflowing block and required capacity — and stays exact."""
    g = tg.erdos_renyi(100, 256, seed=6)          # e_max == m: zero slack
    act = heterogeneous(g.n, seed=7)
    eng = make_engine("distributed", graph=g, activity=act, mesh=mesh,
                      **CPU)
    prev = eng.run(tol=1e-9)
    assert int(eng.dist.part.e_max) == g.m
    with pytest.warns(RuntimeWarning,
                      match=r"block \(row=0, col=0\).*e_max=256.*>= 257"):
        assert eng.patch_edges(np.asarray([0]), np.asarray([50])) is True
    assert int(eng.dist.part.e_max) > g.m
    res = eng.run(tol=1e-9, s0=prev.s)
    g2 = Graph(g.n, np.concatenate([g.src, [0]]),
               np.concatenate([g.dst, [50]])).dedup()
    psi_true, _ = exact_psi(g2, act)
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6
    svc = PsiService(g, act, tol=1e-9, backend="distributed",
                     engine_opts=dict(mesh=mesh), **CPU)
    svc.scores()
    with pytest.warns(RuntimeWarning):
        svc.add_edges(np.asarray([0]), np.asarray([50]))
    assert np.abs(svc.scores() - psi_true).max() <= 1e-6


def test_distributed_patch_edges_overflow_raise_mode(mesh):
    g = tg.erdos_renyi(100, 256, seed=6)
    act = heterogeneous(g.n, seed=7)
    eng = make_engine("distributed", graph=g, activity=act, mesh=mesh,
                      on_overflow="raise", **CPU)
    eng.run(tol=1e-9)
    with pytest.raises(BlockOverflowError,
                       match=r"\(row=0, col=0\).*capacity >= 257") as ei:
        eng.patch_edges(np.asarray([0]), np.asarray([50]))
    assert ei.value.block == (0, 0)
    assert ei.value.e_max == 256 and ei.value.required == 257
    assert eng.graph.m == g.m                     # the probe mutated nothing
    res = eng.run(tol=1e-9)
    assert np.abs(res.psi.numpy() - exact_psi(g, act)[0]).max() <= 1e-6
    with pytest.raises(ValueError, match="on_overflow"):
        make_engine("distributed", on_overflow="explode", **CPU)
    with pytest.raises(ValueError, match="l1"):
        make_engine("distributed", criterion=tc.ConvergenceCriterion(
            norm="l2"), **CPU)


def test_distributed_chunk_accelerate_and_driver_inherits(mesh, platform):
    g, act, psi_true = platform
    eng = make_engine("distributed", graph=g, activity=act, mesh=mesh,
                      accelerate=True, chunk_iters=4, **CPU)
    res = eng.run(tol=1e-9)
    assert res.converged
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-6
    drv = PsiDriver.from_engine(eng)
    assert drv.accelerate is True and drv.chunk_iters == 4
    rep = drv.run(tol=1e-11)     # driver gap is unscaled (no ‖B‖ factor)
    assert np.abs(rep.psi - psi_true).max() <= 1e-6
    with pytest.raises(ValueError, match="distributed state"):
        PsiDriver.from_engine(make_engine("reference", **CPU))


def test_service_distributed_interleaved_add_remove(mesh, platform):
    """add → activity → remove → add through one service: each warm fixed
    point is the reference engine's on the same graph and activity."""
    g, act, _ = platform
    svc = PsiService(g, act, tol=1e-9, backend="distributed",
                     engine_opts=dict(mesh=mesh), **CPU)
    top, vals = svc.top_k(3)
    assert np.all(np.diff(vals) <= 0)

    def check():
        ref = make_engine("reference", graph=svc.graph,
                          activity=svc.engine.activity, **CPU).run(tol=1e-9)
        assert np.abs(svc.scores() - ref.psi.numpy()).max() <= 1e-6

    svc.add_edges(np.asarray([0, 1], np.int32), np.asarray([20, 21],
                                                           np.int32))
    check()
    svc.update_activity(np.asarray([5]), lam=np.asarray([3.0]))
    check()
    svc.remove_edges(np.asarray([0, g.src[0]], np.int32),
                     np.asarray([20, g.dst[0]], np.int32))
    check()
    svc.add_edges(np.asarray([2], np.int32), np.asarray([22], np.int32))
    check()
    assert svc.graph.m == g.m + 3 - 2


# --------------------------------------------------------------------- #
# The serve CLI's --executor path
# --------------------------------------------------------------------- #
def _top(text):
    line = next(ln for ln in text.splitlines() if "req 0" in ln)
    return line.split("top-3=")[1].split(" ")[0]


@pytest.mark.parametrize("executor", ["sync", "async"])
def test_serve_executor_prints_the_jax_clis_top_k(executor):
    from repro.launch.serve import _serve_driver
    from repro_torch.launch.serve import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", "psi-score", "--executor", executor, "--device",
              "cpu", "--requests", "2"])
    port = out.getvalue()
    assert f"executor={executor}" in port and "chunk steps" in port
    out = io.StringIO()
    args = argparse.Namespace(executor=executor, num_chunks=4,
                              staleness_tau=2, requests=2, batch=4, top_k=3)
    with contextlib.redirect_stdout(out):
        _serve_driver(args)
    assert _top(port) == _top(out.getvalue())


def test_serve_executor_refuses_cuda_without_a_card():
    from repro_torch.launch.serve import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "psi-score", "--executor", "sync"])


# --------------------------------------------------------------------- #
# Eight gloo ranks in spawned processes against JAX on 8 forced devices
# --------------------------------------------------------------------- #
CASES = [("2x4", (2, 4), ("data", "model")),
         ("pod", (2, 2, 2), ("pod", "data", "model")),
         ("4x2", (4, 2), ("data", "model"))]

_JAX_SCRIPT = """
import json, sys
import numpy as np, jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.graphs import erdos_renyi
from repro.core import heterogeneous
from repro.core.distributed import DistributedPsi
out, arrays = {}, {}
g = erdos_renyi(600, 4500, seed=4)
act = heterogeneous(g.n, seed=9)
for name, shape, axes in CASES:
    dp = DistributedPsi.from_graph(g, act, jax.make_mesh(shape, axes),
                                   dtype=jnp.float64)
    psi, it, gap = dp.run_to_convergence(tol=1e-9, chunk_iters=8)
    out[name] = dict(iters=it, gap=gap)
    arrays[name + "/psi"] = psi
    for f in FIELDS:
        arrays[name + "/" + f] = np.asarray(getattr(dp.arrays, f))
# the 2-D sharded GraphSAGE forward at float32 (tests/test_distributed.py's
# test_sharded_2d_sage_matches_serial): its input, parameters and output
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.gnn import sage
from repro.models.gnn.sharded_mp import build_sharded_graph, sharded_sage_apply
gs = erdos_renyi(600, 4200, seed=2)
scfg = sage.SageConfig(d_feat=16, n_classes=5, d_hidden=32, n_layers=2)
sx = np.random.default_rng(0).normal(size=(gs.n, 16)).astype(np.float32)
sparams = sage.init_params(scfg, jax.random.PRNGKey(0))
smesh = jax.make_mesh((2, 4), ("data", "model"))
part, sg = build_sharded_graph(gs, smesh, bidirectional=True)
x_shard = jax.device_put(
    np.stack([part.to_src_layout(sx[:, j]) for j in range(16)], -1),
    NamedSharding(smesh, P(("data",), None, None)))
sout = np.asarray(sharded_sage_apply(sparams, x_shard, part, sg, smesh, scfg))
arrays["sage/x"] = sx
arrays["sage/out"] = np.stack([part.from_src_layout(sout[..., j])
                               for j in range(sout.shape[-1])], -1)
for i, leaf in enumerate(jax.tree_util.tree_leaves(sparams)):
    arrays["sage/p%d" % i] = np.asarray(leaf)
np.savez(sys.argv[1], **arrays)
print(json.dumps(out))
"""

_RANK_SCRIPT = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/pg",
                            rank=rank, world_size=world)
    from repro_torch.core import exact_psi, heterogeneous
    from repro_torch.core.distributed import DistributedPsi, DistributedPsi1D
    from repro_torch.core.operators import build_operators
    from repro_torch.graphs import erdos_renyi
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import PsiDriver
    res, arrays = {}, {}
    g = erdos_renyi(600, 4500, seed=4)
    act = heterogeneous(g.n, seed=9)
    psi_true = exact_psi(g, act)[0]
    for name, shape, axes in CASES:
        mesh = make_mesh(shape, axes, device="cpu")
        dp = DistributedPsi.from_graph(g, act, mesh, dtype=torch.float64)
        for f in FIELDS:
            arrays[name + "/" + f] = getattr(dp.arrays, f).numpy()
        psi, it, gap = dp.run_to_convergence(tol=1e-9, chunk_iters=8)
        arrays[name + "/psi"] = psi
        res[name] = dict(row=mesh.row, col=mesh.col, d=mesh.d, mo=mesh.mo,
                         iters=it, gap=gap,
                         err=float(np.abs(psi - psi_true).max()))
        if name == "2x4":
            step, disp, fin = (dp.make_step(), dp.make_dispatch(),
                               dp.make_finalize())
            s, same = dp.arrays.c_src, True
            for _ in range(4):
                a, ga = step(s, dp.arrays)
                b, gb = fin(disp(s, dp.arrays), dp.arrays)
                same = same and torch.equal(a, b) and torch.equal(ga, gb)
                s = a
            res["dispatch_finalize_bitwise"] = bool(same)
        mesh.close()
    # elastic remesh (2, 4) -> (4, 2), warm against cold
    g2 = erdos_renyi(640, 5000, seed=7)
    act2 = heterogeneous(g2.n, seed=8)
    m1 = make_mesh((2, 4), device="cpu")
    m2 = make_mesh((4, 2), device="cpu")
    d1 = DistributedPsi.from_graph(g2, act2, m1)
    run1 = d1.make_run(chunk_iters=8)
    s1 = d1.arrays.c_src
    for _ in range(3):
        s1, _ = run1(s1, d1.arrays)
    warm_drv = PsiDriver(d1, chunk_iters=8).remesh(m2, g2, act2, s1)
    warm = warm_drv.run(tol=1e-7)
    cold = PsiDriver(warm_drv.dist, chunk_iters=8).run(tol=1e-7)
    res["remesh"] = dict(
        warm=warm.iterations, cold=cold.iterations,
        err=float(np.abs(warm.psi - exact_psi(g2, act2)[0]).max()),
        diff=float(np.abs(warm.psi - cold.psi).max()))
    # a driver restart at chunks 1 and 3 (f32, as the JAX test runs it)
    g3 = erdos_renyi(500, 3500, seed=5)
    act3 = heterogeneous(g3.n, seed=6)
    d3 = DistributedPsi.from_graph(g3, act3, m1)
    rep = PsiDriver(d3, ckpt_dir=tmp + "/ckpt", chunk_iters=8).run(
        tol=1e-7, fail_hook=lambda c: c in (1, 3))
    res["restart"] = dict(
        restarts=rep.restarts,
        err=float(np.abs(rep.psi - exact_psi(g3, act3)[0]).max()))
    m1.close()
    m2.close()
    # the 1-D baseline: edges over all ranks, s replicated
    g4 = erdos_renyi(500, 3600, seed=12)
    act4 = heterogeneous(g4.n, seed=13)
    m4 = make_mesh((8, 1), device="cpu")
    d4 = DistributedPsi1D(g4, act4, m4, dtype=torch.float64)
    step4 = d4.make_step()
    s = d4.arrays["c"]
    for _ in range(80):
        s = step4(s, d4.arrays)
    ops = build_operators(g4, act4, dtype=torch.float64, device="cpu")
    psi4 = ops.psi_epilogue(s[:g4.n]).numpy()
    res["1d"] = dict(err=float(np.abs(psi4 - exact_psi(g4, act4)[0]).max()))
    m4.close()
    # the 2-D sharded GraphSAGE forward on (2, 4), with the JAX package's
    # input and parameters (the JAX subprocess ran first)
    from repro_torch.models.gnn import sage
    from repro_torch.models.gnn.sharded_mp import (build_sharded_graph,
                                                   features_to_src_layout,
                                                   sharded_sage_apply)
    from repro_torch.train.optim import tree_leaves
    scfg = sage.SageConfig(d_feat=16, n_classes=5, d_hidden=32, n_layers=2)
    sparams = sage.init_params(scfg, 0, device="cpu")
    with np.load(tmp + "/jax.npz") as z:
        sx = z["sage/x"]
        for i, p in enumerate(tree_leaves(sparams)):
            p.data.copy_(torch.as_tensor(z["sage/p%d" % i]))
    m5 = make_mesh((2, 4), device="cpu")
    part, sg = build_sharded_graph(erdos_renyi(600, 4200, seed=2), m5)
    sx_local = torch.as_tensor(features_to_src_layout(part, sx)[m5.row])
    arrays["sage/out"] = sharded_sage_apply(sparams, sx_local, part, sg, m5,
                                            scfg).numpy()
    res["sage"] = dict(row=m5.row, col=m5.col)
    m5.close()
    np.savez(tmp + "/rank%d.npz" % rank, **arrays)
    with open(tmp + "/rank%d.json" % rank, "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8, sys.argv[1]), nprocs=8, join=True)
"""


def _header():
    return (f"CASES = {CASES!r}\nFIELDS = {FIELDS!r}\n")


@pytest.fixture(scope="module")
def gloo8(tmp_path_factory):
    """Run the JAX subprocess, then the 8 gloo ranks (one after the other,
    each single-threaded, so the run loads the host's cores no more than
    it must); returns (JAX results, JAX arrays, per-rank results and
    arrays)."""
    tmp = str(tmp_path_factory.mktemp("gloo8"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1")
    jpath = os.path.join(tmp, "jax_reference.py")
    rpath = os.path.join(tmp, "torch_ranks.py")
    with open(jpath, "w") as fh:
        fh.write(f"CASES = {CASES!r}\nFIELDS = {JAX_FIELDS!r}\n"
                 + textwrap.dedent(_JAX_SCRIPT))
    with open(rpath, "w") as fh:
        fh.write(textwrap.dedent(_RANK_SCRIPT).replace(
            "\n\ndef rank_main", "\n" + _header() + "\n\ndef rank_main", 1))
    jproc = subprocess.run([sys.executable, jpath,
                            os.path.join(tmp, "jax.npz")], env=env,
                           capture_output=True, text=True, timeout=600)
    assert jproc.returncode == 0, jproc.stderr[-4000:]
    ranks = subprocess.run([sys.executable, rpath, tmp], env=env,
                           capture_output=True, text=True, timeout=600)
    assert ranks.returncode == 0, ranks.stderr[-4000:]
    per_rank = []
    for r in range(8):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            res = json.load(fh)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            arr = {k: z[k] for k in z.files}
        per_rank.append((res, arr))
    with np.load(os.path.join(tmp, "jax.npz")) as z:
        jarr = {k: z[k] for k in z.files}
    return json.loads(jproc.stdout), jarr, per_rank


def test_gloo8_coordinates_fold_pod_into_rows(gloo8):
    _, _, per_rank = gloo8
    for r, (res, _) in enumerate(per_rank):
        assert (res["2x4"]["row"], res["2x4"]["col"]) == divmod(r, 4)
        assert (res["4x2"]["row"], res["4x2"]["col"]) == divmod(r, 2)
        assert (res["pod"]["d"], res["pod"]["mo"]) == (4, 2)
        assert (res["pod"]["row"], res["pod"]["col"]) == divmod(r, 2)


def test_gloo8_blocks_bitwise_equal_to_jax(gloo8):
    _, jarr, per_rank = gloo8
    for res, arr in per_rank:
        for name, _, _ in CASES:
            fields = {f: jarr[f"{name}/{f}"] for f in JAX_FIELDS}
            ref = dist_arrays_from_numpy(fields, row=res[name]["row"],
                                         col=res[name]["col"], **CPU)
            for f in FIELDS:
                got = arr[f"{name}/{f}"]
                want = getattr(ref, f).numpy()
                assert got.dtype == want.dtype and np.array_equal(got, want)


def test_gloo8_iteration_counts_equal_jax(gloo8):
    jres, _, per_rank = gloo8
    for res, _ in per_rank:
        for name, _, _ in CASES:
            assert res[name]["iters"] == jres[name]["iters"], name
            assert res[name]["gap"] <= 1e-9


def test_gloo8_psi_matches_exact_and_jax_on_every_rank(gloo8):
    _, jarr, per_rank = gloo8
    for name, _, _ in CASES:
        psi0 = per_rank[0][1][f"{name}/psi"]
        psi_j = jarr[f"{name}/psi"]
        assert np.abs(psi0 - psi_j).max() <= 1e-12 * np.abs(psi_j).max()
        for res, arr in per_rank:
            assert res[name]["err"] <= 1e-6
            assert np.array_equal(arr[f"{name}/psi"], psi0)   # same ψ


def test_gloo8_dispatch_finalize_bitwise(gloo8):
    assert all(res["dispatch_finalize_bitwise"] for res, _ in gloo8[2])


def test_gloo8_remesh_resumes_warm(gloo8):
    for res, _ in gloo8[2]:
        rm = res["remesh"]
        assert rm["warm"] < rm["cold"]
        assert rm["err"] <= 1e-6 and rm["diff"] <= 1e-6


def test_gloo8_driver_restart(gloo8):
    for res, _ in gloo8[2]:
        assert res["restart"]["restarts"] == 2
        assert res["restart"]["err"] <= 1e-6


def test_gloo8_1d_baseline_matches_exact(gloo8):
    for res, _ in gloo8[2]:
        assert res["1d"]["err"] <= 1e-6


def test_gloo8_sharded_sage_matches_serial_and_jax(gloo8):
    """``sharded_sage_apply`` on 8 gloo ranks, mesh (2, 4), float32, with
    the JAX package's input and parameters: every rank of a row holds the
    same rows, and the assembled logits equal the serial ``sage.apply`` and
    JAX's ``shard_map`` forward within 1e-5 (sums in another order)."""
    from repro_torch.models.gnn import sage
    from repro_torch.models.gnn.common import batch_from_graph
    from repro_torch.models.gnn.sharded_mp import features_from_src_layout
    from repro_torch.train.optim import tree_leaves
    _, jarr, per_rank = gloo8
    cfg = sage.SageConfig(d_feat=16, n_classes=5, d_hidden=32, n_layers=2)
    params = sage.init_params(cfg, 0, device="cpu")
    for i, p in enumerate(tree_leaves(params)):
        p.data.copy_(torch.as_tensor(jarr["sage/p%d" % i]))
    g = tg.erdos_renyi(600, 4200, seed=2)
    ref = sage.apply(params, batch_from_graph(g, jarr["sage/x"],
                                              device="cpu"), cfg)
    ref = ref.detach().numpy()
    rows = {}
    for res, arr in per_rank:
        r = res["sage"]["row"]
        if r in rows:
            assert np.array_equal(rows[r], arr["sage/out"])
        rows[r] = arr["sage/out"]
    both = Graph(g.n, np.concatenate([g.src, g.dst]),
                 np.concatenate([g.dst, g.src]))
    part = partition_2d(both, 2, 4)
    got = features_from_src_layout(part, np.stack([rows[0], rows[1]]))
    assert got.shape == ref.shape == jarr["sage/out"].shape
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - jarr["sage/out"]).max() < 1e-5
