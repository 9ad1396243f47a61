"""The port's engines against ``repro.core.exact_psi`` and the JAX engines.

On the verify graph (``powerlaw_configuration(300, 1800, seed=3)``,
``heterogeneous(seed=4)``) every backend lands within 1e-6 (L∞) of the
float64 sparse-LU oracle at f32 and within 1e-9 at f64 with tol 1e-12.
"""
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.kernels.formats import build_bsr

BACKENDS = [("reference", {}), ("cuda", {}), ("cuda", {"regime": "bsr"}),
            ("pallas", {"tile": 128}), ("distributed", {}), ("async", {})]


def _graphs(n=300, m=1800, seed=3):
    return (tg.powerlaw_configuration(n, m, seed=seed),
            jg.powerlaw_configuration(n, m, seed=seed))


def _exact(g_j, seed=4):
    return jc.exact_psi(g_j, jc.heterogeneous(g_j.n, seed=seed))[0]


@pytest.mark.parametrize("backend,opts", BACKENDS)
@pytest.mark.parametrize("dtype,tol,bound", [(torch.float32, 1e-8, 1e-6),
                                             (torch.float64, 1e-12, 1e-9)])
def test_backends_match_exact_psi(backend, opts, dtype, tol, bound):
    g_t, g_j = _graphs()
    eng = tc.make_engine(backend, graph=g_t,
                         activity=tc.heterogeneous(g_t.n, seed=4),
                         dtype=dtype, device="cpu", **opts)
    res = eng.run(tol=tol)
    # the async backend counts its chunk steps a sweep (skewed epochs make
    # that fewer than its max epoch); every other one a mat-vec a step
    matvecs = (-(-eng.last_run.total_steps // eng.num_chunks) + 1
               if backend == "async" else res.iterations + 1)
    assert res.converged and res.matvecs == matvecs
    assert res.psi.dtype == dtype and res.s.shape == (g_t.n,)
    err = np.abs(res.psi.double().numpy() - _exact(g_j)).max()
    assert err <= bound, err


@pytest.mark.parametrize("tol", [1e-1, 1e-2, 1e-3])
def test_reference_iterations_match_jax_at_f32(tol):
    """Same tol, same iteration count as the JAX ``reference`` backend.

    Each tol is chosen so that no gap of the trajectory lies within 1% of
    it (checked below on the JAX trajectory), so a last-digit difference in
    the f32 sums cannot move the stopping step. Smaller tols are not held
    to this: below a gap of about 1e-4 the two packages' f32 trajectories
    differ by more than 1% (the gap there is mostly the rounding of sums
    taken in another order), and near 1e-6 by a factor of two."""
    g_t, g_j = _graphs()
    ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=4))
    _, _, gaps = jc.power_psi_fixed(ops_j, 40)
    traj = np.asarray(gaps) * float(ops_j.b_norm)
    assert not np.any(np.abs(traj - tol) <= 0.01 * tol)
    res_j = jc.make_engine("reference", graph=g_j,
                           activity=jc.heterogeneous(g_j.n, seed=4)
                           ).run(tol=tol)
    res_t = tc.make_engine("reference", graph=g_t,
                           activity=tc.heterogeneous(g_t.n, seed=4),
                           device="cpu").run(tol=tol)
    assert res_t.iterations == int(res_j.iterations)
    assert res_t.iterations == int(np.argmax(traj <= tol)) + 1
    assert res_t.matvecs == int(res_j.matvecs)
    assert res_t.gap == pytest.approx(float(res_j.gap), rel=1e-2)


@pytest.mark.parametrize("tol", [1e-1, 1e-2, 1e-3])
def test_bsr_iterations_match_jax_pallas_at_f32(tol):
    """The ``cuda`` bsr regime (the fused step's plain version on the CPU)
    takes the JAX ``pallas`` bsr regime's iteration count (its Pallas
    kernel in interpret mode) at tols that no gap of the trajectory lies
    within 1% of, as the reference backends do above; the fixed points
    agree to f32 rounding."""
    g_t, g_j = _graphs()
    ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=4))
    _, _, gaps = jc.power_psi_fixed(ops_j, 40)
    traj = np.asarray(gaps) * float(ops_j.b_norm)
    assert not np.any(np.abs(traj - tol) <= 0.01 * tol)
    res_j = jc.make_engine("pallas", graph=g_j, regime="bsr",
                           activity=jc.heterogeneous(g_j.n, seed=4),
                           interpret=True).run(tol=tol)
    res_t = tc.make_engine("cuda", graph=g_t, regime="bsr",
                           activity=tc.heterogeneous(g_t.n, seed=4),
                           device="cpu").run(tol=tol)
    assert res_t.iterations == int(res_j.iterations)
    assert res_t.matvecs == int(res_j.matvecs)
    np.testing.assert_allclose(res_t.s.numpy(), np.asarray(res_j.s),
                               rtol=2e-5, atol=2e-6)


def test_power_psi_matches_jax():
    g_t, g_j = _graphs()
    ops_t = tc.build_operators(g_t, tc.heterogeneous(g_t.n, seed=4),
                               dtype=torch.float64, device="cpu")
    res = tc.power_psi(ops_t, tol=1e-12)
    assert res.converged
    np.testing.assert_allclose(res.psi.numpy(), _exact(g_j), atol=1e-12)
    psi, s, gaps = tc.power_psi_fixed(ops_t, 5)
    assert gaps.shape == (5,) and bool(torch.all(gaps[1:] < gaps[:-1]))


@pytest.mark.parametrize("backend,opts", BACKENDS[:3])
def test_check_every_lands_on_multiples(backend, opts):
    g, _ = _graphs()
    act = tc.heterogeneous(g.n, seed=4)
    base = tc.make_engine(backend, graph=g, activity=act, device="cpu",
                          **opts).run(tol=1e-8)
    res = tc.make_engine(backend, graph=g, activity=act, device="cpu",
                         check_every=3, **opts).run(tol=1e-8)
    assert res.iterations % 3 == 0
    assert base.iterations <= res.iterations < base.iterations + 3
    assert res.converged and res.gap <= 1e-8


def test_max_iter_stops_unconverged():
    g, _ = _graphs()
    eng = tc.make_engine("cuda", graph=g,
                         activity=tc.heterogeneous(g.n, seed=4), device="cpu")
    res = eng.run(tol=1e-12, max_iter=4)
    assert res.iterations == 4 and not res.converged and res.matvecs == 5


def test_step_advances_state():
    g, _ = _graphs()
    act = tc.heterogeneous(g.n, seed=4)
    for backend in ("reference", "cuda"):
        eng = tc.make_engine(backend, device="cpu")
        state = eng.prepare(g, act)
        for _ in range(3):
            state = eng.step(state)
        assert state.t == 3 and np.isfinite(state.gap)
        res = eng.run(tol=0.0, max_iter=3)
        assert res.gap == pytest.approx(state.gap, rel=1e-6)


def test_make_engine_rejects_unknown_options_and_backends():
    with pytest.raises(ValueError, match="unknown engine option"):
        tc.make_engine("reference", device="cpu", tile=128)
    with pytest.raises(ValueError, match="unknown engine option"):
        tc.make_engine("cuda", device="cpu", mesh=None)
    with pytest.raises(ValueError, match="unknown backend"):
        tc.make_engine("sharded", device="cpu")
    with pytest.raises(ValueError, match="l1"):
        tc.make_engine("cuda", device="cpu",
                       criterion=tc.ConvergenceCriterion(norm="l2"))
    with pytest.raises(ValueError, match="regime"):
        tc.make_engine("cuda", device="cpu", regime="dense")
    with pytest.raises(ValueError, match="activity"):
        tc.make_engine("cuda", device="cpu", graph=_graphs()[0])
    assert tc.available_backends() == ("accelerated", "async", "auto",
                                       "cuda", "distributed", "push",
                                       "reference")
    assert isinstance(tc.make_engine("pallas", device="cpu"), tc.CudaEngine)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    g, _ = _graphs()
    act = tc.heterogeneous(g.n, seed=4)
    for backend in ("reference", "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.make_engine(backend, graph=g, activity=act)


# ------------------------------------------------------------------ #
# O(Δ) patches each match a fresh prepare on the patched graph
# ------------------------------------------------------------------ #
def _fresh_psi(eng, **opts):
    fresh = tc.make_engine(eng.name, graph=eng.graph, activity=eng.activity,
                           dtype=torch.float64, device="cpu", **opts)
    return fresh, fresh.run(tol=1e-13).psi


def _engine(regime, g, **opts):
    return tc.make_engine("cuda", graph=g,
                          activity=tc.heterogeneous(g.n, seed=4),
                          dtype=torch.float64, device="cpu", regime=regime,
                          **opts)


def test_sentinel_slot_insert_matches_fresh_prepare():
    g, _ = _graphs()
    eng = _engine("edge_tile", g, tile=128)
    eng.run(tol=1e-13)
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, g.n, 20), rng.integers(0, g.n, 20)
    assert eng.patch_edges(src, dst)
    assert eng.format_builds == 1                   # patched, not rebuilt
    # the device format holds exactly the host format's new slots
    np.testing.assert_array_equal(eng.fmt.src_idx.numpy(),
                                  eng.fmt_host.src_idx)
    np.testing.assert_array_equal(eng.fmt.dst_local.numpy(),
                                  eng.fmt_host.dst_local)
    assert eng.graph.m > g.m
    _, psi_fresh = _fresh_psi(eng, tile=128)
    np.testing.assert_allclose(eng.run(tol=1e-13).psi.numpy(),
                               psi_fresh.numpy(), rtol=1e-12, atol=1e-16)


def test_overflow_rebuilds_format_and_matches_fresh_prepare():
    g, _ = _graphs()
    eng = _engine("edge_tile", g, tile=128, e1=1, e2=32)
    free0 = int(eng._tile_capacity[0] - eng._tile_used[0])
    existing = set(zip(g.src.tolist(), g.dst.tolist()))
    pairs = [(s, d) for s in range(g.n) for d in range(128)
             if s != d and (s, d) not in existing][:free0 + 1]
    src, dst = (np.asarray(x) for x in zip(*pairs))
    assert eng.patch_edges(src, dst)
    assert eng.format_builds == 2                   # tile 0 overflowed
    fresh, psi_fresh = _fresh_psi(eng, tile=128, e1=1, e2=32)
    np.testing.assert_array_equal(eng.fmt.src_idx.numpy(),
                                  fresh.fmt.src_idx.numpy())
    np.testing.assert_allclose(eng.run(tol=1e-13).psi.numpy(),
                               psi_fresh.numpy(), rtol=1e-12, atol=1e-16)


def test_bsr_increment_matches_fresh_prepare():
    g = tg.clustered_blocks(600, 5000, block=128, p_in=0.95, seed=2)
    eng = _engine("bsr", g)
    rng = np.random.default_rng(6)
    src = rng.integers(0, g.n, 30)
    dst = np.minimum((src // 128) * 128 + rng.integers(0, 128, 30), g.n - 1)
    assert eng.patch_edges(src, dst)
    assert eng.format_builds == 1                   # existing tiles only
    ref_fmt = build_bsr(eng.graph, dtype=np.float64)
    np.testing.assert_array_equal(eng.fmt_host.tiles, ref_fmt.tiles)
    np.testing.assert_array_equal(eng.fmt.tiles.numpy(), ref_fmt.tiles)
    _, psi_fresh = _fresh_psi(eng, regime="bsr")
    np.testing.assert_allclose(eng.run(tol=1e-13).psi.numpy(),
                               psi_fresh.numpy(), rtol=1e-12, atol=1e-16)


def test_bsr_new_block_rebuilds_and_matches_fresh_prepare():
    g = tg.clustered_blocks(600, 3000, block=128, p_in=1.0, seed=2)
    eng = _engine("bsr", g)
    assert (0, 4) not in eng._bsr_blocks
    assert eng.patch_edges(np.asarray([3]), np.asarray([4 * 128 + 5]))
    assert eng.format_builds == 2
    assert (0, 4) in eng._bsr_blocks
    np.testing.assert_array_equal(eng.fmt.tiles.numpy(),
                                  build_bsr(eng.graph, dtype=np.float64).tiles)
    _, psi_fresh = _fresh_psi(eng, regime="bsr")
    np.testing.assert_allclose(eng.run(tol=1e-13).psi.numpy(),
                               psi_fresh.numpy(), rtol=1e-12, atol=1e-16)


def test_bsr_patch_past_255_rebuilds_in_working_dtype():
    """One-byte tiles hold counts up to 255. The host drops duplicate
    edges, so ``patch_edges`` only turns a 0 cell into 1; a count patched
    in past 255 (here through the regime's own patch hook) uploads the
    patched host format again in the working dtype."""
    g = tg.clustered_blocks(600, 3000, block=128, p_in=1.0, seed=2)
    g = tg.Graph(g.n, np.concatenate([g.src, np.full(255, 3)]),
                 np.concatenate([g.dst, np.full(255, 5)]))
    eng = _engine("bsr", g)
    assert eng.fmt.tiles.dtype == torch.uint8
    assert eng.patch_edges(np.asarray([4]), np.asarray([6]))   # 0 -> 1
    assert eng.fmt.tiles.dtype == torch.uint8 and eng.format_builds == 1
    eng._patch_edges_bsr(np.asarray([3]), np.asarray([5]))     # 255 -> 256
    assert eng.format_builds == 2
    assert eng.fmt.tiles.dtype == torch.float64
    np.testing.assert_array_equal(eng.fmt.tiles.numpy(), eng.fmt_host.tiles)
    b = eng._bsr_blocks[(0, 0)]
    assert eng.fmt.tiles[b, 3, 5] == 256.0


@pytest.mark.parametrize("regime", ["edge_tile", "bsr"])
def test_activity_patch_matches_fresh_prepare(regime):
    g, _ = _graphs()
    eng = _engine(regime, g)
    eng.run(tol=1e-13)
    assert eng.patch_activity(np.asarray([3, 7, 3]),
                              lam=np.asarray([2.0, 0.1, 5.0]))
    assert eng.activity.lam[3] == 5.0               # last write wins
    _, psi_fresh = _fresh_psi(eng, regime=regime)
    np.testing.assert_allclose(eng.run(tol=1e-13).psi.numpy(),
                               psi_fresh.numpy(), rtol=1e-12, atol=1e-16)
