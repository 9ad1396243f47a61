"""The port's autotuner and ``auto`` backend against the JAX package's.

The cost model, its constants and its candidates are the JAX package's, so
on the same graph both packages must score every candidate to the same
bytes, prune the same BSR candidates and pick the same model-only plan.
Graphs: the fixtures of ``tests/test_autotune.py`` plus the serve loop's
graph. The microbenchmark runs here on the CPU (the plain versions, timed
on the host clock); on the card it times the CUDA kernels.
"""
import numpy as np
import pytest
import torch

import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro.kernels import autotune as jauto
from repro.obs import calibrate as jcal
from repro.obs import explain as jexplain
from repro_torch.kernels import autotune
from repro_torch.obs import calibrate, explain

GRAPHS = {
    "sparse": lambda m: m.powerlaw_configuration(1000, 7000, seed=17),
    "clustered": lambda m: m.clustered_blocks(512, 24_000, block=128,
                                              p_in=1.0, seed=3),
    "er": lambda m: m.erdos_renyi(200, 900, seed=1),
    "serve": lambda m: m.powerlaw_configuration(10_000, 70_000, seed=5),
}
# skewed (edge, bsr, node) bytes/slot: edge_tile looks ~free, BSR ruinous
SKEW = (0.001, 1e5, 16.0)
DIRTY_GRID = (0.0001, 0.001, 0.01, 0.1, 0.5, 1.0)
K_GRID = (0.0001, 0.001, 0.01, 0.1, 1.0)


@pytest.fixture(autouse=True)
def _fresh_port_calibration_store():
    """The port's calibration store is process-wide planner input: samples
    an ``auto`` engine feeds in one test would reach later tests' plans."""
    prev = calibrate.set_store(calibrate.CalibrationStore())
    yield
    calibrate.set_store(prev)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    fn = GRAPHS[request.param]
    return fn(tg), fn(jg)


@pytest.fixture
def fresh_logs():
    """A fresh decision log in each package for the test's duration."""
    prev_t = explain.set_log(explain.DecisionLog())
    prev_j = jexplain.set_log(jexplain.DecisionLog())
    yield explain.get_log(), jexplain.get_log()
    explain.set_log(prev_t)
    jexplain.set_log(prev_j)


def test_cost_model_matches_jax(graphs):
    g_t, g_j = graphs
    assert autotune.EDGE_TILE_CANDIDATES == jauto.EDGE_TILE_CANDIDATES
    assert autotune.BSR_CANDIDATES == jauto.BSR_CANDIDATES
    assert autotune.BSR_MIN_OCCUPANCY == jauto.BSR_MIN_OCCUPANCY
    for tile, e1, e2 in autotune.EDGE_TILE_CANDIDATES:
        assert (autotune.estimate_edge_tile_cost(g_t, tile=tile, e1=e1, e2=e2)
                == jauto.estimate_edge_tile_cost(g_j, tile=tile, e1=e1,
                                                 e2=e2))
    for ts, td in autotune.BSR_CANDIDATES:
        assert (autotune.estimate_bsr_cost(g_t, ts=ts, td=td)
                == jauto.estimate_bsr_cost(g_j, ts=ts, td=td))
        assert (autotune.bsr_occupancy(g_t, ts=ts, td=td)
                == jauto.bsr_occupancy(g_j, ts=ts, td=td))
    assert autotune.graph_fingerprint(g_t) == jauto.graph_fingerprint(g_j)


def test_model_only_plan_and_prunes_match_jax(graphs, fresh_logs):
    g_t, g_j = graphs
    log_t, log_j = fresh_logs
    p_t = autotune.plan_regime(g_t, cache=None, calibration=None)
    p_j = jauto.plan_regime(g_j, cache=None, calibration=None)
    assert (p_t.label(), p_t.est_bytes, p_t.source) == \
        (p_j.label(), p_j.est_bytes, p_j.source)
    rec_t = log_t.last(kind="regime_plan")
    rec_j = log_j.last(kind="regime_plan")
    assert [(p.name, p.reason) for p in rec_t.pruned] == \
        [(p.name, p.reason) for p in rec_j.pruned]
    assert [(c.name, c.est, c.chosen) for c in rec_t.candidates] == \
        [(c.name, c.est, c.chosen) for c in rec_j.candidates]


def test_serve_graph_plan_is_edge_tile_512():
    g = GRAPHS["serve"](tg)
    plan = autotune.plan_regime(g, cache=None, calibration=None)
    assert plan.label() == "edge_tile(tile=512,e1=8,e2=128)"


def test_choose_solver_golden_table_matches_jax():
    class Shape:
        n, m = 100_000, 1_500_000
    table = {}
    for dirty in DIRTY_GRID:
        for k in K_GRID:
            c_t = autotune.choose_solver(Shape, dirty_frac=dirty, k_frac=k)
            c_j = jauto.choose_solver(Shape, dirty_frac=dirty, k_frac=k)
            assert (c_t.solver, c_t.push_edges, c_t.global_edges) == \
                (c_j.solver, c_j.push_edges, c_j.global_edges)
            table[dirty, k] = c_t.solver
    # the golden table of the JAX package: global only at the corner
    assert [key for key, v in table.items() if v == "global"] == [(1.0, 1.0)]
    with pytest.raises(ValueError, match="dirty_frac"):
        autotune.choose_solver(Shape, dirty_frac=1.5)


def test_plan_cache_hits_under_an_activity_patch():
    g = GRAPHS["sparse"](tg)
    cache = autotune.PlanCache()
    eng = tc.make_engine("auto", graph=g,
                         activity=tc.heterogeneous(g.n, seed=4),
                         device="cpu", plan_cache=cache)
    plan = eng.plan
    assert (cache.hits, cache.misses) == (0, 1)
    assert eng.patch_activity(np.asarray([3, 9]), lam=np.asarray([2.0, 0.5]))
    eng.prepare(g, eng.activity)                  # warm re-prepare
    assert (cache.hits, cache.misses) == (1, 1)
    assert eng.plan is plan and eng.regime == plan.regime
    autotune.plan_regime(tg.erdos_renyi(200, 900, seed=1), device="cpu",
                         cache=cache)
    assert cache.misses == 2                      # another structure


def test_microbench_on_cpu_times_only_kept_candidates(monkeypatch):
    g_s, g_c = GRAPHS["sparse"](tg), GRAPHS["clustered"](tg)
    timed = []
    real = autotune._microbench_step

    def spy(graph, plan, dtype, device):
        timed.append(plan.label())
        return real(graph, plan, dtype, device)
    monkeypatch.setattr(autotune, "_microbench_step", spy)
    plan = autotune.plan_regime(g_s, microbench=True, device="cpu",
                                cache=None, calibration=None)
    assert plan.source == "microbench" and plan.measured_us > 0
    assert timed == [f"edge_tile(tile={t},e1={a},e2={b})"
                     for t, a, b in autotune.EDGE_TILE_CANDIDATES]
    timed.clear()
    plan = autotune.plan_regime(g_c, microbench=True, device="cpu",
                                cache=None, calibration=None)
    assert plan.source == "microbench"
    assert sum(label.startswith("bsr") for label in timed) == len(
        autotune.BSR_CANDIDATES)


@pytest.mark.parametrize("gname", ["sparse", "clustered"])
def test_microbench_cpu_path_returns_one_plan(gname):
    """On the CPU the microbench times the plain push of each candidate on
    the host clock (the card's many-launch protocol needs CUDA events):
    every candidate gets a positive time and the pick is one of them."""
    g = GRAPHS[gname](tg)
    plan = autotune.plan_regime(g, microbench=True, device="cpu",
                                cache=None, calibration=None)
    assert isinstance(plan, autotune.RegimePlan)
    assert plan.source == "microbench" and plan.measured_us > 0
    labels = [f"edge_tile(tile={t},e1={a},e2={b})"
              for t, a, b in autotune.EDGE_TILE_CANDIDATES] + [
        f"bsr(ts={ts},td={td})" for ts, td in autotune.BSR_CANDIDATES]
    assert plan.label() in labels
    us = autotune._microbench_step(g, plan, torch.float32,
                                   torch.device("cpu"))
    assert isinstance(us, float) and us > 0


def _scripted_runs(outcomes):
    """A microbench ``run`` that plays ``outcomes`` ((covered, µs), ...) in
    turn and records the spin it was given each time."""
    spins, it = [], iter(outcomes)

    def run(spin_ms):
        spins.append(spin_ms)
        return next(it)
    return run, spins


@pytest.mark.parametrize("outcomes,want,want_spins", [
    # three covered runs: the least of them, the spin never doubled
    ([(True, 12.0), (True, 10.5), (True, 11.0)], 10.5, [1.0, 1.0, 1.0]),
    # an exposed run (a host time, small) is never taken; its spin doubles
    ([(False, 3.0), (True, 12.0), (False, 2.0), (True, 11.0), (True, 13.0)],
     11.0, [1.0, 2.0, 2.0, 4.0, 4.0]),
    # fewer than three covered runs in eight: the least covered one
    ([(False, 1.0)] * 7 + [(True, 20.0)], 20.0,
     [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]),
])
def test_microbench_uses_only_covered_runs(outcomes, want, want_spins):
    run, spins = _scripted_runs(outcomes)
    assert autotune._least_covered(run, 1.0) == want
    assert spins == want_spins


def test_microbench_raises_when_no_run_is_covered():
    run, spins = _scripted_runs([(False, 1.0)] * autotune._MB_MAX_RUNS)
    with pytest.raises(RuntimeError, match="host's issue"):
        autotune._least_covered(run, 1.0)
    assert len(spins) == autotune._MB_MAX_RUNS


def _bench_bsr_wins(graph, plan, dtype, device):
    return 100.0 if plan.regime == "bsr" else 5_000.0


def test_calibrated_ranking_flips_the_plan_as_in_jax(monkeypatch):
    g_t, g_j = (GRAPHS["clustered"](m) for m in (tg, jg))
    monkeypatch.setattr(autotune, "_microbench_step", _bench_bsr_wins)
    monkeypatch.setattr(jauto, "_microbench_step",
                        lambda graph, plan, dtype, interpret:
                        _bench_bsr_wins(graph, plan, dtype, None))
    store_t = calibrate.CalibrationStore()
    store_j = jcal.CalibrationStore(env="test|cpu|False")
    out = []
    for plan_regime, g, store, kw in (
            (autotune.plan_regime, g_t, store_t, dict(device="cpu")),
            (jauto.plan_regime, g_j, store_j, {})):
        uncal = plan_regime(g, cache=None, calibration=None,
                            slot_bytes=SKEW, **kw)
        bench = plan_regime(g, cache=None, microbench=True,
                            calibration=store, slot_bytes=SKEW, **kw)
        recovered = plan_regime(g, cache=None, calibration=store,
                                slot_bytes=SKEW, **kw)
        out.append([(p.label(), p.source) for p in (uncal, bench,
                                                      recovered)])
    assert out[0] == out[1]
    (u, _), (b, _), (r, src) = out[0]
    assert u.startswith("edge_tile") and b.startswith("bsr")
    assert r.startswith("bsr") and src == "calibrated"
    # the samples sit under the CPU float32 key only: a float64 plan on the
    # same store is not corrected by them
    key32 = calibrate.env_key("cpu", torch.float32)
    assert {e for e, _ in store_t._samples} == {key32}
    f64 = autotune.plan_regime(g_t, cache=None, calibration=store_t,
                               slot_bytes=SKEW, device="cpu",
                               dtype=torch.float64)
    assert f64.source == "model" and f64.label() == u


def test_env_key_separates_device_and_dtype():
    k32 = calibrate.env_key("cpu", torch.float32)
    k64 = calibrate.env_key("cpu", torch.float64)
    assert k32.startswith("cpu|") and k32.endswith("|float32")
    assert k64.endswith("|float64") and k32 != k64
    with pytest.raises(ValueError, match="env"):
        calibrate.CalibrationStore().observe("bsr", 1.0, 2.0)


def test_auto_engine_feeds_its_calibration_key():
    g = tg.powerlaw_configuration(400, 2_400, seed=9)
    store = calibrate.CalibrationStore(min_samples=1)
    prev = calibrate.set_store(store)
    try:
        eng = tc.make_engine("auto", graph=g,
                             activity=tc.heterogeneous(g.n, seed=10),
                             dtype=torch.float64, device="cpu",
                             plan_cache=autotune.PlanCache())
        res = eng.run(tol=1e-10)
    finally:
        calibrate.set_store(prev)
    assert res.converged and res.iterations > 3
    assert list(store._samples) == [
        (calibrate.env_key("cpu", torch.float64), eng.plan.regime)]


def test_make_engine_auto_options_and_device_rule():
    eng = tc.make_engine("auto", microbench=True, device="cpu")
    assert isinstance(eng, tc.AutoEngine) and eng.microbench
    with pytest.raises(ValueError, match="unknown engine option"):
        tc.make_engine("auto", device="cpu", interpret=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.make_engine("auto")
        g = GRAPHS["er"](tg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            autotune.plan_regime(g, microbench=True, cache=None,
                                 calibration=None)
