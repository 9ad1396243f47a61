"""The port's streaming ingestion (``repro_torch.stream``) against the JAX
package's (``repro.stream``): the counterparts of ``tests/test_stream.py``,
event logs and estimator state bit for bit, ingest parity (resolves, churn,
freshness, per-resolve iterations, ψ), the fleet target's routing, the push
certificate and ``serve --stream``.

Same seeded inputs through both packages in one process; the port runs with
``device="cpu"`` (its ``cuda`` backend then runs the kernels' plain
versions) and JAX runs at float64 inside ``_x64()`` where ψ is compared.
The obs sinks are process-global in both packages, so every test here runs
on fresh ones (:func:`_fresh_sinks`).
"""
import argparse
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jc
import repro.graphs as jg
import repro.stream as js
import repro_torch.core as tc
import repro_torch.graphs as tg
import repro_torch.stream as ts
from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.core.activity import RATE_FLOOR
from repro_torch.graphs.structure import Graph
from repro_torch.stream import (Follow, FreshnessPolicy, FreshnessReport,
                                Post, RateEstimator, Repost, StreamIngestor,
                                TenantEvent, Unfollow)
from test_torch_cuda import overflow_follows


def _x64():
    """JAX's float64 switch as a context manager, across jax versions."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


@pytest.fixture(autouse=True)
def _fresh_sinks():
    """Fresh metrics, tracker and decision log in both packages for each
    test, and a fresh calibration store in the port (the JAX package's is
    fresh per test already), restored afterwards (they are
    process-global)."""
    prev_t = tobs.configure(registry=tobs.MetricsRegistry(),
                            tracker=tobs.ConvergenceTracker(keep=4096),
                            decisions=tobs.DecisionLog())
    prev_j = jobs.configure(registry=jobs.MetricsRegistry(),
                            tracker=jobs.ConvergenceTracker(keep=4096),
                            decisions=jobs.DecisionLog())
    prev_store = tobs.calibrate.set_store(tobs.CalibrationStore())
    yield
    tobs.calibrate.set_store(prev_store)
    tobs.restore(prev_t)
    jobs.restore(prev_j)


def cold_activity(n: int) -> tc.Activity:
    return tc.Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))


def batch_psi(graph, activity, *, tol=1e-9):
    """From-scratch port reference solve (f64 on the CPU) — the oracle."""
    return tc.make_engine("reference", graph=graph, activity=activity,
                          dtype=torch.float64, device="cpu"
                          ).run(tol=tol).psi.numpy()


def _events(log) -> list:
    """A log as plain tuples: the event's class name and its fields."""
    out = []
    for ev in log:
        inner = ev.event if type(ev).__name__ == "TenantEvent" else None
        if inner is not None:
            out.append(("TenantEvent", ev.tenant, type(inner).__name__,
                        dataclasses.astuple(inner)))
        else:
            out.append((type(ev).__name__, dataclasses.astuple(ev)))
    return out


def _service_iters(tracker) -> list[int]:
    return [r.iterations for r in tracker.series(None)]


# --------------------------------------------------------------------- #
# Event log: the port's generators give JAX's logs, event for event
# --------------------------------------------------------------------- #
def test_replay_log_is_deterministic_and_reiterable():
    act = tc.heterogeneous(16, seed=3)
    a = ts.poisson_stream(act, 50.0, seed=9)
    b = ts.poisson_stream(act, 50.0, seed=9)
    assert len(a) > 0 and list(a) == list(b)
    assert list(a) == list(a)                      # re-iteration is identical
    ts_ = [ev.t for ev in a]
    assert ts_ == sorted(ts_)
    assert set(a.counts()) == {"Post", "Repost"}
    ref = js.poisson_stream(jc.heterogeneous(16, seed=3), 50.0, seed=9)
    assert _events(a) == _events(ref) and a.counts() == ref.counts()


def test_poisson_stream_with_graph_matches_jax():
    g = tg.powerlaw_configuration(200, 1200, seed=7)
    a = ts.poisson_stream(tc.heterogeneous(200, seed=8), 3.0, seed=9,
                          graph=g)
    ref = js.poisson_stream(jc.heterogeneous(200, seed=8), 3.0, seed=9,
                            graph=jg.powerlaw_configuration(200, 1200,
                                                            seed=7))
    assert len(a) > 100 and _events(a) == _events(ref)


def test_burst_stream_matches_jax():
    users = np.asarray([1, 5, 9])
    a = ts.burst_stream(tc.heterogeneous(12, seed=2), 40.0,
                        burst_users=users, burst_factor=10.0, seed=4)
    ref = js.burst_stream(jc.heterogeneous(12, seed=2), 40.0,
                          burst_users=users, burst_factor=10.0, seed=4)
    assert len(a) > 0 and _events(a) == _events(ref)


def test_flash_crowd_contains_follows_and_tombstones():
    g = tg.powerlaw_configuration(100, 500, seed=4)
    act = tc.heterogeneous(100, seed=5)
    log = ts.flash_crowd_stream(g, act, 30.0, new_followers=20, churn=0.5,
                                seed=6)
    c = log.counts()
    assert c.get("Follow", 0) == 20
    assert c.get("Unfollow", 0) == 10
    followed = {(e.follower, e.leader) for e in log
                if isinstance(e, Follow)}
    for e in log:
        if isinstance(e, Unfollow):
            assert (e.follower, e.leader) in followed
    ref = js.flash_crowd_stream(jg.powerlaw_configuration(100, 500, seed=4),
                                jc.heterogeneous(100, seed=5), 30.0,
                                new_followers=20, churn=0.5, seed=6)
    assert _events(log) == _events(ref)


def test_tenant_interleave_merges_by_time():
    act = tc.heterogeneous(8, seed=1)
    log = ts.tenant_interleave({"a": ts.poisson_stream(act, 20.0, seed=2),
                                "b": ts.poisson_stream(act, 20.0, seed=3)})
    t = [ev.t for ev in log]
    assert t == sorted(t)
    assert {ev.tenant for ev in log} == {"a", "b"}
    jact = jc.heterogeneous(8, seed=1)
    ref = js.tenant_interleave({"a": js.poisson_stream(jact, 20.0, seed=2),
                                "b": js.poisson_stream(jact, 20.0, seed=3)})
    assert _events(log) == _events(ref)


# --------------------------------------------------------------------- #
# Estimator: JAX's arithmetic on the same events, and its state layout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("regime", ["heterogeneous", "homogeneous"])
def test_estimator_recovers_generator_rates(regime):
    n = 6
    truth = (tc.heterogeneous(n, seed=11, low=0.2, high=1.0)
             if regime == "heterogeneous" else tc.homogeneous(n))
    horizon = 30_000 / float(truth.total.sum())
    log = ts.poisson_stream(truth, horizon, seed=12)
    est = RateEstimator(n, half_life=horizon)
    ref = js.RateEstimator(n, half_life=horizon)
    for ev in log:
        est.observe(ev)
    for ev in js.poisson_stream(jc.Activity(truth.lam, truth.mu), horizon,
                                seed=12):
        ref.observe(ev)
    lam, mu = est.rates(horizon)
    err = (np.abs(lam - truth.lam).sum()
           + np.abs(mu - truth.mu).sum()) / float(truth.total.sum())
    assert err <= 0.05
    for a, b in zip((lam, mu), ref.rates(horizon)):
        np.testing.assert_array_equal(a, b)


def test_estimator_cold_start_floor_and_dirty_drain():
    est = RateEstimator(4, half_life=10.0)
    lam, mu = est.rates(0.0)
    assert np.all(lam == RATE_FLOOR) and np.all(mu == RATE_FLOOR)
    assert est.dirty.size == 0 and est.pending_mass() == 0.0
    ref = js.RateEstimator(4, half_life=10.0)
    for (kind, t, u) in [(Post, 1.0, 2), (Repost, 1.5, 2), (Post, 2.0, 0)]:
        est.observe(kind(t, u))
        ref.observe(getattr(js, kind.__name__)(t, u))
    assert est.dirty.tolist() == [0, 2]
    mass_before = est.pending_mass(2.0)
    assert mass_before > 0.0 and mass_before == ref.pending_mass(2.0)
    users, lam_d, mu_d, mass = est.drain(2.0)
    ref_out = ref.drain(2.0)
    assert users.tolist() == [0, 2]
    assert np.all(lam_d >= RATE_FLOOR) and np.all(mu_d >= RATE_FLOOR)
    assert mass == pytest.approx(mass_before)
    for a, b in zip((users, lam_d, mu_d, mass), ref_out):
        np.testing.assert_array_equal(a, b)
    assert est.dirty.size == 0 and est.pending_mass(2.0) == 0.0
    empty, _, _, zero = est.drain()
    assert empty.size == 0 and zero == 0.0


def test_estimator_validation():
    with pytest.raises(ValueError, match="half_life"):
        RateEstimator(4, half_life=0.0)
    with pytest.raises(ValueError, match="floor"):
        RateEstimator(4, floor=0.0)
    est = RateEstimator(4)
    with pytest.raises(TypeError, match="Post/Repost"):
        est.observe(Follow(0.0, 1, 2))
    with pytest.raises(ValueError, match="out of range"):
        est.observe(Post(0.0, 7))
    with pytest.raises(ValueError, match="non-finite"):
        est.observe(Post(float("nan"), 1))


def test_estimator_half_life_tracks_burst():
    """A short half-life follows the burst up; the estimate at burst end
    exceeds the stationary rate (and equals JAX's)."""
    n = 4
    truth = tc.Activity(np.full(n, 0.5), np.full(n, 0.5))
    horizon = 600.0
    log = ts.burst_stream(truth, horizon, burst_users=np.asarray([1]),
                          burst_factor=10.0, seed=7)
    est = RateEstimator(n, half_life=20.0)
    ref = js.RateEstimator(n, half_life=20.0)
    jlog = js.burst_stream(jc.Activity(truth.lam, truth.mu), horizon,
                           burst_users=np.asarray([1]), burst_factor=10.0,
                           seed=7)
    for ev, jev in zip(log, jlog):
        if ev.t <= 2 * horizon / 3:            # stop at the burst window end
            est.observe(ev)
            ref.observe(jev)
    lam, _ = est.rates(2 * horizon / 3)
    assert lam[1] > 2.0                        # way above the base 0.5
    assert lam[0] < 1.5                        # non-burst users stay near base
    np.testing.assert_array_equal(lam, ref.rates(2 * horizon / 3)[0])


def test_estimator_state_dict_is_jax_layout_and_loads_across():
    """After the same log the two estimators' state dicts are bitwise
    equal; a JAX state loaded into the port drains the same rates."""
    act = tc.heterogeneous(40, seed=21)
    log = ts.poisson_stream(act, 30.0, seed=22)
    jlog = js.poisson_stream(jc.heterogeneous(40, seed=21), 30.0, seed=22)
    est, ref = (RateEstimator(40, half_life=8.0),
                js.RateEstimator(40, half_life=8.0))
    half = len(log) // 2
    for k, (ev, jev) in enumerate(zip(log, jlog)):
        est.observe(ev)
        ref.observe(jev)
        if k == half:                          # a drain mid-stream
            est.drain()
            ref.drain()
    a, b = est.state_dict(), ref.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    moved = RateEstimator(40, half_life=8.0)
    moved.load_state(ref.state_dict())
    for x, y in zip(moved.drain(), ref.drain()):
        np.testing.assert_array_equal(x, y)
    assert moved.state_dict()["scalars"].tolist() == \
        ref.state_dict()["scalars"].tolist()


# --------------------------------------------------------------------- #
# Satellites: Activity floor, host edge removal, empty deltas
# --------------------------------------------------------------------- #
def test_activity_accepts_silent_users_and_floors_them():
    act = tc.Activity(np.asarray([0.0, 0.5]), np.asarray([0.0, 0.5]))
    assert act.total[0] == 0.0
    fl = act.floored()
    assert np.all(fl.lam > 0) and np.all(fl.mu > 0)
    assert fl.lam[1] == 0.5
    with pytest.raises(ValueError, match="floor"):
        act.floored(0.0)
    with pytest.raises(ValueError, match="finite"):
        tc.Activity(np.asarray([np.nan]), np.asarray([1.0]))


def test_host_remove_edges_matches_rebuild_and_jax():
    g = tg.erdos_renyi(40, 200, seed=13)
    act = tc.heterogeneous(40, seed=14)
    host = tc.HostOperators.from_graph(g, act)
    jhost = jc.HostOperators.from_graph(jg.erdos_renyi(40, 200, seed=13),
                                        jc.heterogeneous(40, seed=14))
    rng = np.random.default_rng(15)
    drop = rng.permutation(g.m)[:50]
    j = int(g.src[drop[0]])
    extra = np.nonzero(g.src == j)[0]
    drop = np.unique(np.concatenate([drop, extra]))
    removed_src, removed_dst = host.remove_edges(g.src[drop], g.dst[drop])
    jhost.remove_edges(g.src[drop], g.dst[drop])
    assert removed_src.size == drop.size
    keep = np.setdiff1d(np.arange(g.m), drop)
    ref = tc.HostOperators.from_graph(Graph(g.n, g.src[keep], g.dst[keep]),
                                      act)
    for f in ("src_by_src", "dst_by_dst", "w", "row_lam"):
        np.testing.assert_array_equal(getattr(host, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(host, f), getattr(jhost, f))
    assert host.w[j] == 0.0
    again = host.remove_edges(removed_src[:3], removed_dst[:3])
    assert again[0].size == 0


def test_service_empty_delta_is_a_true_noop():
    g = tg.erdos_renyi(60, 240, seed=16)
    svc = tc.PsiService(g, tc.heterogeneous(60, seed=17), tol=1e-8,
                        device="cpu")
    svc.scores()
    cache, ops = svc._cache, svc.engine.ops
    svc.update_activity(np.empty(0, np.int64))
    svc.add_edges(np.empty(0, np.int32), np.empty(0, np.int32))
    svc.remove_edges(np.empty(0, np.int32), np.empty(0, np.int32))
    assert svc._cache is cache and svc.engine.ops is ops
    assert not svc.stale


def test_fleet_empty_activity_patch_keeps_tenant_clean():
    from repro_torch.serving import TenantFleet
    g = tg.erdos_renyi(50, 200, seed=18)
    fleet = TenantFleet(backend="dense", tol=1e-7, device="cpu")
    fleet.admit("t0", g, tc.heterogeneous(50, seed=19))
    fleet.solve()
    epoch = fleet.stats("t0")["epoch"]
    fleet.patch_activity("t0", np.empty(0, np.int64))
    assert fleet.stats("t0")["epoch"] == epoch
    assert fleet.solve() == 0


# --------------------------------------------------------------------- #
# Deferred resolve + edge removal on PsiService
# --------------------------------------------------------------------- #
def test_service_deferred_patches_serve_stale_then_resolve():
    g = tg.erdos_renyi(60, 240, seed=20)
    act = tc.heterogeneous(60, seed=21)
    svc = tc.PsiService(g, act, tol=1e-9, dtype=torch.float64, device="cpu")
    before = svc.scores().copy()
    svc.update_activity(np.asarray([3]), lam=np.asarray([5.0]),
                        resolve=False)
    assert svc.stale
    np.testing.assert_array_equal(svc.scores(), before)   # stale by design
    assert tobs.metrics.get_registry().value(
        "psi_query_stale_reads_total") == 1
    svc.resolve()
    assert not svc.stale
    lam2 = act.lam.copy()
    lam2[3] = 5.0
    psi_true, _ = tc.exact_psi(g, tc.Activity(lam2, act.mu))
    assert np.abs(svc.scores() - psi_true).max() <= 1e-6


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_service_remove_edges_reaches_filtered_fixed_point(backend):
    g = tg.erdos_renyi(50, 220, seed=22)
    act = tc.heterogeneous(50, seed=23)
    svc = tc.PsiService(g, act, tol=1e-9, backend=backend,
                        dtype=torch.float64, device="cpu")
    svc.scores()
    rng = np.random.default_rng(24)
    drop = rng.permutation(g.m)[:30]
    svc.remove_edges(g.src[drop], g.dst[drop])
    keep = np.setdiff1d(np.arange(g.m), drop)
    psi_true, _ = tc.exact_psi(Graph(g.n, g.src[keep], g.dst[keep]), act)
    assert np.abs(svc.scores() - psi_true).max() <= 1e-6
    assert svc.graph.m == g.m - drop.size


# --------------------------------------------------------------------- #
# Ingest → resolve parity: against the batch solve and against JAX
# --------------------------------------------------------------------- #
def _flash(pkg_core, pkg_graphs, pkg_stream, *, n, m, events, followers,
           churn, seeds):
    g = pkg_graphs.powerlaw_configuration(n, m, seed=seeds[0])
    truth = pkg_core.heterogeneous(n, seed=seeds[1])
    horizon = events / float(truth.total.sum())
    log = pkg_stream.flash_crowd_stream(g, truth, horizon,
                                        new_followers=followers, churn=churn,
                                        seed=seeds[2])
    return g, truth, horizon, log


def test_ingest_service_parity_flash_crowd():
    n, m = 200, 1_200
    g, truth, horizon, log = _flash(tc, tg, ts, n=n, m=m, events=1_500,
                                    followers=24, churn=0.5,
                                    seeds=(25, 26, 27))
    svc = tc.PsiService(g, cold_activity(n), tol=1e-9, dtype=torch.float64,
                        device="cpu")
    ing = StreamIngestor(svc, half_life=horizon / 2,
                         policy=FreshnessPolicy(coalesce=32,
                                                resolve_every=400))
    rep = ing.ingest(log)
    assert rep.resolves >= 2 and rep.events_total == len(log)
    assert rep.staleness_events == 0
    psi_batch = batch_psi(svc.graph, svc.engine.activity)
    assert np.abs(svc.scores() - psi_batch).max() <= 1e-6
    assert svc.graph.m != g.m
    est = ing.estimator()
    assert est.dirty.size == 0 and est.pending_mass() == 0.0
    served = svc.engine.activity
    np.testing.assert_allclose(served.lam, est._synced[0], rtol=1e-12)
    np.testing.assert_allclose(served.mu, est._synced[1], rtol=1e-12)
    reg = tobs.metrics.get_registry()
    assert reg.value("psi_stream_resolves_total") == rep.resolves
    assert {k: int(reg.value("psi_stream_events_total", kind=k.lower()))
            for k in log.counts()} == log.counts()
    assert len(_service_iters(tobs.convergence.get_tracker())) == \
        rep.resolves + 1                          # + the batch oracle's run


def _jax_check_ingest(log, n, m, seed, horizon, backend="reference",
                      limit=None):
    """The JAX package's ``stream.check`` ingest (f64) of ``log``."""
    g = jg.powerlaw_configuration(n, m, seed=seed)
    cold = jc.Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))
    with _x64():
        svc = jc.PsiService(g, cold, tol=1e-9, backend=backend,
                            dtype=jnp.float64)
        ing = js.StreamIngestor(svc, half_life=horizon / 2,
                                policy=js.FreshnessPolicy(
                                    coalesce=64, resolve_every=500))
        rep = ing.ingest(log, limit=limit)
        psi = np.asarray(svc.scores())
    return svc, ing, rep, psi


@pytest.fixture(scope="module")
def check_log():
    """``stream.check``'s flash-crowd log in both packages (2,000 events on
    ``powerlaw_configuration(512, 3000, seed=5)``)."""
    n, m, seed, events = 512, 3_000, 5, 2_000
    _, _, horizon, log = _flash(tc, tg, ts, n=n, m=m, events=events,
                                followers=48, churn=0.3,
                                seeds=(seed, seed + 1, seed + 2))
    _, _, jhorizon, jlog = _flash(jc, jg, js, n=n, m=m, events=events,
                                  followers=48, churn=0.3,
                                  seeds=(seed, seed + 1, seed + 2))
    assert horizon == jhorizon and _events(log) == _events(jlog)
    return dict(n=n, m=m, seed=seed, horizon=horizon, log=log, jlog=jlog)


def _port_check_ingest(c, backend, limit=None):
    g = tg.powerlaw_configuration(c["n"], c["m"], seed=c["seed"])
    svc = tc.PsiService(g, cold_activity(c["n"]), tol=1e-9, backend=backend,
                        dtype=torch.float64, device="cpu")
    ing = StreamIngestor(svc, half_life=c["horizon"] / 2,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=500))
    rep = ing.ingest(c["log"], limit=limit)
    return svc, ing, rep


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_stream_check_ingest_matches_jax(check_log, backend):
    """The ``stream.check`` log through both packages' ingestors: the same
    resolves, churn, freshness report and per-resolve iterations; ψ within
    1e-12 of JAX's f64 ``reference`` (the port's ``cuda`` backend runs
    ``power_step``'s plain version)."""
    c = check_log
    svc, ing, rep = _port_check_ingest(c, backend)
    iters = _service_iters(tobs.convergence.get_tracker())
    jsvc, jing, jrep, jpsi = _jax_check_ingest(
        c["jlog"], c["n"], c["m"], c["seed"], c["horizon"])
    jiters = _service_iters(jobs.convergence.get_tracker())
    assert rep.resolves == jrep.resolves >= 3
    assert ing.churn_history == jing.churn_history
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert iters == jiters and len(iters) == rep.resolves
    assert np.abs(svc.scores() - jpsi).max() <= 1e-12
    assert svc.graph.m == jsvc.graph.m
    np.testing.assert_array_equal(svc.engine.activity.lam,
                                  jsvc.engine.activity.lam)


def test_stream_check_ingest_matches_jax_pallas_interpret(check_log):
    """A short prefix of the same log against JAX's ``pallas`` engine in
    interpret mode: the same iterations, ψ within 1e-12."""
    c = check_log
    svc, ing, rep = _port_check_ingest(c, "cuda", limit=600)
    _, jing, jrep, jpsi = _jax_check_ingest(
        c["jlog"], c["n"], c["m"], c["seed"], c["horizon"],
        backend="pallas", limit=600)
    assert rep.resolves == jrep.resolves == 2
    assert _service_iters(tobs.convergence.get_tracker()) == \
        _service_iters(jobs.convergence.get_tracker())
    assert np.abs(svc.scores() - jpsi).max() <= 1e-12


def test_stream_check_cli_passes_on_cpu():
    from repro_torch.stream.check import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--device", "cpu"])
    assert rc == 0, out.getvalue()
    lines = out.getvalue().splitlines()
    assert lines[0].endswith("OK") and lines[1].endswith("OK")
    assert "on cpu" in lines[1]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.launch.serve import main
    from repro_torch.stream.check import psi_parity
    with pytest.raises(RuntimeError, match="cuda"):
        psi_parity(200, 5, 100)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "psi-score", "--stream", "flash",
              "--stream-events", "200"])


def test_ingest_fleet_routes_tenant_events_as_jax():
    from repro.serving import TenantFleet as JFleet
    from repro_torch.serving import TenantFleet
    fleet = TenantFleet(backend="dense", tol=1e-8, device="cpu")
    jfleet = JFleet(backend="dense", tol=1e-8)
    sources, jsources = {}, {}
    for k, tid in enumerate(("alpha", "beta")):
        g = tg.erdos_renyi(64, 300, seed=30 + k)
        jg_ = jg.erdos_renyi(64, 300, seed=30 + k)
        fleet.admit(tid, g, cold_activity(64))
        jfleet.admit(tid, jg_, jc.Activity(np.full(64, RATE_FLOOR),
                                           np.full(64, RATE_FLOOR)))
        sources[tid] = ts.flash_crowd_stream(
            g, tc.heterogeneous(64, seed=40 + k), 60.0, new_followers=10,
            churn=0.4, seed=50 + k)
        jsources[tid] = js.flash_crowd_stream(
            jg_, jc.heterogeneous(64, seed=40 + k), 60.0, new_followers=10,
            churn=0.4, seed=50 + k)
    log = ts.tenant_interleave(sources)
    jlog = js.tenant_interleave(jsources)
    assert _events(log) == _events(jlog)
    policy = dict(coalesce=32, resolve_every=300)
    ing = StreamIngestor(fleet, half_life=30.0,
                         policy=FreshnessPolicy(**policy))
    jing = js.StreamIngestor(jfleet, half_life=30.0,
                             policy=js.FreshnessPolicy(**policy))
    rep, jrep = ing.ingest(log), jing.ingest(jlog)
    assert rep.resolves == jrep.resolves and rep.events_total == len(log)
    assert ing.churn_history == jing.churn_history
    for tid in sources:
        assert ing.estimator(tid).events == jing.estimator(tid).events
        np.testing.assert_array_equal(ing.estimator(tid).state_dict()["cnt"],
                                      jing.estimator(tid).state_dict()["cnt"])
        g_final = fleet._rec(tid).host.graph()
        assert g_final.m == jfleet._rec(tid).host.graph().m
        psi_batch = batch_psi(g_final, fleet.activity(tid), tol=1e-10)
        assert np.abs(fleet.psi(tid) - psi_batch).max() <= 1e-6
        assert np.abs(fleet.psi(tid) - np.asarray(jfleet.psi(tid))).max() \
            <= 1e-6
    assert ing.estimator("alpha") is not ing.estimator("beta")
    with pytest.raises(TypeError, match="TenantEvent"):
        ing.submit(Post(99.0, 1))
    with pytest.raises(KeyError):
        ing.submit(TenantEvent("nope", Post(99.0, 1)))


def test_ingest_async_driver_target_is_not_ported_yet():
    """The JAX ingestor's third target is ported: the port's
    ``AsyncPsiDriver`` is taken, while the JAX package's object is refused
    with a message that names all three targets."""
    from repro.asyncexec import AsyncPsiDriver
    from repro_torch.asyncexec import AsyncPsiDriver as TAsyncPsiDriver
    drv = AsyncPsiDriver(jg.erdos_renyi(40, 160, seed=42),
                         jc.heterogeneous(40, seed=43), num_chunks=3, tau=1)
    with pytest.raises(TypeError, match="PsiService, TenantFleet") as exc:
        StreamIngestor(drv)
    assert "AsyncPsiDriver" in str(exc.value)
    assert "not ported" not in str(exc.value)
    ing = StreamIngestor(TAsyncPsiDriver(
        tg.erdos_renyi(40, 160, seed=42), tc.heterogeneous(40, seed=43),
        num_chunks=3, tau=1, device="cpu"))
    assert type(ing._adapter).__name__ == "_AsyncDriverTarget"


def test_ingest_rejects_unsupported_target():
    with pytest.raises(TypeError, match="unsupported"):
        StreamIngestor(object())


# --------------------------------------------------------------------- #
# Tombstone netting + freshness semantics
# --------------------------------------------------------------------- #
def test_unfollow_nets_against_pending_follow_in_window():
    g = tg.erdos_renyi(30, 120, seed=36)
    svc = tc.PsiService(g, tc.heterogeneous(30, seed=37), tol=1e-8,
                        device="cpu")
    svc.scores()
    cache = svc._cache
    ing = StreamIngestor(svc, policy=FreshnessPolicy(coalesce=100,
                                                     resolve_every=None))
    existing = set(zip(g.src.tolist(), g.dst.tolist()))
    s, d = next((a, b) for a in range(30) for b in range(30)
                if a != b and (a, b) not in existing)
    ing.submit(Follow(1.0, s, d))
    ing.submit(Unfollow(2.0, s, d))
    ing.flush()
    assert svc.graph.m == g.m
    assert svc._cache is cache
    s0, d0 = int(g.src[0]), int(g.dst[0])
    ing.submit(Unfollow(3.0, s0, d0))
    ing.submit(Follow(4.0, s0, d0))
    ing.flush()
    assert svc.graph.m == g.m
    ing.submit(Unfollow(5.0, s0, d0))
    ing.flush()
    assert svc.graph.m == g.m - 1


def test_edge_flush_that_overflows_a_tile_rebuilds_the_format():
    """The ``cuda`` engine's overflow path under the ingestor (the plain
    versions here; the card test runs the kernels): one window of follows
    into a tile with too few sentinel slots rebuilds the format, and ψ
    after the resolve is the f64 batch solve's."""
    g = tg.powerlaw_configuration(3000, 20000, seed=5)
    act = tc.heterogeneous(g.n, seed=6)
    svc = tc.PsiService(g, act, tol=1e-10, backend="cuda",
                        dtype=torch.float64, device="cpu")
    svc.scores()
    src, dst = overflow_follows(svc, np.random.default_rng(7))
    ing = StreamIngestor(svc, policy=FreshnessPolicy(coalesce=len(src),
                                                     resolve_every=None))
    builds = svc.engine.format_builds
    for k, (s, d) in enumerate(zip(src, dst)):
        ing.submit(Follow(float(k), int(s), int(d)))
    assert svc.engine.format_builds == builds + 1
    assert svc.graph.m == g.m + len(src)
    ing.resolve()
    psi_batch = batch_psi(svc.graph, act, tol=1e-12)
    assert np.abs(svc.scores() - psi_batch).max() <= 1e-10


def test_freshness_policy_and_certification():
    g = tg.erdos_renyi(40, 160, seed=38)
    truth = tc.heterogeneous(40, seed=39)
    svc = tc.PsiService(g, cold_activity(40), tol=1e-8, device="cpu")
    ing = StreamIngestor(svc, half_life=50.0,
                         policy=FreshnessPolicy(coalesce=10,
                                                resolve_every=50))
    log = ts.poisson_stream(truth, 120 / float(truth.total.sum()), seed=40)
    ing.ingest(log, resolve_at_end=False)
    rep = ing.freshness()
    assert isinstance(rep, FreshnessReport)
    assert rep.events_total == len(log)
    assert rep.resolves == len(log) // 50
    assert rep.events_unresolved < 50
    assert rep.events_buffered == 0
    assert rep.certify(max_events=50)
    assert not rep.certify(max_events=0) or rep.events_unresolved == 0
    before = ing.resolves
    ing.top_k(5, max_events=0)
    assert ing.resolves == before + (1 if rep.events_unresolved else 0)
    assert ing.freshness().certify(max_events=0)
    assert all(0.0 <= c <= 1.0 for c in ing.churn_history)


def test_query_driven_first_resolve_updates_freshness_accounting():
    """A query the target can only answer by solving (a ``PsiService``
    never solved yet: ``_ServiceTarget.needs_resolve``) routes through the
    ingestor's resolve(), so the report describes the ranking served."""
    g = tg.erdos_renyi(40, 160, seed=42)
    truth = tc.heterogeneous(40, seed=43)
    svc = tc.PsiService(g, cold_activity(40), tol=1e-9, device="cpu")
    ing = StreamIngestor(svc, half_life=20.0,
                         policy=FreshnessPolicy(coalesce=8,
                                                resolve_every=None))
    log = ts.poisson_stream(truth, 60 / float(truth.total.sum()), seed=44)
    ing.ingest(log, resolve_at_end=False)
    assert ing.resolves == 0 and svc.last_result is None
    ing.top_k(5)                               # no bounds — but never solved
    assert ing.resolves == 1
    rep = ing.freshness()
    assert rep.events_unresolved == 0 and rep.certify(max_events=0)
    before = ing.resolves
    ing.top_k(5, max_events=0)
    assert ing.resolves == before


def test_dirty_mass_trigger_resolves():
    g = tg.erdos_renyi(20, 80, seed=41)
    svc = tc.PsiService(g, cold_activity(20), tol=1e-8, device="cpu")
    ing = StreamIngestor(
        svc, half_life=10.0,
        policy=FreshnessPolicy(coalesce=4, resolve_every=None,
                               max_dirty_mass=0.5))
    for k in range(40):
        ing.submit(Post(0.1 * (k + 1), user=3))
    assert ing.resolves >= 1
    rep = ing.freshness()
    assert rep.dirty_mass <= 0.5 or rep.events_unresolved == 0


def test_ingestor_reports_push_certificate():
    """The ingestor publishes the ``push`` backend's certificate only while
    nothing was ingested on top of the solve it covers (the JAX package's
    ``test_ingestor_reports_push_certificate``)."""
    g = tg.powerlaw_configuration(400, 2600, seed=5)
    svc = tc.PsiService(g, tc.heterogeneous(g.n, seed=6), tol=1e-9,
                        backend="push", device="cpu")
    ing = StreamIngestor(svc)
    ing.ingest([Post(0.5, 3), Repost(0.8, 7)], resolve_at_end=True)
    rep = ing.freshness()
    assert rep.events_unresolved == 0
    assert rep.psi_error_bound is not None
    assert rep.certify(max_psi_error=rep.psi_error_bound * 2)
    assert tobs.metrics.get_registry().value(
        "psi_certified_error_bound") == rep.psi_error_bound
    ing.submit(Post(1.5, 4))
    rep2 = ing.freshness()
    assert rep2.events_unresolved == 1
    assert rep2.psi_error_bound is None
    assert not rep2.certify(max_psi_error=1.0)


# --------------------------------------------------------------------- #
# serve --stream
# --------------------------------------------------------------------- #
def _top(text: str) -> list[int]:
    line = next(ln for ln in text.splitlines()
                if ln.startswith("[serve] top-"))
    return [int(x) for x in line.split("[", 2)[2].rstrip("]").split(",")]


def test_serve_stream_prints_the_jax_clis_top():
    from repro.launch.serve import _serve_stream
    from repro_torch.launch.serve import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", "psi-score", "--stream", "flash", "--device", "cpu",
              "--stream-events", "2000"])
    port = out.getvalue()
    args = argparse.Namespace(stream="flash", stream_events=2000,
                              backend=None, check_every=1, half_life=None,
                              top_k=3, resolve_every=1000, requests=4,
                              batch=4)
    out = io.StringIO()
    with _x64(), contextlib.redirect_stdout(out):
        _serve_stream(args)
    top = _top(port)
    assert len(top) == 3 and top == _top(out.getvalue())
    parity = next(ln for ln in port.splitlines() if "psi parity" in ln)
    assert float(parity.split(": ", 1)[1].split(";")[0]) <= 1e-10


@pytest.mark.parametrize("flag", [["--slo"], ["--watch"], ["--chaos"],
                                  ["--profile-out", "p.folded"]])
def test_serve_flags_not_ported_yet_exit_with_a_message(flag, tmp_path,
                                                        monkeypatch):
    """These four flags once exited "not ported yet"; they are ported now.
    Each runs to its end on the CPU and prints its own epilogue line, and
    none prints the old message."""
    from repro_torch.launch.serve import main
    monkeypatch.chdir(tmp_path)
    want = {"--slo": "[slo] overall:", "--watch": "[watch] 0 anomaly",
            "--chaos": "ResilienceReport",
            "--profile-out": "[profile] folded stacks -> p.folded"}[flag[0]]
    out = io.StringIO()
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracker=tobs.ConvergenceTracker())
    try:
        with contextlib.redirect_stdout(out):
            main(["--arch", "psi-score", "--device", "cpu", *flag])
    finally:
        tobs.restore(prev)
    assert want in out.getvalue() and "not ported" not in out.getvalue()
    if flag[0] == "--profile-out":
        assert (tmp_path / "p.folded").stat().st_size > 0


def test_serve_stream_obs_epilogue_dumps_and_explains(tmp_path):
    import json
    from repro_torch.launch.serve import main
    dump, trace = tmp_path / "dump.json", tmp_path / "trace.jsonl"
    out = io.StringIO()
    prev = tobs.configure()
    try:
        with contextlib.redirect_stdout(out):
            main(["--arch", "psi-score", "--stream", "burst", "--device",
                  "cpu", "--stream-events", "600", "--backend", "cuda",
                  "--metrics-dump", str(dump), "--trace-out", str(trace),
                  "--explain"])
    finally:
        tobs.restore(prev)
    text = out.getvalue()
    for key in ("[obs] query latency", "[obs] stream ingest",
                "[obs] query cache: hit ratio", "[obs] convergence",
                "EXPLAIN ANALYZE — power-ψ [backend=cuda]",
                "[obs] registry dump", "[obs] trace ->"):
        assert key in text, key
    snap = json.loads(dump.read_text())
    assert snap["fingerprint"]["device_platform"] == "cpu"
    assert snap["fingerprint"]["dtype"] == "float64"
    assert "psi_query_seconds" in json.dumps(snap["metrics"])
    spans = [json.loads(ln) for ln in trace.read_text().splitlines()]
    names = {s["name"] for s in spans}
    assert {"stream.ingest", "stream.resolve", "engine.run",
            "query"} <= names
