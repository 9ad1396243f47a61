"""The port's resilience layer (``repro_torch.resilience``) against the JAX
package's (``repro.resilience``): the counterparts of
``tests/test_resilience.py`` (checkpoint hardening, the validation walls,
the seeded fault harness, sentinels and quarantine, the supervisor's
ladder, the chaos gate), then parity with the JAX package: one
``FaultPlan`` gives both packages the same schedule, event for event; the
f64 chaos gate gives the JAX gate's events, offset, recovered step, replay
counts and delivery-fault counts; the supervisor's sync rung gives the JAX
``reference`` ψ.

The port runs with ``device="cpu"``. Tolerances are the JAX tests': the
chaos gate's ψ parity ≤ 1e-12 at float64 (2e-4 at float32), ψ within 1e-5
of the reference after a sync rung, within 1e-6 after a rollback; the sync
rung against JAX's ``reference`` within 1e-12 at float64. The supervisor's
deadlines are 2 s (the JAX tests': 0.25–0.35 s) with 6 s hangs, so that a
healthy retry finishes inside its deadline on a loaded machine.
"""
import contextlib
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jc
import repro.graphs as jg
import repro.resilience as jr
import repro.stream.events as jev
from repro_torch import obs as tobs
from repro_torch.asyncexec import AsyncPsiDriver
from repro_torch.ckpt import checkpoint
from repro_torch.core import (Activity, HostOperators, PsiService,
                              heterogeneous, make_engine)
from repro_torch.graphs import erdos_renyi, powerlaw_configuration
from repro_torch.resilience import (ExactlyOnceReplay, FaultPlan,
                                    LaneQuarantine, ResilientResolver,
                                    ResolveFailure, Sentinels, ServiceGuard,
                                    alpha_norm, psi_residual_bound)
from repro_torch.resilience.check import run_chaos
from repro_torch.serving import BucketPolicy, TenantFleet
from repro_torch.stream.estimator import RateEstimator
from repro_torch.stream.events import poisson_stream

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = dict(device="cpu")
DEADLINE_S = 2.0
HANG_S = 6.0
# the subprocesses this file spawns compute on one core each, so that they
# load the machine lightly beside the other test workers
ONE_CORE = dict(OMP_NUM_THREADS="1", XLA_FLAGS=(
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))


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
    """Fresh obs sinks for each test (they are process-global)."""
    prev = tobs.configure(registry=tobs.MetricsRegistry(),
                          tracker=tobs.ConvergenceTracker(keep=4096),
                          decisions=tobs.DecisionLog())
    yield
    tobs.restore(prev)


def _tree(n=5, salt=0.0):
    return dict(a=np.arange(n) + salt, b=np.full(3, salt))


def _truncate(path: str, frac: float = 0.5) -> None:
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[: max(1, int(len(text) * frac))])


# --------------------------------------------------------------------- #
# checkpoint hardening — torn manifests, missing shards, GC races
# --------------------------------------------------------------------- #
def test_truncated_manifest_falls_back_to_previous_step():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3):
            checkpoint.save(d, s, _tree(salt=float(s)))
        _truncate(os.path.join(d, "step_00000003", "MANIFEST.json"))
        with pytest.warns(RuntimeWarning):
            assert checkpoint.latest_step(d) == 2
        with pytest.warns(RuntimeWarning):
            data = checkpoint.restore_latest(d, _tree())
        assert data is not None and data["a"][0] == 2.0
        with pytest.raises((ValueError, OSError, KeyError)):
            checkpoint.restore(d, 99, _tree())


def test_missing_shard_falls_back():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, _tree(salt=1.0))
        checkpoint.save(d, 2, _tree(salt=2.0))
        shard = glob.glob(os.path.join(d, "step_00000002", "host_*.npz"))[0]
        os.remove(shard)
        with pytest.warns(RuntimeWarning):
            data = checkpoint.restore_latest(d, _tree())
        assert data["a"][0] == 1.0
        assert checkpoint.complete_steps(d) == [1]
        with pytest.raises((ValueError, OSError, KeyError)):
            checkpoint.restore(d, 2, _tree())


def test_gc_race_mid_restore_is_survived():
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3):
            checkpoint.save(d, s, _tree(salt=float(s)))
        step3 = os.path.join(d, "step_00000003")
        for f in glob.glob(os.path.join(step3, "host_*.npz")):
            os.remove(f)                     # manifest still lists them
        with pytest.warns(RuntimeWarning):
            data = checkpoint.restore_latest(d, _tree())
        assert data["a"][0] == 2.0
        checkpoint.save(d, 4, _tree(salt=4.0), keep=2)
        assert 1 not in checkpoint.all_steps(d)


def test_every_checkpoint_torn_returns_none():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, _tree())
        _truncate(os.path.join(d, "step_00000001", "MANIFEST.json"))
        with pytest.warns(RuntimeWarning):
            assert checkpoint.restore_latest(d, _tree()) is None


# --------------------------------------------------------------------- #
# rate validation at every mutation boundary
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small_platform():
    g = erdos_renyi(120, 700, seed=7)
    act = heterogeneous(g.n, seed=8)
    return g, act


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, -0.5])
def test_host_operators_reject_bad_rates(small_platform, bad):
    g, act = small_platform
    host = HostOperators.from_graph(g, act)
    lam0, mu0 = host.lam.copy(), host.mu.copy()
    with pytest.raises(ValueError):
        host.patch_activity(np.asarray([3]), lam=np.asarray([bad]))
    with pytest.raises(ValueError):
        host.patch_activity(np.asarray([3]), mu=np.asarray([bad]))
    assert np.array_equal(host.lam, lam0) and np.array_equal(host.mu, mu0)


def test_psi_service_rejects_bad_rates(small_platform):
    g, act = small_platform
    svc = PsiService(g, act, tol=1e-8, **CPU)
    before = svc.scores().copy()
    with pytest.raises(ValueError):
        svc.update_activity(np.asarray([1]), lam=np.asarray([np.nan]))
    with pytest.raises(ValueError):
        svc.update_activity(np.asarray([1]), mu=np.asarray([-2.0]))
    assert np.array_equal(svc.scores(), before)


def test_estimator_rejects_non_finite_timestamp():
    est = RateEstimator(10)
    est.observe_post(1.0, 3)
    state = est.state_dict()
    with pytest.raises(ValueError):
        est.observe_post(float("nan"), 3)
    with pytest.raises(ValueError):
        est.observe_repost(float("inf"), 4)
    after = est.state_dict()
    assert all(np.array_equal(state[k], after[k]) for k in state)


def test_estimator_state_roundtrip():
    est = RateEstimator(12, half_life=8.0)
    for t in range(1, 30):
        est.observe_post(float(t), t % 12)
        est.observe_repost(float(t) + 0.5, (t * 5) % 12)
    est.drain(20.0)
    clone = RateEstimator(12, half_life=8.0)
    clone.load_state(est.state_dict())
    a, b = est.activity(30.0), clone.activity(30.0)
    assert np.array_equal(a.lam, b.lam) and np.array_equal(a.mu, b.mu)


# --------------------------------------------------------------------- #
# fault harness: determinism + exactly-once transport repair
# --------------------------------------------------------------------- #
def test_faulty_feed_is_deterministic_and_repairable(small_platform):
    g, act = small_platform
    log = poisson_stream(act, 3.0, seed=11, graph=g)
    plan = FaultPlan(seed=3, dup_every=7, drop_every=11, reorder_window=4)

    runs = []
    for _ in range(2):
        clock = plan.clock()
        feed = clock.wrap_source(log)
        runs.append(([*feed], dict(clock.injected)))
    assert runs[0] == runs[1], "same plan, same workload, different faults"
    inj = runs[0][1]
    assert inj["dup"] >= 1 and inj["drop"] >= 1 and inj["reorder"] >= 1

    clock = plan.clock()
    replay = ExactlyOnceReplay(log, clock.wrap_source(log))
    assert list(replay) == list(log)
    assert replay.refetched >= 1 and replay.duplicates_suppressed >= 1

    start = len(log) // 2
    replay = ExactlyOnceReplay(log, clock.wrap_source(log, start=start),
                               start=start)
    assert list(replay) == list(log)[start:]


@pytest.mark.parametrize("kind,field", [("nan", 0), ("inf", 1),
                                        ("negative", 0)])
def test_poisoned_patches_die_at_the_validation_wall(small_platform,
                                                     kind, field):
    g, act = small_platform
    host = HostOperators.from_graph(g, act)
    clock = FaultPlan(seed=5, poison_kind=kind).clock()
    users = np.arange(6)
    pu, pl, pm = clock.poison_patch(users, host.lam[users], host.mu[users])
    bad = pl if field == 0 else pm
    assert not np.all(np.isfinite(bad) & (bad >= 0))
    with pytest.raises(ValueError):
        host.patch_activity(pu, lam=pl, mu=pm)


# --------------------------------------------------------------------- #
# sentinels + quarantine
# --------------------------------------------------------------------- #
def test_sentinels_trip_on_the_right_symptoms(small_platform):
    g, act = small_platform
    s = Sentinels(gap_window=3)
    assert s.check_array("psi", np.ones(4)) is None
    assert s.check_array("psi", np.asarray([1.0, np.nan])).kind == "non_finite"
    # torch tensors are read on their device, as numpy arrays are
    assert s.check_array("psi", torch.ones(4)) is None
    assert s.check_array("psi", torch.tensor([1.0, float("inf")])).kind \
        == "non_finite"
    assert s.check_gap(float("inf")).kind == "non_finite"
    s.reset_gap()
    trips = [s.check_gap(gap) for gap in (1.0, 2.0, 3.0, 4.0)]
    assert trips[:3] == [None, None, None]
    assert trips[3].kind == "gap_growth"
    host = HostOperators.from_graph(g, act)
    a = alpha_norm(host)
    assert 0.0 < a < 1.0
    assert Sentinels(alpha_max=a * 0.9).check_alpha(host).kind == "alpha"
    bound = psi_residual_bound(host, 1e-6)
    assert bound is not None and 0.0 < bound < 1e-3
    assert psi_residual_bound(host, float("nan")) is None
    # α and the certificate are the JAX package's to the last bit
    jhost = jc.HostOperators.from_graph(jg.erdos_renyi(120, 700, seed=7),
                                        jc.heterogeneous(120, seed=8))
    assert a == jr.alpha_norm(jhost)
    assert bound == jr.psi_residual_bound(jhost, 1e-6)


def test_lane_quarantine_freezes_one_tenant_not_the_fleet(small_platform):
    g0, act0 = small_platform
    g1 = powerlaw_configuration(140, 900, seed=21)
    act1 = heterogeneous(g1.n, seed=22)
    fleet = TenantFleet(backend="reference", tol=1e-8,
                        policy=BucketPolicy((512,), edge_quantum=4096),
                        **CPU)
    fleet.admit("t0", g0, act0)
    fleet.admit("t1", g1, act1)
    fleet.solve()
    before = fleet.psi("t0").copy()
    quar = LaneQuarantine(fleet, sentinels=Sentinels(alpha_max=0.999))

    clock = FaultPlan(seed=9, poison_kind="nan").clock()
    users = np.arange(4)
    host0 = fleet._rec("t0").host
    pu, pl, pm = clock.poison_patch(users, host0.lam[users], host0.mu[users])
    assert not quar.patch_activity("t0", pu, lam=pl, mu=pm)
    assert quar.is_frozen("t0") and quar.frozen == ("t0",)
    assert np.array_equal(quar.psi("t0"), before)
    assert not quar.patch_activity("t0", np.asarray([2]),
                                   lam=np.asarray([0.5]))

    assert quar.patch_activity("t1", np.asarray([5]), mu=np.asarray([0.9]))
    assert not quar.is_frozen("t1")
    idx, top = quar.top_k("t1", 5)
    assert idx.shape == (5,) and np.all(np.diff(top) <= 0)

    quar.unfreeze("t0")
    lam0, mu0 = host0.lam.copy(), host0.mu.copy()
    assert not quar.patch_activity("t0", np.asarray([3]),
                                   mu=np.asarray([1e12]))
    assert quar.is_frozen("t0") and quar.reverted_patches == 1
    assert np.array_equal(host0.lam, lam0) and np.array_equal(host0.mu, mu0)


def test_service_guard_rolls_back_to_last_checkpoint(small_platform):
    g, act = small_platform
    with tempfile.TemporaryDirectory() as d:
        svc = PsiService(g, act, tol=1e-8, max_iter=400, **CPU)
        guard = ServiceGuard(svc, d, sentinels=Sentinels(alpha_max=0.999))
        assert guard.update_activity(np.asarray([4]), lam=np.asarray([1.3]))
        good = guard.scores().copy()
        rates = svc.engine.activity

        assert not guard.update_activity(np.asarray([4]),
                                         lam=np.asarray([np.nan]))
        assert guard.rejected_patches == 1
        assert np.array_equal(guard.scores(), good)

        assert not guard.update_activity(np.asarray([2]),
                                         mu=np.asarray([1e12]))
        assert guard.rollbacks == 1
        assert np.abs(guard.scores() - good).max() <= 1e-6
        # the port rebuilds the operators: the rollback is bit for bit a
        # fresh service's cold solve with the checkpointed rates
        cold = PsiService(g, Activity(rates.lam, rates.mu), tol=1e-8,
                          max_iter=400, **CPU)
        assert np.array_equal(guard.scores(), cold.scores())
        assert svc.last_iterations() == cold.last_iterations()


# --------------------------------------------------------------------- #
# the supervisor ladder
# --------------------------------------------------------------------- #
def _hanging_driver(g, act, hang_budget, **kw):
    def delay(chunk, epoch):
        if hang_budget[0] > 0 and chunk == 0:
            hang_budget[0] -= 1
            return HANG_S
        return 0.0

    return AsyncPsiDriver(g, act, num_chunks=2, tau=1, delay_hook=delay,
                          **CPU, **kw)


def test_supervisor_retry_absorbs_a_transient_hang(small_platform):
    g, act = small_platform
    budget = [0]
    sup = ResilientResolver(_hanging_driver(g, act, budget), tol=1e-7,
                            attempt_deadline_s=DEADLINE_S, max_retries=1,
                            backoff_s=0.01, allow_rechunk=False,
                            allow_sync=False)
    budget[0] = 1
    out = sup.resolve(warm=False)
    assert not out.degraded and out.escalation == "retry"
    assert out.attempts == 2 and sup.report.retries == 1
    assert sup.report.recoveries == 1 and sup.report.mttr_s > 0
    assert out.psi_error_bound is not None


def test_supervisor_escalates_to_tau_tightened_rechunk(small_platform):
    g, act = small_platform
    budget = [1]                            # one hang: sinks attempt 1 only
    sup = ResilientResolver(_hanging_driver(g, act, budget), tol=1e-7,
                            attempt_deadline_s=DEADLINE_S, max_retries=0,
                            allow_rechunk=True, allow_sync=False)
    out = sup.resolve(warm=False)
    assert not out.degraded and out.escalation == "rechunk"
    assert sup.driver.tau == 0 and sup.report.escalations == ["rechunk"]
    assert sup.driver.device == torch.device("cpu")


def test_supervisor_sync_rung_and_degraded_tagging(small_platform):
    g, act = small_platform
    psi_true = make_engine("reference", graph=g, activity=act,
                           **CPU).run(tol=1e-9).psi.numpy()
    budget = [10 ** 9]
    sup = ResilientResolver(_hanging_driver(g, act, budget), tol=1e-7,
                            attempt_deadline_s=DEADLINE_S, max_retries=0,
                            allow_rechunk=False, allow_sync=True)
    out = sup.resolve(warm=False)
    assert not out.degraded and out.escalation == "sync"
    assert np.abs(np.asarray(out.psi) - psi_true).max() <= 1e-5
    assert out.psi_error_bound is not None and out.psi_error_bound < 1e-3

    sup.allow_sync = False
    degraded = sup.resolve(warm=False)
    assert degraded.degraded and degraded.escalation == "degraded"
    assert degraded.freshness is not None
    assert degraded.freshness.staleness_seconds >= 0.0
    assert degraded.freshness.psi_error_bound == degraded.psi_error_bound
    assert degraded.ranking.err_bound == degraded.psi_error_bound
    assert np.array_equal(degraded.psi, out.psi)
    assert sup.report.degraded_served == 1
    budget[0] = 0


def test_degrade_with_no_prior_fixed_point_raises(small_platform):
    g, act = small_platform
    budget = [10 ** 9]
    sup = ResilientResolver(_hanging_driver(g, act, budget), tol=1e-7,
                            attempt_deadline_s=DEADLINE_S, max_retries=0,
                            allow_rechunk=False, allow_sync=False)
    with pytest.raises(ResolveFailure):
        sup.resolve(warm=False)
    budget[0] = 0


# --------------------------------------------------------------------- #
# the whole stack: seeded chaos -> recovery -> fixed-point parity
# --------------------------------------------------------------------- #
def test_chaos_recovery_reaches_fault_free_fixed_point_f32():
    report, metrics = run_chaos(n=150, m=900, horizon=2.5, seed=1, **CPU)
    assert metrics["dtype"] == "float32"
    assert not report.unsurvived
    assert metrics["parity_err"] <= metrics["psi_tol"]
    assert metrics["restarts"] >= 1 and metrics["offset"] > 0
    assert report.degraded_served >= 1 and report.recoveries >= 1


def test_chaos_check_passes_under_x64(tmp_path):
    """The acceptance gate at float64 in both packages, each in its own
    process (the JAX one under x64): both pass with ψ parity ≤ 1e-12, and
    the port's events, recovery cut, replay counts and delivery-fault
    counts equal the JAX gate's (the crash and stale-read counts depend on
    thread timing in both)."""
    env = dict(os.environ, PYTHONPATH=_SRC, JAX_ENABLE_X64="1", **ONE_CORE)
    args = ["--n", "200", "--m", "1200", "--horizon", "3", "--json"]
    cmds = {"jax": ["repro.resilience.check"],
            "port": ["repro_torch.resilience.check", "--dtype", "float64",
                     "--device", "cpu"]}
    runs = {}
    for name, (module, *extra) in cmds.items():   # one after the other
        proc = subprocess.run(
            [sys.executable, "-m", module, *args,
             str(tmp_path / f"{name}.json"), *extra], env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "dtype=float64" in proc.stdout
        assert "[resilience-check] PASS" in proc.stdout
        runs[name] = json.loads((tmp_path / f"{name}.json").read_text())
    j, p = runs["jax"], runs["port"]
    for key in ("n", "m", "events", "offset", "recovered_step", "refetched",
                "duplicates_suppressed", "degraded_served"):
        assert p["metrics"][key] == j["metrics"][key], key
    for side in ("injected", "survived"):
        for kind in ("dup", "drop", "reorder", "torn_ckpt", "poison",
                     "hang"):
            assert p[side][kind] == j[side][kind], (side, kind)
    assert max(j["metrics"]["parity_err"], p["metrics"]["parity_err"]) \
        <= 1e-12


# --------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------- #
def _event_rows(feed):
    return [(seq, type(ev).__name__, dataclasses.astuple(ev))
            for seq, ev in feed]


def test_fault_schedule_equals_jax_event_for_event(small_platform):
    """One plan, one log: both packages' feeds deliver the same (offset,
    event) sequence with the same corruption, count the same injections,
    and poison the same patch entry."""
    g, act = small_platform
    jgraph = jg.erdos_renyi(120, 700, seed=7)
    jact = jc.heterogeneous(120, seed=8)
    log = poisson_stream(act, 3.0, seed=11, graph=g)
    jlog = jev.poisson_stream(jact, 3.0, seed=11, graph=jgraph)
    kw = dict(seed=3, dup_every=7, drop_every=11, reorder_window=4)
    clock, jclock = FaultPlan(**kw).clock(), jr.FaultPlan(**kw).clock()
    for start in (0, len(log) // 3):
        got = _event_rows(clock.wrap_source(log, start=start))
        want = _event_rows(jclock.wrap_source(jlog, start=start))
        assert got == want and len(got) > 0
    assert dict(clock.injected) == dict(jclock.injected)
    users = np.arange(6)
    for kind in ("nan", "inf", "negative", "alpha"):
        pc = FaultPlan(seed=5, poison_kind=kind).clock()
        jpc = jr.FaultPlan(seed=5, poison_kind=kind).clock()
        for a, b in zip(pc.poison_patch(users, act.lam[users], act.mu[users]),
                        jpc.poison_patch(users, jact.lam[users],
                                         jact.mu[users])):
            np.testing.assert_array_equal(a, b)


def test_sync_rung_matches_jax_reference_at_f64(small_platform):
    """The ladder's sync rung builds the ``reference`` engine on the
    driver's device and dtype: at float64 its ψ is the JAX package's
    ``reference`` solve at the same tol within 1e-12."""
    g, act = small_platform
    budget = [10 ** 9]
    sup = ResilientResolver(
        _hanging_driver(g, act, budget, dtype=torch.float64), tol=1e-10,
        attempt_deadline_s=DEADLINE_S, max_retries=0, allow_rechunk=False,
        allow_sync=True)
    out = sup.resolve(warm=False)
    budget[0] = 0
    assert out.escalation == "sync" and out.psi.dtype == np.float64
    with _x64():
        want = np.asarray(jc.make_engine(
            "reference", graph=jg.erdos_renyi(120, 700, seed=7),
            activity=jc.heterogeneous(120, seed=8),
            dtype=jnp.float64).run(tol=1e-10).psi)
    assert np.abs(out.psi - want).max() <= 1e-12


def test_entry_points_refuse_a_missing_card(small_platform, tmp_path):
    """No fallback: ``run_chaos``, ``recover`` and ``obs.check`` default to
    the card and raise without one (they run on the CPU only when asked by
    name)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    from repro_torch.resilience import recover
    with pytest.raises(RuntimeError, match="cuda"):
        run_chaos(n=50, m=200, horizon=0.5)
    g, act = small_platform
    drv = AsyncPsiDriver(g, act, num_chunks=2, tau=1, **CPU)
    from repro_torch.resilience import StackCheckpointer
    from repro_torch.stream import StreamIngestor
    StackCheckpointer(str(tmp_path)).save(1, drv, StreamIngestor(drv))
    with pytest.raises(RuntimeError, match="cuda"):
        recover(str(tmp_path))
    assert recover(str(tmp_path), **CPU).driver.device.type == "cpu"
    from repro_torch.obs.check import run_check
    with pytest.raises(RuntimeError, match="cuda"):
        run_check(str(tmp_path / "obs"))
    assert not (tmp_path / "obs").exists()       # refused before any work
