"""The port's copies of the JAX package's jax-free ``obs`` modules.

``metrics``, ``log``, ``convergence`` and ``explain`` are verbatim copies;
``calibrate`` differs only in how a sample's environment is keyed (the
engine's device and dtype instead of the JAX platform and x64 flag), and
``env`` is written anew from torch. The store's arithmetic is held against
the JAX package's on the same samples.
"""
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jc
import repro.graphs as jg
from repro import obs as jobs
from repro.obs import calibrate as jcal
from repro_torch import obs
from repro_torch.obs import (calibrate, device_fingerprint,
                             environment_fingerprint, explain)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("name", ["metrics", "log", "convergence",
                                  "explain", "stream/events",
                                  "stream/estimator", "stream/freshness"])
def test_copied_modules_are_verbatim(name):
    """Copies of the JAX package's jax-free modules (``obs`` unless the
    name says otherwise), verbatim up to the package name in their
    docstrings."""
    rel = name if "/" in name else f"obs/{name}"
    port = (SRC / "repro_torch" / f"{rel}.py").read_text()
    ref = (SRC / "repro" / f"{rel}.py").read_text()
    assert re.sub(r"\brepro_torch\.", "repro.", port) == ref


SAMPLES = [("edge_tile", 100.0, 200.0), ("edge_tile", 100.0, 400.0),
           ("edge_tile", 50.0, 50.0), ("bsr", 2.0, 6.0), ("bsr", 2.0, 10.0),
           ("bsr", 1.0, 9.0)]


def test_store_arithmetic_matches_jax():
    env = calibrate.env_key("cpu", torch.float32)
    port = calibrate.CalibrationStore(env=env)
    ref = jcal.CalibrationStore(env=env)
    for regime, est, us in SAMPLES:
        assert port.observe(regime, est, us) == ref.observe(regime, est, us)
    assert port.factors() == ref.factors()
    assert port.multipliers({"edge_tile", "bsr", "dense"}) == \
        ref.multipliers({"edge_tile", "bsr", "dense"})
    assert port.generation == ref.generation
    assert port.to_json() == ref.to_json()
    assert port.observe("bsr", 0.0, 5.0) is None          # no information


def test_store_is_keyed_per_device_and_dtype(tmp_path):
    k32 = calibrate.env_key("cpu", torch.float32)
    k64 = calibrate.env_key(torch.device("cpu"), torch.float64)
    store = calibrate.CalibrationStore()
    for _ in range(2):
        store.observe("bsr", 1.0, 3.0, env=k64)
    assert store.factor("bsr", env=k64)["count"] == 2
    assert store.factor("bsr", env=k32) is None
    assert store.multipliers({"bsr"}, env=k32) == {}
    path = str(tmp_path / "calib.json")
    store.save(path)
    back = calibrate.CalibrationStore()
    assert back.load(path) == 1
    assert back.factors(env=k64) == store.factors(env=k64)
    with pytest.raises(ValueError, match="env_key"):
        back.factors()                      # no implicit environment


def test_env_fingerprint_names_torch_and_the_device():
    fp = environment_fingerprint("cpu")
    assert fp["torch"] == torch.__version__
    assert fp["device_platform"] == "cpu"
    assert {"cuda", "device_count", "git_sha", "compute_capability",
            "timestamp_utc"} <= set(fp)
    assert device_fingerprint("cpu")["compute_capability"] is None
    with pytest.raises(ValueError, match="unsupported device"):
        device_fingerprint("meta")


def test_decision_log_records_a_plan():
    from repro_torch.graphs import erdos_renyi
    from repro_torch.kernels.autotune import plan_regime
    prev = explain.set_log(explain.DecisionLog())
    try:
        plan_regime(erdos_renyi(200, 900, seed=1), cache=None,
                    calibration=None)
        rec = explain.get_log().last(kind="regime_plan")
    finally:
        explain.set_log(prev)
    assert rec.cache == "bypass" and rec.source == "model"
    assert [p.name for p in rec.pruned] == ["bsr(ts=128,td=128)",
                                            "bsr(ts=128,td=256)"]
    assert sum(c.chosen for c in rec.candidates) == 1
    assert explain.render_decision(rec)


# --------------------------------------------------------------------- #
# The switchboard, _instrument_run, the read funnel and explain()
# --------------------------------------------------------------------- #
@pytest.fixture
def sinks():
    """Fresh sinks in both packages for one test, restored afterwards; the
    port's calibration store too (the JAX package's is fresh per test)."""
    prev_t = obs.configure(registry=obs.MetricsRegistry(),
                           tracker=obs.ConvergenceTracker(),
                           decisions=obs.DecisionLog())
    prev_j = jobs.configure(registry=jobs.MetricsRegistry(),
                            tracker=jobs.ConvergenceTracker(),
                            decisions=jobs.DecisionLog())
    prev_store = calibrate.set_store(calibrate.CalibrationStore())
    yield
    calibrate.set_store(prev_store)
    obs.restore(prev_t)
    jobs.restore(prev_j)


def _services(backend="reference", n=300, m=1800):
    from repro_torch.core import PsiService, heterogeneous
    from repro_torch.graphs import powerlaw_configuration
    port = PsiService(powerlaw_configuration(n, m, seed=3),
                      heterogeneous(n, seed=4), tol=1e-9, backend=backend,
                      dtype=torch.float64, device="cpu")
    ref = jc.PsiService(jg.powerlaw_configuration(n, m, seed=3),
                        jc.heterogeneous(n, seed=4), tol=1e-9,
                        dtype=jnp.float32)
    return port, ref


def test_switchboard_round_trip(tmp_path):
    """Default state as the JAX package's; disable swaps every sink for its
    null twin, restore puts them back, configure installs what it is given
    and dump writes the port's fingerprint with the dtype beside it."""
    assert obs.enabled() and obs.convergence.get_tracker().enabled
    assert obs.trace.get_tracer() is obs.NULL_TRACER
    before = (obs.metrics.get_registry(), obs.convergence.get_tracker(),
              obs.explain.get_log())
    prev = obs.disable()
    try:
        assert not obs.enabled()
        assert obs.convergence.get_tracker() is obs.NULL_TRACKER
        assert obs.explain.get_log() is obs.NULL_DECISIONS
        assert obs.trace.get_tracer() is obs.NULL_TRACER
    finally:
        obs.restore(prev)
    assert (obs.metrics.get_registry(), obs.convergence.get_tracker(),
            obs.explain.get_log()) == before
    reg, tracker = obs.MetricsRegistry(), obs.ConvergenceTracker()
    prev = obs.configure(registry=reg, tracker=tracker,
                         trace_out=str(tmp_path / "t.jsonl"))
    try:
        assert obs.metrics.get_registry() is reg
        assert isinstance(obs.trace.get_tracer(), obs.Tracer)
        obs.metrics.counter("psi_test_total", "a test counter").inc(3)
        path = tmp_path / "dump.json"
        snap = obs.dump(str(path), device="cpu", dtype=torch.float64)
        back = json.loads(path.read_text())
        assert set(back) == set(snap) == {
            "fingerprint", "metrics", "convergence", "events", "decisions",
            "calibration"}
        fp = back["fingerprint"]
        assert fp["torch"] == torch.__version__ and fp["dtype"] == "float64"
        assert fp["device_platform"] == "cpu"
        assert "psi_test_total" in json.dumps(back["metrics"])
        assert set(back) == set(jobs.dump())
    finally:
        obs.trace.get_tracer().close()
        obs.restore(prev)
    assert obs.metrics.get_registry() is before[0]
    assert obs.trace.get_tracer() is obs.NULL_TRACER


@pytest.mark.parametrize("backend", ["reference", "cuda", "accelerated",
                                     "auto", "push"])
def test_instrument_run_reads_only(sinks, backend):
    """ψ and s bitwise equal with the plane on and off; one ``engine.run``
    record (and span, under a live tracer) per run, the ``auto`` engine's
    calibration timer adding no second one."""
    from repro_torch.core import make_engine, heterogeneous
    from repro_torch.graphs import powerlaw_configuration
    g = powerlaw_configuration(300, 1800, seed=3)
    act = heterogeneous(g.n, seed=4)

    def solve():
        eng = make_engine(backend, graph=g, activity=act, device="cpu",
                          dtype=torch.float64)
        return [eng.run(tol=1e-9), eng.run(tol=1e-9)]

    tracer = obs.Tracer(None)
    obs.configure(tracer=tracer)
    on = solve()
    recs = obs.convergence.get_tracker().series(None)
    assert [r.backend for r in recs] == [backend] * 2
    assert [r.iterations for r in recs] == [r.iterations for r in on]
    assert [s["name"] for s in tracer.spans].count("engine.run") == 2
    assert all(s["attrs"]["backend"] == backend for s in tracer.spans
               if s["name"] == "engine.run")
    prev = obs.disable()
    try:
        off = solve()
    finally:
        obs.restore(prev)
    for a, b in zip(on, off):
        assert torch.equal(a.psi, b.psi) and torch.equal(a.s, b.s)
        assert a.iterations == b.iterations and a.gap == b.gap


def _reads(svc):
    """One fixed read sequence: a cold read, cached reads, a deferred patch
    (stale reads), a resolve, cached reads again."""
    users = np.arange(5)
    svc.top_k(3)
    svc.scores_batch(users)
    svc.rank_of(users)
    svc.update_activity(np.asarray([2]), lam=np.asarray([4.0]),
                        resolve=False)
    svc.scores()
    svc.top_k(3)
    svc.resolve()
    svc.rank_of(users)
    svc.scores_batch(users)
    svc.top_k_certified(3)


def _funnel(reg):
    hist = reg.get("psi_query_seconds")
    return (
        {key[0]: ch.count for key, ch in hist.children()},
        {key[0]: ch.value
         for key, ch in reg.get("psi_query_cache_total").children()},
        reg.value("psi_query_stale_reads_total"))


def test_read_funnel_counts_match_jax(sinks):
    port, ref = _services()
    _reads(port)
    _reads(ref)
    got = _funnel(obs.metrics.get_registry())
    want = _funnel(jobs.metrics.get_registry())
    assert got == want
    assert got[1] == {"hit": 6.0, "miss": 2.0} and got[2] == 2
    assert port._last_read["op"] == ref._last_read["op"] == "top_k_certified"
    assert port._last_read["cache"] == ref._last_read["cache"] == "hit"
    assert port._last_read["seconds"] > 0.0      # the null span still times
    # a dark plane skips the funnel in one branch: no metrics, no read facts
    prev = obs.disable()
    try:
        port2, _ = _services()
        port2.scores()
        assert not hasattr(port2, "_last_read")
    finally:
        obs.restore(prev)


def test_fleet_view_cache_state_matches_jax(sinks):
    from repro.serving import TenantFleet as JFleet
    from repro_torch.core import heterogeneous
    from repro_torch.graphs import erdos_renyi
    from repro_torch.serving import TenantFleet
    fleet = TenantFleet(backend="dense", tol=1e-8, device="cpu")
    jfleet = JFleet(backend="dense", tol=1e-8)
    fleet.admit("a", erdos_renyi(60, 240, seed=1), heterogeneous(60, seed=2))
    jfleet.admit("a", jg.erdos_renyi(60, 240, seed=1),
                 jc.heterogeneous(60, seed=2))
    states = []
    for f in (fleet, jfleet):
        view = f.view("a")
        seq = [view._obs_cache_state()]
        view.top_k(3)
        seq.append(view._obs_cache_state())
        view.update_activity(np.asarray([1]), lam=np.asarray([3.0]))
        seq.append(view._obs_cache_state())
        view.scores()
        seq.append(view._obs_cache_state())
        states.append(seq)
    assert states[0] == states[1] == ["miss", "hit", "miss", "hit"]


def _headings(tree: str) -> list[str]:
    """Each line's leading words up to the first '=' or '(' — the tree's
    headings without the measured values."""
    return [re.split(r"[=(]", line)[0].rsplit(" ", 1)[0].strip()
            for line in tree.splitlines()]


def test_explain_tree_headings_match_jax(sinks):
    port, ref = _services()
    for svc in (port, ref):
        svc.scores()
        svc.update_activity(np.asarray([2]), lam=np.asarray([4.0]))
        svc.top_k(3)
    tree, jtree = port.explain(), ref.explain()
    assert tree.splitlines()[0] == jtree.splitlines()[0] == \
        "EXPLAIN ANALYZE — power-ψ [backend=reference]"
    assert _headings(tree) == _headings(jtree)
    assert "query op=top_k cache=miss stale=False" in tree
