"""The port's obs analysis-and-control layer (``repro_torch.obs.slo``,
``profile``, ``watch``, ``regress``) against the JAX package's: the
counterparts of ``tests/test_obs_analysis.py`` (the SLO engine and its
burn-rate alerts, the span-stream profiler, the convergence watch and its
pre-emption of the ladder, the noise-aware regression gate), then parity:
the same inputs give the JAX package's verdicts, folded stacks, hotspots,
critical path and watch signals, and ``python -m repro_torch.obs.check
--device cpu`` passes.

The port's drivers run with ``device="cpu"``. The analysis modules are
copies of the JAX package's pure-Python ones, so parity is equality.
"""
import dataclasses
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.obs.profile as jprofile
import repro.obs.regress as jregress
import repro.obs.slo as jslo
import repro.obs.watch as jwatch
from repro.obs.convergence import ResolveRecord as JResolveRecord
from repro_torch import obs
from repro_torch.obs import log as obs_log
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.convergence import ResolveRecord
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import Profile
from repro_torch.obs.regress import gate, inject_slowdown
from repro_torch.obs.regress import main as regress_main
from repro_torch.obs.slo import (BurnRule, SLO, SLOEngine, counter_ratio,
                                 default_slos, gauge_value,
                                 histogram_quantile)
from repro_torch.obs.watch import ConvergenceWatch

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = dict(device="cpu")
# the subprocesses this file spawns compute on one core each, so that they
# load the machine lightly beside the other test workers
ONE_CORE = dict(OMP_NUM_THREADS="1", XLA_FLAGS=(
    "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))


@pytest.fixture
def fresh_obs():
    """Isolated sinks (registry + tracker + in-memory tracer) per test."""
    prev = obs.configure(registry=MetricsRegistry(),
                         tracer=obs.Tracer(None),
                         tracker=obs.ConvergenceTracker())
    obs_log.clear()
    yield obs_metrics.get_registry()
    obs.restore(prev)


# --------------------------------------------------------------------- #
# SLO engine
# --------------------------------------------------------------------- #
def test_signal_helpers_read_live_registry(fresh_obs):
    reg = fresh_obs
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.01, 0.02, 0.03):
        h.observe(v)
    reg.gauge("lag_s", "lag", ("lane",)).labels(lane="a").set(4.0)
    reg.counter("bad_total", "bad").inc(1)
    reg.counter("all_total", "all").inc(4)
    assert histogram_quantile("lat_seconds", 1.0)() == pytest.approx(0.03)
    assert gauge_value("lag_s", lane="a")() == 4.0
    assert counter_ratio("bad_total", "all_total")() == pytest.approx(0.25)
    # absent series: None, never an exception
    assert histogram_quantile("nope_seconds", 0.99)() is None
    assert gauge_value("nope")() is None
    assert counter_ratio("bad_total", "nope_total")() is None


def test_slo_no_data_is_compliant_and_counted_as_good(fresh_obs):
    t = [0.0]
    eng = SLOEngine([SLO("s", lambda: None, target=1.0)],
                    clock=lambda: t[0])
    eng.tick()
    row = eng.report()["slos"][0]
    assert row["samples"] == 1 and row["bad_samples"] == 0
    assert row["meeting_target"] and row["budget_remaining"] == 1.0


def test_slo_violations_drain_the_error_budget(fresh_obs):
    t = [0.0]
    eng = SLOEngine([SLO("lat", lambda: 2.0, target=1.0,
                         objective=0.99)], clock=lambda: t[0])
    for _ in range(3):
        eng.tick()
        t[0] += 1.0
    rep = eng.report()
    row = rep["slos"][0]
    assert row["bad_samples"] == 3 and not row["meeting_target"]
    assert row["budget_remaining"] == 0.0 and not rep["ok"]
    fam = fresh_obs.get("psi_slo_violations_total")
    assert sum(ch.value for _, ch in fam.children()) == 3


def test_higher_is_better_objective_direction(fresh_obs):
    eng = SLOEngine([SLO("throughput", lambda: 80.0, target=100.0,
                         op=">=")], clock=lambda: 0.0)
    eng.tick()
    assert not eng.report()["slos"][0]["meeting_target"]


def test_burn_alert_needs_both_windows_and_fires_once(fresh_obs):
    t = [0.0]
    val = [0.0]
    slo = SLO("s", lambda: val[0], target=1.0, objective=0.9,
              rules=((10.0, 100.0, 2.0),))
    eng = SLOEngine([slo], clock=lambda: t[0])
    # long healthy history fills the slow window with good samples
    for _ in range(100):
        eng.tick()
        t[0] += 1.0
    # outage: fast window saturates quickly, slow window lags
    val[0] = 5.0
    fired_at = None
    for i in range(60):
        eng.tick()
        if fired_at is None and eng.report()["alerts_total"]:
            fired_at = i
        t[0] += 1.0
    rep = eng.report()
    assert fired_at is not None, "sustained outage must alert"
    # burn>2 with budget 0.1 needs bad_frac>0.2 in BOTH windows: the
    # 100-sample slow window requires >20 bad samples, so the alert must
    # arrive later than the fast window alone would allow
    assert fired_at >= 20
    # rising-edge dedupe: one alert despite ~40 more firing ticks
    assert rep["alerts_total"] == 1
    events = [e for e in obs_log.recent(500)
              if e["name"] == "slo_burn_alert"]
    assert len(events) == 1
    assert events[0]["slo"] == "s" and events[0]["burn_fast"] > 2.0


def test_burn_alert_rearms_after_recovery(fresh_obs):
    t = [0.0]
    val = [0.0]
    slo = SLO("s", lambda: val[0], target=1.0, objective=0.5,
              rules=((4.0, 8.0, 1.5),))
    eng = SLOEngine([slo], clock=lambda: t[0])

    def run(n, v):
        val[0] = v
        for _ in range(n):
            eng.tick()
            t[0] += 1.0

    run(10, 0.0)          # healthy baseline
    run(10, 9.0)          # first outage -> alert
    assert eng.report()["alerts_total"] == 1
    run(12, 0.0)          # recovery clears the fast window -> re-arm
    run(10, 9.0)          # second outage -> second alert
    assert eng.report()["alerts_total"] == 2


def test_broken_signal_is_an_error_event_not_an_outage(fresh_obs):
    def boom():
        raise RuntimeError("sensor detached")
    eng = SLOEngine([SLO("s", boom, target=1.0)], clock=lambda: 0.0)
    eng.tick()
    row = eng.report()["slos"][0]
    assert row["samples"] == 0 and row["meeting_target"]
    assert any(e["name"] == "slo_signal_error"
               for e in obs_log.recent(50))


def test_burn_rule_scaling_and_default_catalog(fresh_obs):
    r = BurnRule(300.0, 3600.0, 14.4).scaled(1.0 / 200.0)
    assert r.fast_s == pytest.approx(1.5)
    assert r.slow_s == pytest.approx(18.0)
    assert r.burn == 14.4
    names = {s.name for s in default_slos()}
    assert names == {"query_p99_latency", "freshness_staleness",
                     "certified_psi_error", "degraded_answer_ratio"}


def test_healthz_and_slo_http_endpoints(fresh_obs):
    eng = SLOEngine([SLO("s", lambda: 0.5, target=1.0)],
                    clock=lambda: 0.0)
    eng.tick()
    server = obs.start_http_server(0)     # ephemeral port
    try:
        port = server.server_address[1]

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}") as r:
                return r.status, json.load(r)
        status, hz = get("/healthz")
        assert status == 200 and hz["status"] == "ok"
        assert hz["metrics_enabled"] and not hz["slo_installed"]
        # no engine installed yet -> /slo is a 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/slo")
        assert ei.value.code == 404
        eng.install()
        try:
            status, doc = get("/slo")
            assert status == 200
            assert doc["slos"][0]["name"] == "s" and doc["ok"]
            assert get("/healthz")[1]["slo_installed"]
        finally:
            eng.uninstall()
    finally:
        server.shutdown()


# --------------------------------------------------------------------- #
# span-stream profiler
# --------------------------------------------------------------------- #
def _span(name, ts, dur, *, id=None, parent=None, thread=0, **attrs):
    rec = dict(name=name, id=id or f"{name}@{ts}", parent=parent,
               depth=0 if parent is None else 1, thread=thread,
               ts=ts, dur=dur)
    if attrs:
        rec["attrs"] = attrs
    return rec


def test_folded_stacks_and_self_time(tmp_path):
    recs = [
        _span("serve", 0.0, 1.0, id="root"),
        _span("engine.run", 0.1, 0.6, id="eng", parent="root",
              backend="reference"),
        _span("engine.run", 0.8, 0.1, id="eng2", parent="root",
              backend="reference"),
    ]
    prof = Profile(recs)
    folded = prof.folded()
    assert folded["serve"] == pytest.approx(0.3)       # 1.0 - 0.6 - 0.1
    key = "serve;engine.run[backend=reference]"
    assert folded[key] == pytest.approx(0.7)
    out = tmp_path / "profile.folded"
    prof.write_folded(str(out))
    assert f"{key} 700000" in out.read_text()          # integer µs lines


def test_self_time_ignores_cross_thread_children():
    recs = [
        _span("async.run", 0.0, 1.0, id="root", thread=0),
        _span("async.step", 0.0, 0.9, id="w", parent="root", thread=1,
              chunk=0),
    ]
    prof = Profile(recs)
    # the worker runs on its own thread: it owns its time, the parent
    # keeps its full wall (it was genuinely busy dispatching/waiting)
    assert prof.folded()["async.run"] == pytest.approx(1.0)
    assert prof.folded()["async.run;async.step[chunk=0]"] \
        == pytest.approx(0.9)


def test_hotspots_carry_dispatch_sync_split():
    recs = [_span("engine.run", 0.0, 1.0, id="e", backend="pallas")]
    recs[0]["dispatch_s"] = 0.7
    recs[0]["sync_s"] = 0.2
    h = Profile(recs).hotspots(1)[0]
    assert h["frame"] == "engine.run[backend=pallas]"
    assert h["dispatch_s"] == pytest.approx(0.7)
    assert h["sync_s"] == pytest.approx(0.2)


def test_port_spans_carry_the_fields_the_profiler_reads(fresh_obs):
    """A span of the port's tracer, with its ``Span.sync`` (a CUDA-stream
    wait; nothing to wait for on the CPU), records the id, parent, thread,
    clock and dispatch/sync split that ``Profile`` folds and ranks."""
    import torch
    tracer = obs.trace.get_tracer()
    with obs.span("engine.run", backend="cuda") as outer:
        with obs.span("query", op="top_k") as sp:
            sp.sync(torch.ones(3))
        outer.sync((torch.zeros(2), {"s": torch.ones(1)}))
    recs = {r["name"]: r for r in tracer.spans}
    for r in recs.values():
        assert {"id", "thread", "ts", "dur", "dispatch_s", "sync_s"} <= set(r)
    assert recs["query"]["parent"] == recs["engine.run"]["id"]
    prof = Profile.from_tracer(tracer)
    assert set(prof.folded()) == {"engine.run[backend=cuda]",
                                  "engine.run[backend=cuda];query[op=top_k]"}
    hot = {h["frame"]: h for h in prof.hotspots(2)}
    assert hot["query[op=top_k]"]["dispatch_s"] >= 0.0


def test_critical_path_names_the_bounding_chunk():
    # chunk 1's chain finishes last and dominates wall-clock
    recs = [
        _span("async.step", 0.0, 0.2, id="a0", thread=1, chunk=0,
              epoch=0),
        _span("async.step", 0.0, 0.5, id="b0", thread=2, chunk=1,
              epoch=0),
        _span("async.step", 0.5, 0.5, id="b1", thread=2, chunk=1,
              epoch=1),
        _span("async.step", 0.21, 0.2, id="a1", thread=1, chunk=0,
              epoch=1),
    ]
    cp = Profile(recs).critical_path()
    assert cp.bounding_chunk == 1
    assert cp.length_s == pytest.approx(1.0)
    assert "chunk 1" in cp.describe()


def test_real_async_run_profiles_end_to_end(fresh_obs):
    from repro_torch.asyncexec import AsyncPsiDriver
    from repro_torch.core import heterogeneous
    from repro_torch.graphs import powerlaw_configuration
    g = powerlaw_configuration(300, 1800, seed=3)
    drv = AsyncPsiDriver(g, heterogeneous(300, seed=4), num_chunks=3,
                         tau=2, **CPU)
    drv.run(tol=1e-6, max_iter=2000)
    prof = Profile.from_tracer(obs.trace.get_tracer())
    assert any(r["name"] == "async.step" for r in prof.records)
    steps = [r for r in prof.records if r["name"] == "async.step"]
    assert all("chunk" in (r.get("attrs") or {}) for r in steps)
    assert any((r.get("attrs") or {}).get("epoch", -1) >= 0
               for r in steps)
    cp = prof.critical_path()
    assert cp.steps and 0.0 < cp.length_s <= cp.wall_s + 1e-9
    assert sum(cp.chunk_share.values()) == pytest.approx(cp.length_s)


# --------------------------------------------------------------------- #
# convergence watch
# --------------------------------------------------------------------- #
def _resolve_record(gaps, *, backend="reference", accepted=0, rejected=0):
    rec = ResolveRecord(backend, "_default", 0, max_points=512)
    for t, g in enumerate(gaps):
        rec.add_point(t, raw=g)
    rec.aitken_accepted = accepted
    rec.aitken_rejected = rejected
    return rec


def test_watch_flags_contraction_drift(fresh_obs):
    w = ConvergenceWatch(baseline=2, rho_drift=0.05)
    healthy = [0.5 ** i for i in range(10)]           # rho 0.5
    for _ in range(2):
        w.observe_record(_resolve_record(healthy))
    assert not w.advice()
    w.observe_record(_resolve_record([0.9 ** i for i in range(10)]))
    adv = w.advice()
    assert adv.sync_sweep and "rho_drift" in adv.reasons


def test_watch_flags_gap_plateau(fresh_obs):
    w = ConvergenceWatch()
    w.observe_record(_resolve_record([1e-3] * 8))
    assert "gap_plateau" in w.advice().reasons


def test_watch_flags_aitken_shift(fresh_obs):
    w = ConvergenceWatch(baseline=2, aitken_shift=0.35)
    for _ in range(2):
        w.observe_record(_resolve_record([], accepted=9, rejected=1))
    w.observe_record(_resolve_record([], accepted=2, rejected=8))
    assert "aitken_shift" in w.advice().reasons


def test_watch_flags_certificate_storm_onset(fresh_obs):
    class Report:
        rejected_certificates = 30
    w = ConvergenceWatch(cert_storm=50, storm_frac=0.5)
    w.observe_report(Report())
    adv = w.advice()
    assert adv.tighten_tau and "cert_storm_onset" in adv.reasons


def test_watch_projects_alpha_across_the_wall(fresh_obs):
    w = ConvergenceWatch(alpha_max=1.0, alpha_horizon=3)
    for a in (0.80, 0.87, 0.94):      # +0.07/step -> 1.15 in 3 steps
        w.observe_alpha(a)
    adv = w.advice()
    assert adv.sync_sweep and "alpha_drift" in adv.reasons
    # flagged BEFORE the wall: last observed alpha still < alpha_max
    assert w.signals[-1].value == pytest.approx(0.94)


def test_watch_ignores_flat_alpha(fresh_obs):
    w = ConvergenceWatch()
    for a in (0.80, 0.80, 0.80, 0.80):
        w.observe_alpha(a)
    assert not w.advice()


def test_advice_latches_and_consume_rearms(fresh_obs):
    w = ConvergenceWatch()
    w.observe_failure("timeout", "attempt 1")
    assert w.advice() and w.advice()          # peek does not consume
    adv = w.consume_advice()
    assert adv.sync_sweep and adv.reasons == ("attempt_failure",)
    assert not w.advice() and not w.consume_advice()


def test_watch_attach_subscribes_to_the_tracker(fresh_obs):
    from repro_torch.obs import convergence as obs_convergence
    w = ConvergenceWatch().attach()
    try:
        tr = obs_convergence.get_tracker()
        rec = tr.begin("reference")
        for t in range(8):
            rec.add_point(t, raw=1e-3)        # flat -> plateau
        tr.finish(rec, iterations=8, gap=1e-3, converged=False)
        assert "gap_plateau" in w.advice().reasons
    finally:
        w.detach()
    fam = fresh_obs.get("psi_watch_signals_total")
    assert sum(ch.value for _, ch in fam.children()) >= 1
    assert any(e["name"] == "watch_anomaly" for e in obs_log.recent(50))


def test_watch_feeds_preemptive_rechunk_into_the_ladder(fresh_obs):
    from repro_torch.asyncexec import AsyncPsiDriver
    from repro_torch.core import heterogeneous
    from repro_torch.graphs import powerlaw_configuration
    from repro_torch.resilience import ResilientResolver
    g = powerlaw_configuration(300, 1800, seed=3)
    drv = AsyncPsiDriver(g, heterogeneous(300, seed=4), num_chunks=3,
                         tau=2, **CPU)
    w = ConvergenceWatch(cert_storm=50, storm_frac=0.5)

    class Report:
        rejected_certificates = 40
    w.observe_report(Report())                # tighten_tau advice pending
    res = ResilientResolver(drv, tol=1e-6, max_iter=4000, watch=w)
    out = res.resolve()
    assert res.report.preemptions == ["rechunk"]
    assert res.driver.tau == 0                # staleness bound tightened
    assert not out.degraded and out.escalation == "none"
    fam = fresh_obs.get("psi_resilience_preemptions_total")
    assert fam is not None and \
        fam.labels(action="rechunk").value == 1
    # advice was consumed: a second resolve does not re-preempt
    res.resolve()
    assert res.report.preemptions == ["rechunk"]


# --------------------------------------------------------------------- #
# perf-regression gate
# --------------------------------------------------------------------- #
def _bench_doc(cand_wall=1.0, *, n_base=4, env=None, cand_env=None,
               quick=False, cand_quick=None):
    def run(label, wall, environment, q):
        return dict(label=label, quick=q, environment=environment,
                    entries=[dict(graph="powerlaw", backend="reference",
                                  regime=None, n=100, m=500,
                                  dtype="float64", tol=1e-8,
                                  wall_s=wall, matvecs=40,
                                  work_frac=0.5)])
    runs = [run(f"b{i}", 1.0 + 0.01 * i, env or {}, quick)
            for i in range(n_base)]
    runs.append(run("cand", cand_wall,
                    cand_env if cand_env is not None else (env or {}),
                    quick if cand_quick is None else cand_quick))
    return dict(schema=1, runs=runs)


def test_gate_passes_within_noise_and_catches_slowdown():
    assert gate(_bench_doc(1.02))["ok"]
    verdict = gate(_bench_doc(2.1))
    assert not verdict["ok"]
    assert any("powerlaw/reference" in r and "wall_s" in r
               for r in verdict["regressions"])
    row = next(r for r in verdict["rows"]
               if r["metric"] == "wall_s")
    assert row["status"] == "regression" and row["baselines"] == 4


def test_gate_mad_absorbs_one_noisy_baseline():
    doc = _bench_doc(1.05)
    doc["runs"][0]["entries"][0]["wall_s"] = 30.0   # one wild outlier
    verdict = gate(doc)
    assert verdict["ok"], "median/MAD must shrug off a single outlier"


def test_gate_direction_higher_is_better():
    doc = _bench_doc()
    for r in doc["runs"]:
        r["entries"][0]["events_per_s"] = (
            5000.0 if r["label"] != "cand" else 2000.0)
    verdict = gate(doc)
    assert not verdict["ok"]
    assert any("events_per_s" in r for r in verdict["regressions"])


def test_gate_env_and_quick_matching():
    # env mismatch -> no baselines -> skipped, not compared
    doc = _bench_doc(9.0, env={"device_platform": "cpu"},
                     cand_env={"device_platform": "gpu"})
    verdict = gate(doc)
    assert verdict["ok"] and verdict["baselines"] == []
    assert all(r["status"] == "skipped" for r in verdict["rows"])
    # empty env on old runs is a wildcard: still comparable
    doc = _bench_doc(1.0, env={}, cand_env={"device_platform": "cpu"})
    assert len(gate(doc)["baselines"]) == 4
    # quick runs never gate against full runs
    doc = _bench_doc(9.0, cand_quick=True)
    assert gate(doc)["ok"] and gate(doc)["baselines"] == []


def test_inject_slowdown_is_caught_and_original_untouched():
    doc = _bench_doc(1.0)
    slowed = inject_slowdown(doc, factor=2.0)
    assert doc["runs"][-1]["entries"][0]["wall_s"] == 1.0
    assert slowed["runs"][-1]["entries"][0]["wall_s"] == 2.0
    assert gate(doc)["ok"] and not gate(slowed)["ok"]


def test_regress_cli_exit_codes(tmp_path):
    good = tmp_path / "bench.json"
    good.write_text(json.dumps(_bench_doc(1.0)))
    out = tmp_path / "verdict.json"
    assert regress_main(["--json", str(good), "--out", str(out),
                         "--self-check"]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["ok"] and verdict["candidate"] == "cand"
    bad = tmp_path / "bench_bad.json"
    bad.write_text(json.dumps(_bench_doc(3.0)))
    assert regress_main(["--json", str(bad)]) == 1


def test_regress_gates_the_checked_in_trajectory():
    path = os.path.join(ROOT, "BENCH_power_psi.json")
    with open(path) as f:
        doc = json.load(f)
    verdict = gate(doc, quick=bool(
        doc["runs"][-1].get("quick")))
    assert verdict["ok"], verdict["regressions"]
    slowed = inject_slowdown(doc, factor=2.0)
    assert not gate(slowed, quick=bool(
        doc["runs"][-1].get("quick")))["ok"]


# --------------------------------------------------------------------- #
# parity with the JAX package
# --------------------------------------------------------------------- #
def test_regress_verdict_equals_jax_on_the_checked_in_trajectory(tmp_path):
    """The gate reads ``BENCH_power_psi.json`` (never writes it) and gives
    the JAX package's verdict document, plain and with an injected
    slowdown; the two CLIs exit with the same codes."""
    path = os.path.join(ROOT, "BENCH_power_psi.json")
    with open(path, "rb") as f:
        raw = f.read()
    doc = json.loads(raw)
    quick = bool(doc["runs"][-1].get("quick"))
    assert gate(doc, quick=quick) == jregress.gate(doc, quick=quick)
    assert gate(inject_slowdown(doc, factor=2.0), quick=quick) \
        == jregress.gate(jregress.inject_slowdown(doc, factor=2.0),
                         quick=quick)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **ONE_CORE)
    outs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / f"{pkg}.json"
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.obs.regress", "--json", path,
             "--out", str(out), "--self-check"], env=env,
            capture_output=True, text=True, timeout=120)
        outs[pkg] = (proc.returncode, json.loads(out.read_text()))
    assert outs["repro"] == outs["repro_torch"] and outs["repro"][0] == 0
    with open(path, "rb") as f:
        assert f.read() == raw


def _records():
    """A span stream with nesting, a cross-thread child, a sync split and
    an async chunk pipeline."""
    recs = [
        _span("serve", 0.0, 2.0, id="root"),
        _span("engine.run", 0.1, 0.6, id="eng", parent="root",
              backend="cuda"),
        _span("query", 0.8, 0.1, id="q", parent="root", op="top_k"),
        _span("async.run", 1.0, 1.0, id="ar", parent="root"),
        _span("async.step", 1.0, 0.2, id="a0", parent="ar", thread=1,
              chunk=0, epoch=0),
        _span("async.step", 1.0, 0.5, id="b0", parent="ar", thread=2,
              chunk=1, epoch=0),
        _span("async.step", 1.5, 0.5, id="b1", parent="ar", thread=2,
              chunk=1, epoch=1),
        _span("async.step", 1.21, 0.2, id="a1", parent="ar", thread=1,
              chunk=0, epoch=1),
    ]
    recs[1]["dispatch_s"], recs[1]["sync_s"] = 0.45, 0.15
    return recs


def test_profile_equals_jax_profile_on_one_span_stream(tmp_path):
    recs = _records()
    got, want = Profile(recs), jprofile.Profile(recs)
    assert got.folded() == want.folded()
    assert got.hotspots(10) == want.hotspots(10)
    assert got.attribution() == want.attribution()
    assert got.to_json() == want.to_json()
    assert got.critical_path().describe() == want.critical_path().describe()
    got.write_folded(str(tmp_path / "a"))
    want.write_folded(str(tmp_path / "b"))
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()


def test_slo_engine_equals_jax_engine_on_one_signal_trace(fresh_obs):
    """The same scripted signal on the same clock: the same verdicts,
    alerts and budget in both packages' engines."""
    vals = [0.0] * 40 + [5.0] * 30 + [0.0] * 20 + [5.0] * 30
    engines = []
    for mod in (jslo, None):
        t, k = [0.0], [0]

        def signal():
            return vals[min(k[0], len(vals) - 1)]
        make_slo = jslo.SLO if mod is jslo else SLO
        make_eng = jslo.SLOEngine if mod is jslo else SLOEngine
        eng = make_eng([make_slo("s", signal, target=1.0, objective=0.9,
                                 rules=((5.0, 20.0, 2.0),))],
                       clock=lambda: t[0])
        for _ in vals:
            eng.tick()
            t[0] += 1.0
            k[0] += 1
        engines.append(eng)
    jeng, peng = engines
    assert peng.report() == jeng.report()
    assert peng.summary() == jeng.summary()
    assert peng.report()["alerts_total"] == 2


def test_watch_signals_equal_jax_watch_on_one_stream(fresh_obs):
    """The same records, reports and α readings: the same signal kinds,
    values and advice from both packages' watches."""
    pw, jw = ConvergenceWatch(baseline=2), jwatch.ConvergenceWatch(
        baseline=2)
    for rho in (0.5, 0.5, 0.9):
        gaps = [rho ** i for i in range(12)]
        for w, make in ((pw, ResolveRecord), (jw, JResolveRecord)):
            rec = make("reference", "_default", 0, max_points=512)
            for t, gp in enumerate(gaps):
                rec.add_point(t, raw=gp)
            w.observe_record(rec)

    class Report:
        rejected_certificates = 30
    for w in (pw, jw):
        w.observe_report(Report())
        for a in (0.80, 0.87, 0.94):
            w.observe_alpha(a)
    key = [(s.kind, s.value, s.detail) for s in pw.signals]
    assert key == [(s.kind, s.value, s.detail) for s in jw.signals]
    assert dataclasses.astuple(pw.consume_advice()) \
        == dataclasses.astuple(jw.consume_advice())
    assert {s.kind for s in pw.signals} >= {"rho_drift",
                                            "cert_storm_onset",
                                            "alpha_drift"}


def test_obs_check_passes_on_the_cpu(tmp_path):
    """``python -m repro_torch.obs.check --device cpu``: every check of the
    JAX package's self-test, check 8 (ψ bitwise under ``obs.disable()``
    and with the analysis layer armed) included."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **ONE_CORE)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.check", "--device", "cpu",
         "--out-dir", str(tmp_path / "out")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "FAIL" not in proc.stdout
    assert "psi bitwise-equal with watch+slo+profiler armed" in proc.stdout
    for name in ("metrics.prom", "metrics.json", "trace.jsonl",
                 "profile.folded", "explain.txt", "calibration.json"):
        assert (tmp_path / "out" / name).stat().st_size > 0
