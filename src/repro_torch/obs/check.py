"""``python -m repro_torch.obs.check`` — end-to-end self-test of the
telemetry plane: the JAX package's ``repro.obs.check`` on the port. The
streamed resolves run on ``--device`` (``cuda`` by default, which needs a
card; ``cpu`` runs on the host) at float64.

What it exercises, against a real streamed ψ resolve (powerlaw graph →
poisson event log → online rate estimation → PsiService queries):

1. **accounting** — every ingested event is counted exactly once
   (``psi_stream_events_total`` == len(log)), at least one resolve ran,
   and the resolve/convergence records agree with the metrics registry.
2. **latency plumbing** — the query histogram is populated and internally
   consistent (p50 ≤ p99 ≤ max).
3. **tracing** — the JSONL trace parses line by line, contains nested
   ``engine.run`` spans, and exports a loadable Chrome trace_event file.
4. **exposition** — the Prometheus text renders with HELP/TYPE headers
   and histogram bucket monotonicity; the JSON dump round-trips.
5. **analysis layer** — an :class:`~repro_torch.obs.slo.SLOEngine` ticking over
   the live registry produces a sane report (and a forced violation
   counts), the span-stream profiler folds the recorded trace into
   stacks with positive self time, and the HTTP endpoints
   (``/healthz``, ``/slo``) answer on an ephemeral port.
6. **decision observability** — :func:`repro_torch.kernels.autotune.plan_regime`
   records a full :class:`~repro_torch.obs.explain.DecisionRecord` (candidate
   table, ``BSR_MIN_OCCUPANCY`` prunes, ``PLAN_CACHE`` hit/miss), the
   plan-cache counters land in the registry, and
   ``PsiService.explain()`` renders the EXPLAIN-ANALYZE tree.
7. **calibration loop** — the acceptance drill: skewed cost-model
   constants (injected via ``slot_bytes``) make the uncalibrated planner
   mis-rank; a microbench pass feeds the
   :class:`~repro_torch.obs.calibrate.CalibrationStore`; the calibrated
   planner then recovers the measured winner, the ``model_misranked``
   event fires, and ``psi_plan_misprediction_ratio`` is published.
8. **parity** — the same workload re-run under ``obs.disable()`` (with
   the decision log nulled and the populated calibration store still
   armed — calibration is planner input, not telemetry) produces a
   bitwise-identical ψ vector, and a third run with the FULL analysis
   layer armed (convergence watch attached, SLO engine ticking, profiler
   consuming the tracer) is bitwise-identical too: analysis only reads.

Exit status is non-zero on the first failed check. Artifacts land in
``--out-dir``: ``metrics.prom``, ``metrics.json`` (the full obs dump),
``trace.jsonl``, ``trace.chrome.json``, ``profile.folded``,
``explain.txt`` (the rendered decision trail), ``calibration.json``
(the per-regime correction factors).

Check 8 holds on the card too: the reference engine's sums run in a fixed
order there as well, so the three runs of one workload give the same bits.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .. import obs


def _build_and_stream(events: int, seed: int = 7, *, device: str = "cuda"):
    """One small streamed resolve; returns (service, ingestor, log)."""
    import torch

    from ..core import Activity, PsiService, RATE_FLOOR, heterogeneous
    from ..graphs import powerlaw_configuration
    from ..stream import FreshnessPolicy, StreamIngestor, poisson_stream

    n, m = 600, 3_600
    g = powerlaw_configuration(n, m, seed=seed)
    truth = heterogeneous(n, seed=seed + 1)
    horizon = events / float(truth.total.sum())
    log = poisson_stream(truth, horizon, seed=seed + 2, graph=g)
    cold = Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))
    svc = PsiService(g, cold, tol=1e-8, backend="reference",
                     dtype=torch.float64, device=device)
    ing = StreamIngestor(svc, half_life=horizon / 2, topk=3,
                         policy=FreshnessPolicy(coalesce=16,
                                                resolve_every=250))
    ing.ingest(log)
    rng = np.random.default_rng(0)
    for _ in range(8):
        users = rng.integers(0, n, 4)
        svc.scores_batch(users)
        svc.rank_of(users)
        svc.top_k(3)
    return svc, ing, log


def _warm_device_reads(device: str) -> None:
    """Launch the ranked reads' one device kernel (``torch.topk``) once
    before the measured run. A process loads a CUDA kernel's module at its
    first launch (~0.1 s on an H100), which the first ``top_k`` read would
    otherwise pay and the query-latency SLO of check 5a would judge as read
    latency. Nothing to load on the CPU."""
    import time

    import torch
    if torch.device(device).type != "cuda":
        return
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        torch.topk(torch.zeros(8, dtype=dtype, device=device), 3)[0].cpu()
    print(f"[obs.check] device warm-up: first top-k launches "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def run_check(out_dir: str, *, events: int = 1_200,
              device: str = "cuda") -> list[str]:
    """Run every check; returns the list of failure strings (empty = ok)."""
    import torch

    from ..device import resolve_device
    device = str(resolve_device(device))    # no card: raise before any work
    os.makedirs(out_dir, exist_ok=True)
    failures: list[str] = []

    def check(cond: bool, msg: str) -> None:
        tag = "ok " if cond else "FAIL"
        print(f"[obs.check] {tag} {msg}")
        if not cond:
            failures.append(msg)

    trace_path = os.path.join(out_dir, "trace.jsonl")
    if os.path.exists(trace_path):
        os.remove(trace_path)
    _warm_device_reads(device)
    prev = obs.configure(registry=obs.MetricsRegistry(),
                         tracer=obs.Tracer(trace_path),
                         tracker=obs.ConvergenceTracker())
    try:
        svc, ing, log = _build_and_stream(events, device=device)
        psi_live = np.array(svc.scores(), copy=True)

        reg = obs.metrics.get_registry()
        # 1. accounting
        ev_fam = reg.get("psi_stream_events_total")
        counted = (sum(ch.value for _, ch in ev_fam.children())
                   if ev_fam else 0)
        check(counted == len(log),
              f"event accounting: counted {int(counted)} == {len(log)}")
        resolves = reg.value("psi_stream_resolves_total") or 0
        check(resolves >= 1, f"resolves ran: {int(resolves)} >= 1")
        n_resolves = sum(len(obs.convergence.get_tracker().series(t))
                         for t in obs.convergence.get_tracker().tenants())
        check(n_resolves >= 1,
              f"convergence records: {n_resolves} resolve(s) recorded")
        rec_total = reg.get("psi_resolves_total")
        rec_count = (sum(ch.value for _, ch in rec_total.children())
                     if rec_total else 0)
        check(rec_count == n_resolves,
              f"registry/tracker agree: {int(rec_count)} == {n_resolves}")

        # 2. latency plumbing
        qfam = reg.get("psi_query_seconds")
        pooled = qfam.merged() if qfam is not None else None
        check(pooled is not None and pooled.count > 0,
              "query latency histogram populated")
        if pooled is not None and pooled.count:
            p50, p99 = pooled.quantile(0.5), pooled.quantile(0.99)
            check(0 <= p50 <= p99 <= pooled._max + 1e-12,
                  f"quantiles ordered: p50={p50:.2e} <= p99={p99:.2e}")

        # 3. tracing
        tracer = obs.trace.get_tracer()
        tracer.flush()
        with open(trace_path) as f:
            spans = [json.loads(line) for line in f if line.strip()]
        names = {s["name"] for s in spans}
        check(len(spans) > 0, f"trace JSONL parses ({len(spans)} spans)")
        check("engine.run" in names and "stream.resolve" in names,
              f"expected spans present: {sorted(names)}")
        depths = [s for s in spans if s.get("parent")]
        check(len(depths) > 0, "spans nest (parented spans recorded)")
        chrome = os.path.join(out_dir, "trace.chrome.json")
        tracer.export_chrome(chrome)
        with open(chrome) as f:
            doc = json.load(f)
        check(bool(doc.get("traceEvents")), "chrome export loads")

        # 4. exposition
        prom = reg.to_prometheus()
        check("# TYPE psi_query_seconds histogram" in prom
              and "# HELP" in prom, "prometheus text has HELP/TYPE headers")
        buckets = [int(ln.rsplit(" ", 1)[1]) for ln in prom.splitlines()
                   if ln.startswith("psi_query_seconds_bucket{op=\"top_k\"")]
        check(buckets == sorted(buckets),
              "histogram bucket counts are cumulative-monotone")
        with open(os.path.join(out_dir, "metrics.prom"), "w") as f:
            f.write(prom)
        snap = obs.dump(os.path.join(out_dir, "metrics.json"),
                        device=device, dtype=torch.float64)
        check(bool(snap["fingerprint"].get("python"))
              and "psi_resolves_total" in snap["metrics"],
              "obs dump carries fingerprint + metrics + convergence")

        # 5a. SLO engine over the live registry
        from .slo import SLOEngine, default_slos
        engine = SLOEngine(default_slos())
        engine.tick()
        rep = engine.report()
        out_of = [(s["name"], s["value"], s["alerts"]) for s in rep["slos"]
                  if s["alerts"] or not s["meeting_target"]]
        check(len(rep["slos"]) == 4 and rep["alerts_total"] == 0,
              "slo engine reports 4 objectives, 0 alerts on a clean run"
              + (f" (out of target: {out_of})" if out_of else ""))
        p99_row = next(s for s in rep["slos"]
                       if s["name"] == "query_p99_latency")
        check(p99_row["value"] is not None and p99_row["samples"] >= 1,
              "slo engine reads the live query-latency signal")
        from .slo import SLO
        strict = SLOEngine([SLO("impossible_latency",
                                lambda: 1.0, target=1e-9,
                                description="forced violation")])
        strict.tick()
        srow = strict.report()["slos"][0]
        check(srow["bad_samples"] == 1 and not srow["meeting_target"],
              "forced SLO violation is counted against the budget")

        # 5b. span-stream profiler over the recorded trace
        from .profile import Profile
        prof = Profile.from_tracer(obs.trace.get_tracer())
        folded = prof.folded()
        check(bool(folded) and all(v >= 0 for v in folded.values())
              and any("engine.run" in k for k in folded),
              f"profiler folds {len(folded)} stacks incl. engine.run")
        hot = prof.hotspots(3)
        check(bool(hot) and hot[0]["self_s"] > 0,
              "profiler hotspots carry positive self time")
        prof.write_folded(os.path.join(out_dir, "profile.folded"))

        # 5c. HTTP endpoints on an ephemeral port
        import urllib.request
        from . import metrics as obs_metrics
        prev_provider = obs_metrics.set_slo_provider(engine.report)
        server = obs.start_http_server(0)
        try:
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz") as r:
                hz = json.load(r)
            check(hz.get("status") == "ok" and hz.get("slo_installed"),
                  "/healthz answers ok with slo installed")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/slo") as r:
                sdoc = json.load(r)
            check(len(sdoc.get("slos", [])) == 4,
                  "/slo serves the engine report")
        finally:
            server.shutdown()
            obs_metrics.set_slo_provider(prev_provider)
    finally:
        obs.restore(prev)

    # 6. decision observability: the planner leaves a complete audit trail
    from ..graphs import clustered_blocks, powerlaw_configuration
    from ..kernels import autotune
    from . import calibrate as obs_calibrate
    from . import explain as obs_explain
    from . import log as obs_log
    prev = obs.configure(registry=obs.MetricsRegistry(),
                         tracker=obs.ConvergenceTracker(),
                         decisions=obs.DecisionLog())
    try:
        reg = obs.metrics.get_registry()
        g6 = powerlaw_configuration(500, 3_000, seed=11)
        cache = autotune.PlanCache()
        plan1 = autotune.plan_regime(g6, cache=cache, calibration=None)
        rec = obs_explain.get_log().last(kind="regime_plan")
        check(rec is not None and rec.cache == "miss"
              and len(rec.candidates) >= 2 and rec.chosen == plan1.label()
              and rec.source == "model",
              "plan_regime miss records the full candidate table")
        check(bool(rec.pruned)
              and all(p.reason == "BSR_MIN_OCCUPANCY" for p in rec.pruned),
              f"density gate prunes carry their reason "
              f"({len(rec.pruned or ())} pruned)")
        autotune.plan_regime(g6, cache=cache, calibration=None)
        rec2 = obs_explain.get_log().last(kind="regime_plan")
        check(rec2 is not None and rec2.cache == "hit",
              "plan cache hit is recorded as a decision")
        hits = reg.value("psi_plan_cache_hits_total") or 0
        misses = reg.value("psi_plan_cache_misses_total") or 0
        check(hits >= 1 and misses >= 1,
              f"plan-cache counters in registry: hits={int(hits)} "
              f"misses={int(misses)}")
        dec_n = reg.value("psi_plan_decisions_total", kind="regime_plan")
        check((dec_n or 0) >= 2,
              f"psi_plan_decisions_total counts records ({int(dec_n or 0)})")

        # an end-to-end service renders the tree
        from ..core import Activity, PsiService, RATE_FLOOR
        svc_x = PsiService(
            g6, Activity(np.full(g6.n, RATE_FLOOR),
                         np.full(g6.n, RATE_FLOOR)),
            tol=1e-8, backend="reference", dtype=torch.float64,
            device=device)
        svc_x.update_activity(np.asarray([0]), lam=np.asarray([2.0]))
        svc_x.top_k(3)
        tree = svc_x.explain()
        check("EXPLAIN ANALYZE" in tree and "solver_choice" in tree
              and "resolve" in tree,
              "PsiService.explain renders the decision trail")
        with open(os.path.join(out_dir, "explain.txt"), "w") as f:
            f.write(tree + "\n")

        # 7. calibration loop (the acceptance drill). Skewed constants
        # make edge_tile look ~free and BSR ruinous; a deterministic
        # bench plays measured ground truth (BSR actually wins), so the
        # uncalibrated skewed planner must mis-rank and the calibrated
        # one must recover.
        g7 = clustered_blocks(256, 12_000, block=128, p_in=1.0, seed=3)
        skew = (0.001, 1e5, 16.0)          # (edge, bsr, node) bytes/slot
        uncal = autotune.plan_regime(g7, cache=None, calibration=None,
                                     slot_bytes=skew)
        check(uncal.regime == "edge_tile",
              f"skewed uncalibrated planner mis-ranks "
              f"(picked {uncal.regime})")
        store = obs.CalibrationStore(
            env=obs.env_key(device, torch.float32))   # plan_regime's dtype
        real_bench = autotune._microbench_step
        autotune._microbench_step = \
            lambda graph, plan, dtype, dev: \
            100.0 if plan.regime == "bsr" else 5_000.0
        try:
            bench = autotune.plan_regime(g7, cache=None, microbench=True,
                                         calibration=store,
                                         slot_bytes=skew, device=device)
        finally:
            autotune._microbench_step = real_bench
        check(bench.regime == "bsr" and bench.source == "microbench",
              f"microbench pass finds the measured winner "
              f"({bench.regime})")
        check(len(store) >= 2 and bool(store.factors()),
              f"calibration store fed ({len(store)} samples, "
              f"factors={sorted(store.factors())})")
        recovered = autotune.plan_regime(g7, cache=None, calibration=store,
                                         slot_bytes=skew, device=device)
        check(recovered.regime == bench.regime
              and recovered.source == "calibrated",
              f"calibrated planner recovers the measured winner "
              f"({recovered.regime}, source={recovered.source})")
        events_mis = obs_log.recent(name="model_misranked")
        check(len(events_mis) >= 1,
              f"model_misranked event fired ({len(events_mis)}x)")
        ratio = reg.value("psi_plan_misprediction_ratio")
        check(ratio is not None and ratio > 1.0,
              f"psi_plan_misprediction_ratio published ({ratio:.1f})")
        store.save(os.path.join(out_dir, "calibration.json"))
        with open(os.path.join(out_dir, "calibration.json")) as f:
            cal_doc = json.load(f)
        check(bool(cal_doc.get("entries"))
              and {e["regime"] for e in cal_doc["entries"]}
              >= {"bsr", "edge_tile"},
              "calibration store round-trips to JSON artifact")
    finally:
        obs.restore(prev)

    # 8. parity: the identical workload with every sink nulled — and the
    # populated calibration store left armed (it is planner input, not
    # telemetry, so obs.disable() must not touch it and ψ must not move)
    prev_store = obs_calibrate.get_store()
    obs_calibrate.set_store(store)
    prev = obs.disable()
    try:
        svc2, _, _ = _build_and_stream(events, device=device)
        psi_null = np.array(svc2.scores(), copy=True)
    finally:
        obs.restore(prev)
        obs_calibrate.set_store(prev_store)
    check(psi_live.shape == psi_null.shape
          and np.array_equal(psi_live, psi_null),
          "instrumented vs disabled psi bitwise-equal "
          "(explain + calibration armed)")

    # 8b. parity with the FULL analysis layer armed: watch subscribed to
    # the tracker, SLO engine ticking, profiler consuming the tracer
    from .slo import SLOEngine as _Eng, default_slos as _slos
    from .watch import ConvergenceWatch
    prev = obs.configure(registry=obs.MetricsRegistry(),
                         tracer=obs.Tracer(None),
                         tracker=obs.ConvergenceTracker())
    watch = ConvergenceWatch()
    watch.attach()
    try:
        eng = _Eng(_slos())
        svc3, _, _ = _build_and_stream(events, device=device)
        eng.tick()
        psi_armed = np.array(svc3.scores(), copy=True)
        prof3 = Profile.from_tracer(obs.trace.get_tracer())
        check(bool(prof3.records), "analysis-armed run recorded spans")
        check(watch.summary()["signals"] == 0,
              "healthy run raises no watch anomalies")
    finally:
        watch.detach()
        obs.restore(prev)
    check(np.array_equal(psi_live, psi_armed),
          "psi bitwise-equal with watch+slo+profiler armed")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="self-test the repro_torch.obs telemetry plane")
    ap.add_argument("--out-dir", default="obs_check_out",
                    help="artifact directory (metrics.prom, metrics.json, "
                         "trace.jsonl, trace.chrome.json)")
    ap.add_argument("--events", type=int, default=1_200,
                    help="approximate synthetic stream size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    failures = run_check(args.out_dir, events=args.events,
                         device=args.device)
    if failures:
        print(f"[obs.check] {len(failures)} check(s) FAILED:")
        for msg in failures:
            print(f"[obs.check]   - {msg}")
        return 1
    print(f"[obs.check] all checks passed; artifacts in "
          f"{os.path.abspath(args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
