"""Serving launcher: batched ψ-score queries on one graph or a fleet, LM
generation, and MIND's interests and retrieval.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --backend auto --microbench --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --tenants 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --executor sync --device cpu

``--arch <lm arch>`` (``tinyllama-1.1b``, ``yi-9b``, ``nemotron-4-340b``,
``mixtral-8x22b``, ``mixtral-8x7b``, and the port's own ``mimo-v2-flash``,
whose cache holds a kind of attention layer a tensor: no ``--shape``
cell, the benchmark's ``mimo.decode`` cuts it to a card) serves the JAX
launcher's LM loop
(:func:`serve_lm`): ``--requests`` batches of ``--batch`` random 16-token
prompts (numpy seed 1), each prefilled and then decoded greedily (argmax) to
``--gen-len`` tokens, on the reduced config, each request's prefill ms and
decode ms a token printed; ``--shape prefill_32k | decode_32k`` runs the
full config with prompts of the cell's 32,768 tokens instead, cuts the
cell's global batch to ``--batch`` (1 by default), prints the cut and
prints the cell's metric a request: the prefill's time (``prefill_32k``)
or the decode's time a token at the 32k context (``decode_32k``). The
cache holds the prompt and the generated tokens (the JAX launcher sizes it
to the prompt alone, so its decode overwrites the oldest positions of a
full-attention model's cache). A prompt longer than 2,048 tokens is best a
multiple of 512: the attention schedule's blocks are the greatest common
divisors of 512 and 1,024 with its length, as in the JAX package.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --requests 1 --device cpu

``--arch mind`` serves the JAX launcher's recsys loop
(:func:`serve_recsys`): ``--requests`` batches of ``--batch`` users (4; numpy
seed 2, 4 profile tags a user) on the reduced config, each request's
interests extracted and the first user's top-5 of 1,000 random candidates
printed. ``--shape serve_p99 | serve_bulk`` runs the full config at the
cell's 512 or 262,144 users (8 tags a user) and prints the extraction's ms
a batch and users/s; ``--shape retrieval_cand`` prints the ms to score 10⁶
random candidates against one user's interests. Every profile bag's sum
runs through the ``seg_mm`` kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mind \
        --device cpu

For ``psi-score``: the single-tenant loop of the JAX package's launcher, on
the same graph and seeds, printing the same lines: a cold solve, the top-k,
``--requests`` batches of ``rank_of`` + ``scores_batch``, and a live
activity update mid-traffic. ``--backend auto`` lets the autotuner pick the
kernel regime (``--microbench`` times every candidate instead of trusting
the cost model) and prints the plan; ``--accelerate`` wraps any backend's
step in the Aitken-extrapolated loop; ``--backend push`` serves from the
local residual-push engine, whose solves carry a certified error bound.
``--device cuda`` (the default) needs a card; ``--device cpu`` runs the
plain PyTorch versions of the kernels.

``--tenants K`` (K > 1) serves K independent tenants from one
:class:`~repro_torch.serving.TenantFleet` instead — the JAX launcher's fleet
path, with its tenants and seeds: the request loop goes round-robin across
the tenants, one tenant gets a live activity update mid-traffic, and the run
ends with the fleet-wide top-k. ``--backend`` then names a fleet regime
(``auto`` by default; on a card ``auto`` runs the lane-batched CUDA kernels
for the buckets above ``dense_max_n``); ``--bucket-sizes`` sets the node
rungs of the bucket policy.

``--stream {poisson,burst,flash}`` replays a synthetic live event log (posts,
reposts, follows, unfollows) through a :class:`~repro_torch.stream.
StreamIngestor` into a float64 ``PsiService`` that starts cold, as the JAX
launcher's ``--stream`` does on the same 2,000-user graph and seeds:
online λ/μ estimation, coalesced O(Δ) patches, a resolve every
``--resolve-every`` events, then query rounds and a parity check against a
from-scratch solve.

``--executor {sync,async}`` runs the fault-tolerant chunk drivers instead of
``PsiService``, as the JAX launcher's ``--executor`` does on the same
10,000-user graph at tol 1e-7: ``sync`` is the bulk-synchronous
:class:`~repro_torch.runtime.PsiDriver` over the 2-D block-cyclic
:class:`~repro_torch.core.distributed.DistributedPsi` (16 iterations a
chunk) on a ``(world_size, 1)`` mesh — world size 1 unless the caller
started a process group, e.g. under ``torchrun`` — and ``async`` the
bounded-staleness :class:`~repro_torch.asyncexec.AsyncPsiDriver`
(``--num-chunks`` chunks, ``--staleness-tau`` epochs of lag). Both print the
chunk forensics (median and max chunk ms, slow chunks) and the ranked
requests.

``--chaos`` runs the seeded fault-injection drill of
:func:`repro_torch.resilience.check.run_chaos` (crashes, forced-stale
reads, a torn stack checkpoint, a poisoned patch, a corrupted event feed,
then recovery and an exactly-once replay, and the supervisor's ladder) and
prints its ``ResilienceReport``; ``--chaos-seed`` seeds its ``FaultPlan``.
With ``--stream X`` the two run as one drill on one registry.

Observability: ``--metrics-port`` exposes the live registry over HTTP on
localhost (``/metrics``, ``/metrics.json``, ``/healthz``, ``/slo``),
``--trace-out`` records every span to JSONL (+ a Chrome trace at exit),
``--metrics-dump`` writes one snapshot (the port's environment fingerprint
+ metrics + convergence records) at exit, ``--explain`` prints the
EXPLAIN-ANALYZE tree of the last resolve and read, and ``--calibration-out``
saves the cost model's calibration store. The analysis layer rides the same
flags: ``--slo`` judges the run against the default SLO catalog (a
background burn-rate ticker and a verdict epilogue), ``--watch`` attaches
the convergence watch to the resolve stream (with ``--chaos`` it also runs
the seeded α-drift pre-emption drill), and ``--profile-out`` writes the
span stream's folded stacks (with a hotspot and critical-path epilogue).
The JAX launcher's full drill, on the port::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --stream burst --chaos --slo --watch --profile-out profile.folded
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _serve_fleet(args) -> None:
    """Multi-tenant ψ serving: K tenants on one TenantFleet, the request
    loop routed round-robin across them."""
    from ..core import heterogeneous
    from ..graphs import clustered_blocks, powerlaw_configuration
    from ..serving import BucketPolicy, TenantFleet

    policy = (BucketPolicy.from_spec(args.bucket_sizes)
              if args.bucket_sizes else BucketPolicy())
    backend = args.backend or "auto"
    if backend not in ("auto", "dense", "reference", "cuda", "pallas"):
        raise SystemExit(f"--tenants needs a fleet backend "
                         f"(auto|dense|reference|cuda|pallas); got "
                         f"{backend!r}")
    if args.accelerate:
        raise SystemExit("--accelerate is not supported with --tenants > 1 "
                         "(the fleet's masked batch loop has no Aitken "
                         "composition yet)")
    fleet = TenantFleet(backend=backend, tol=1e-8, policy=policy,
                        check_every=args.check_every,
                        microbench=args.microbench, device=args.device)
    tids = []
    t0 = time.perf_counter()
    for k in range(args.tenants):
        if k % 2 == 0:                        # alternate graph regimes
            g = powerlaw_configuration(2_000, 12_000, seed=100 + k)
        else:
            g = clustered_blocks(1_024, 10_000, block=128, p_in=0.9,
                                 seed=100 + k)
        act = heterogeneous(g.n, seed=200 + k)
        tid = f"tenant{k}"
        spec = fleet.admit(tid, g, act)
        tids.append(tid)
        print(f"[serve] admitted {tid}: n={g.n} m={g.m} → {spec}")
    fleet.solve()
    print(f"[serve] fleet[{fleet.backend}] warm in "
          f"{time.perf_counter() - t0:.2f}s on {fleet.device}; occupancy:")
    for spec, acct in fleet.occupancy().items():
        print(f"[serve]   {spec}: {acct['tenants']} tenants "
              f"regime={acct['regime']} "
              f"node_occ={acct['node_occupancy']:.2f} "
              f"edge_occ={acct['edge_occupancy']:.2f}")
    frontier = fleet.frontier
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        tid = tids[r % len(tids)]             # round-robin across tenants
        n = fleet.stats(tid)["n"]
        users = rng.integers(0, n, args.batch)
        t0 = time.perf_counter()
        scores = frontier.scores_batch([tid] * args.batch, users)
        top, _ = frontier.top_k(tid, args.top_k)
        print(f"[serve] req {r} → {tid}: users={users.tolist()} "
              f"psi={np.round(scores, 8).tolist()} "
              f"top-{args.top_k}={top.tolist()} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
        if r == args.requests // 2:           # live update mid-traffic
            u = int(users[0])
            t0 = time.perf_counter()
            fleet.patch_activity(tid, np.asarray([u]), lam=np.asarray([5.0]))
            fleet.solve()
            print(f"[serve] delta update {tid} user {u}: re-converged in "
                  f"{fleet.stats(tid)['iterations']} warm iterations "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms); "
                  f"co-tenant lanes untouched")
    top = frontier.global_top_k(args.top_k)
    print(f"[serve] fleet-wide top-{args.top_k}: "
          + ", ".join(f"{t}/{u}@{s:.2e}" for t, u, s in top))


def _serve_driver(args) -> None:
    """Driver-level ψ serving: the fault-tolerant chunk executors — the
    bulk-synchronous ``runtime/psi_driver.py`` or the bounded-staleness
    ``repro_torch.asyncexec`` pipeline — followed by the shared query
    layer. The JAX launcher's ``_serve_driver``, line for line."""
    from ..core import heterogeneous
    from ..graphs import powerlaw_configuration

    g = powerlaw_configuration(10_000, 70_000, seed=5)
    act = heterogeneous(g.n, seed=6)
    tol = 1e-7
    t0 = time.perf_counter()
    if args.executor == "async":
        from ..asyncexec import AsyncPsiDriver
        drv = AsyncPsiDriver(g, act, num_chunks=args.num_chunks,
                             tau=args.staleness_tau, device=args.device)
        rep = drv.run(tol=tol)
        print(f"[serve] executor=async chunks={args.num_chunks} "
              f"tau={args.staleness_tau}: {rep.iterations} epochs "
              f"gap={rep.gap:.2e} in {time.perf_counter() - t0:.2f}s; "
              f"max_staleness={rep.max_staleness} "
              f"overlap={rep.overlap_efficiency:.2f}x "
              f"verify_sweeps={rep.sync_sweeps}")
    else:
        from ..core.distributed import DistributedPsi
        from ..runtime import PsiDriver
        from .mesh import make_mesh, world_size
        mesh = make_mesh((world_size(), 1), ("data", "model"),
                         device=args.device)
        try:
            drv = PsiDriver(DistributedPsi.from_graph(g, act, mesh),
                            chunk_iters=16)
            rep = drv.run(tol=tol)
        finally:
            mesh.close()
        print(f"[serve] executor=sync chunk_iters=16: {rep.iterations} "
              f"iterations gap={rep.gap:.2e} in "
              f"{time.perf_counter() - t0:.2f}s")
    # straggler forensics: measured durations + the deadline that tripped
    if rep.chunk_durations:
        durs = np.asarray(rep.chunk_durations)
        print(f"[serve] {durs.size} chunk steps: median="
              f"{np.median(durs) * 1e3:.1f} ms max={durs.max() * 1e3:.1f} ms")
    for ev in rep.slow_chunk_events:
        print(f"[serve] slow chunk {ev.chunk}: {ev.duration * 1e3:.1f} ms "
              f"exceeded deadline {ev.deadline * 1e3:.1f} ms")
    if not rep.slow_chunk_events:
        print("[serve] no chunk exceeded its deadline")
    q = rep.queries()
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        users = rng.integers(0, g.n, args.batch)
        t0 = time.perf_counter()
        scores = q.scores_batch(users)
        top, _ = q.top_k(args.top_k)
        print(f"[serve] req {r}: users={users.tolist()} "
              f"psi={np.round(scores, 8).tolist()} "
              f"top-{args.top_k}={top.tolist()} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")


def _serve_stream(args) -> None:
    """Streaming ψ serving: a live event log (posts / reposts / follows /
    unfollows) drives online λ/μ estimation and coalesced O(Δ) patches
    against a float64 PsiService; the freshness policy decides when to
    re-resolve versus serve the existing ranking with certified staleness.
    The JAX launcher's ``_serve_stream``, line for line."""
    import torch

    from ..core import (Activity, PsiService, RATE_FLOOR, heterogeneous,
                        make_engine)
    from ..graphs import powerlaw_configuration
    from ..stream import (FreshnessPolicy, StreamIngestor, burst_stream,
                          flash_crowd_stream, poisson_stream)

    n, m = 2_000, 12_000
    g = powerlaw_configuration(n, m, seed=7)
    truth = heterogeneous(n, seed=8)
    horizon = args.stream_events / float(truth.total.sum())
    if args.stream == "poisson":
        log = poisson_stream(truth, horizon, seed=9, graph=g)
    elif args.stream == "burst":
        rng = np.random.default_rng(9)
        log = burst_stream(truth, horizon, seed=9,
                           burst_users=rng.integers(0, n, 16),
                           burst_factor=10.0)
    else:
        log = flash_crowd_stream(g, truth, horizon, seed=9,
                                 new_followers=96, churn=0.3)
    backend = args.backend or "reference"
    # the platform starts cold: every user at the RATE_FLOOR clamp; the
    # stream teaches the estimator the true rates event by event
    cold = Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))
    svc = PsiService(g, cold, tol=1e-8, backend=backend,
                     check_every=args.check_every, dtype=torch.float64,
                     device=args.device)
    args._svc = svc                          # for the --explain epilogue
    half_life = args.half_life if args.half_life else horizon / 2
    ing = StreamIngestor(
        svc, half_life=half_life, topk=args.top_k,
        policy=FreshnessPolicy(coalesce=64,
                               resolve_every=args.resolve_every))
    print(f"[serve] stream={args.stream}: {len(log)} events over "
          f"{horizon:.1f}s event-time ({log.counts()}), half_life="
          f"{half_life:.1f}s, resolve_every={args.resolve_every} events, "
          f"backend={svc.backend} device={svc.engine.device}")
    t0 = time.perf_counter()
    rep = ing.ingest(log)
    wall = time.perf_counter() - t0
    print(f"[serve] ingested {rep.events_total} events in {wall:.2f}s "
          f"({rep.events_total / wall:.0f} ev/s sustained) — "
          f"{rep.resolves} resolves, top-{args.top_k} churn history "
          f"{[round(c, 2) for c in ing.churn_history]}")
    print(f"[serve] freshness: staleness={rep.staleness_events} events / "
          f"{rep.staleness_seconds:.1f}s, dirty_mass={rep.dirty_mass:.2e}, "
          f"certified(max_events=0)={rep.certify(max_events=0)}")
    top, _ = ing.top_k(args.top_k)
    print(f"[serve] top-{args.top_k}: {top.tolist()}")
    # batched query traffic against the resolved service (populates the
    # psi_query_seconds / cache-hit telemetry the obs epilogue summarizes)
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        users = rng.integers(0, n, args.batch)
        svc.scores_batch(users)
        svc.rank_of(users)
        svc.top_k(args.top_k)
    print(f"[serve] {args.requests} query rounds (batch {args.batch} + "
          f"rank + top-{args.top_k}) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    # parity + estimation quality vs the generator's ground truth
    batch = make_engine("reference", graph=svc.graph,
                        activity=svc.engine.activity, dtype=torch.float64,
                        device=args.device).run(tol=1e-8)
    err = float(np.abs(svc.scores() - batch.psi.cpu().numpy()).max())
    lam_hat, mu_hat = ing.estimator().rates()
    rate_err = (np.abs(lam_hat - truth.lam).sum()
                + np.abs(mu_hat - truth.mu).sum()) \
        / float(truth.total.sum())
    # Poisson information floor: ~0.8·√(2n/events) l1 relative error is the
    # best ANY estimator can do from this many events over this many users
    floor = 0.8 * (2 * n / max(1, rep.events_total)) ** 0.5
    print(f"[serve] psi parity vs from-scratch batch: {err:.2e}; "
          f"estimator l1 rate err vs ground truth: {rate_err:.1%} "
          f"(Poisson information floor at {len(log)} events / {n} users "
          f"≈ {floor:.0%})")


def _serve_chaos(args) -> None:
    """Chaos drill: the seeded fault-injection scenario of
    :mod:`repro_torch.resilience.check` against the whole serving stack —
    streaming ingestion, whole-stack checkpoints, a mid-stream crash,
    exactly-once replay, the supervised-resolve ladder — then the
    ResilienceReport. The JAX launcher's ``_serve_chaos``, line for line."""
    from ..resilience.check import run_chaos

    t0 = time.perf_counter()
    report, metrics = run_chaos(seed=args.chaos_seed, device=args.device)
    print(f"[serve] chaos drill ({metrics['dtype']}, "
          f"n={metrics['n']} m={metrics['m']} "
          f"events={metrics['events']}) in "
          f"{time.perf_counter() - t0:.2f}s")
    print(f"[serve] recovered at offset {metrics['offset']} "
          f"(checkpoint step {metrics['recovered_step']}), "
          f"{metrics['restarts']} mid-run restarts, "
          f"parity vs fault-free fixed point: "
          f"{metrics['parity_err']:.2e} (tol {metrics['psi_tol']:g})")
    print(f"[serve] recovery overhead {metrics['recovery_overhead']:.2f}x "
          f"fault-free wall, mttr {metrics['mttr_s'] * 1e3:.0f} ms, "
          f"{metrics['degraded_served']} degraded answers served "
          "(staleness-tagged)")
    print(report.summary())


def _serve_watch(args) -> None:
    """Seeded pre-emption scenario (``--watch`` with ``--chaos``): a
    deterministic schedule of μ-raising patches marches the contraction
    modulus α = ‖M‖₁ toward the sentinel wall. The baseline arm shows the α
    sentinel *would* trip at some patch step; the watched arm's trend
    projection flags the drift strictly earlier, stops the escalation, and
    the supervisor consumes the advice as a pre-emptive sync sweep — a
    certified answer is served and the sentinel never fires. The JAX
    launcher's ``_serve_watch``, line for line."""
    from ..asyncexec import AsyncPsiDriver
    from ..core import heterogeneous
    from ..graphs import powerlaw_configuration
    from ..obs.watch import ConvergenceWatch
    from ..resilience.health import Sentinels, alpha_norm
    from ..resilience.supervisor import ResilientResolver

    n, m, wall = 400, 2_400, 0.995
    factors = [1.35] * 16                      # deterministic μ escalation

    def build():
        g = powerlaw_configuration(n, m, seed=13)
        return AsyncPsiDriver(g, heterogeneous(n, seed=14),
                              num_chunks=3, tau=2, device=args.device)

    def patch(drv, f):
        users = np.arange(n)
        drv.host.patch_activity(users, mu=drv.host.mu[users] * f)

    # arm 1 (baseline, no watch): walk the schedule until the sentinel
    # trips — this is the incident the watch must get ahead of
    drv = build()
    sent = Sentinels(alpha_max=wall)
    trip_step = trip_alpha = None
    for step, f in enumerate(factors):
        patch(drv, f)
        if sent.check_alpha(drv.host) is not None:
            trip_step, trip_alpha = step, alpha_norm(drv.host)
            break
    if trip_step is None:
        raise SystemExit("[watch] drill broken: the μ schedule never "
                         "reached the α sentinel wall")
    print(f"[watch] baseline arm: α sentinel trips at patch {trip_step} "
          f"(α={trip_alpha:.4f} ≥ {wall})")

    # arm 2 (watched): same schedule, but every patch feeds the watch;
    # the projected trend flags the drift before the wall and the
    # supervisor pre-empts with a certified sync sweep
    drv = build()
    watch = args._watch or ConvergenceWatch()
    watch_sent = Sentinels(alpha_max=wall)
    resolver = ResilientResolver(drv, tol=1e-6, max_iter=4_000,
                                 attempt_deadline_s=60.0,
                                 sentinels=watch_sent, watch=watch)
    watch.consume_advice()        # drop advice left over from earlier phases
    flag_step = None
    for step, f in enumerate(factors):
        patch(drv, f)
        watch.observe_alpha(alpha_norm(drv.host))
        if watch.advice().sync_sweep:
            flag_step = step               # control action: stop escalating
            break
    if flag_step is None or flag_step >= trip_step:
        raise SystemExit(
            f"[watch] drill FAILED: watch flagged at "
            f"{flag_step} vs sentinel trip at {trip_step}")
    out = resolver.resolve()
    preempted = list(resolver.report.preemptions)
    trips = [str(t) for t in watch_sent.trips]
    print(f"[watch] watched arm: α-drift flagged at patch {flag_step} "
          f"(α={alpha_norm(drv.host):.4f} < {wall}), "
          f"{trip_step - flag_step} patches ahead of the baseline trip")
    print(f"[watch] supervisor pre-empted: preemptions={preempted}, "
          f"escalation={out.escalation!r}, degraded={out.degraded}, "
          f"err_bound={out.psi_error_bound:.2e}, "
          f"sentinel trips in watched arm: {trips or 'none'}")
    if not preempted or trips:
        raise SystemExit("[watch] drill FAILED: expected a pre-emption "
                         "and zero sentinel trips in the watched arm")


def _obs_epilogue(args) -> None:
    """When any obs flag was given: print the human summary (query
    p50/p99, events/s, cache hit ratio, convergence records, retraces,
    MTTR, SLO verdicts, watch signals, top hotspots, explain) and write the
    registry dump, the trace file and the folded-stacks profile. The JAX
    launcher's epilogue; then the SLO ticker stops, the watch detaches
    from the resolve stream and, without ``--metrics-port``, the ``/slo``
    provider is uninstalled."""
    if not (args.metrics_port or args.metrics_dump or args.trace_out
            or args.slo or args.watch or args.profile_out or args.explain):
        return
    from .. import obs
    from ..obs import calibrate as obs_calibrate
    from ..obs import convergence as obs_convergence
    from ..obs import metrics as obs_metrics
    from ..obs import trace as obs_trace

    reg = obs_metrics.get_registry()

    def pooled(name):
        fam = reg.get(name)
        if fam is None or getattr(fam, "kind", "") != "histogram":
            return None
        m = fam.merged()
        return m if m.count else None

    def total(name):
        fam = reg.get(name)
        return (sum(ch.value for _, ch in fam.children())
                if fam is not None else 0.0)

    q = pooled("psi_query_seconds")
    if q is not None:
        print(f"[obs] query latency: p50={q.quantile(0.5) * 1e3:.2f} ms "
              f"p99={q.quantile(0.99) * 1e3:.2f} ms over {q.count} queries")
    evs = reg.value("psi_stream_ingest_events_per_s")
    if evs:
        print(f"[obs] stream ingest: {evs:.0f} ev/s "
              f"({int(total('psi_stream_events_total'))} events, "
              f"{int(total('psi_stream_resolves_total'))} resolves)")
    cache = reg.get("psi_query_cache_total")
    if cache is not None:
        tot = sum(ch.value for _, ch in cache.children())
        hits = reg.value("psi_query_cache_total", result="hit") or 0.0
        if tot:
            print(f"[obs] query cache: hit ratio {hits / tot:.1%} "
                  f"({int(hits)}/{int(tot)})")
    tracker = obs_convergence.get_tracker()
    for tenant in tracker.tenants():
        recs = tracker.series(tenant)
        if not recs:
            continue
        last = recs[-1]
        pts = sum(len(r.points) for r in recs)
        tag = "" if tenant == "_default" else f" tenant={tenant}"
        print(f"[obs] convergence{tag}: {len(recs)} resolves, "
              f"{pts} gap-trajectory points; last [{last.backend}] "
              f"{last.iterations} iters gap={last.gap:.2e}")
    retraces = total("psi_retraces_total")
    print(f"[obs] silent jit retraces: {int(retraces)}")
    mttr = pooled("psi_resilience_mttr_seconds")
    if mttr is not None:
        print(f"[obs] resilience: {mttr.count} recoveries, "
              f"mttr mean={mttr.sum / mttr.count * 1e3:.0f} ms "
              f"p99={mttr.quantile(0.99) * 1e3:.0f} ms; "
              f"{int(total('psi_resilience_degraded_served_total'))} "
              f"degraded answers")
    slo_engine = args._slo_engine
    if slo_engine is not None:
        args._slo_stop.set()                # quiesce the background ticker
        slo_engine.tick()                   # one final synchronous sample
        for line in slo_engine.summary():
            print(f"[slo] {line}")
        if not args.metrics_port:
            slo_engine.uninstall()
    watch = args._watch
    if watch is not None:
        ws = watch.summary()
        print(f"[watch] {ws['signals']} anomaly signal(s): "
              f"{ws['by_kind'] or '{}'}")
        watch.detach()
    tracer = obs_trace.get_tracer()
    if tracer.enabled and (args.profile_out or args.slo):
        from ..obs.profile import Profile
        prof = Profile.from_tracer(tracer)
        if prof.records:
            print("[profile] top hotspots (self time):")
            for h in prof.hotspots(5):
                split = (f" dispatch={h['dispatch_s'] * 1e3:.1f}ms "
                         f"sync={h['sync_s'] * 1e3:.1f}ms"
                         if h["dispatch_s"] or h["sync_s"] else "")
                print(f"[profile]   {h['frame']}: "
                      f"self={h['self_s'] * 1e3:.1f}ms "
                      f"total={h['total_s'] * 1e3:.1f}ms "
                      f"x{h['count']}{split}")
            cp = prof.critical_path()
            if cp.steps:
                print(f"[profile] {cp.describe()}")
            if args.profile_out:
                prof.write_folded(args.profile_out)
                print(f"[profile] folded stacks -> {args.profile_out}")
    svc = getattr(args, "_svc", None)
    if args.explain:
        if svc is None:
            print("[explain] no PsiService ran in this mode; "
                  "nothing to explain")
        else:
            tree = svc.explain()
            print(tree)
            if args.explain_out:
                with open(args.explain_out, "w") as fh:
                    fh.write(tree + "\n")
                print(f"[explain] decision trail -> {args.explain_out}")
        if args.calibration_out:
            obs_calibrate.get_store().save(args.calibration_out)
            print(f"[explain] calibration store -> {args.calibration_out}")
    if args.metrics_dump:
        if svc is None:
            obs.dump(args.metrics_dump, device=args.device)
        else:
            obs.dump(args.metrics_dump, device=svc.engine.device,
                     dtype=svc.engine.dtype)
        print(f"[obs] registry dump -> {args.metrics_dump}")
    if tracer.enabled and args.trace_out:
        tracer.flush()
        chrome = args.trace_out + ".chrome.json"
        tracer.export_chrome(chrome)
        print(f"[obs] trace -> {args.trace_out} "
              f"({len(tracer.spans)} spans retained, "
              f"{tracer.dropped} dropped); chrome view -> {chrome}")
    if args.metrics_port:
        print(f"[obs] /metrics, /metrics.json, /healthz and /slo still "
              f"live on port {args.metrics_port} until the process exits")


LM_PROMPT = 16


def serve_lm(arch: str, requests: int, device, *, shape: str | None = None,
             batch: int | None = None, gen_len: int = 8, log=print) -> dict:
    """The JAX launcher's LM loop: ``requests`` batches of ``batch`` random
    prompts (numpy seed 1), each prefilled and decoded greedily (argmax) to
    ``gen_len`` tokens, on the reduced config (prompts of LM_PROMPT tokens,
    ``batch`` 4 by default). ``shape`` runs the full config with prompts of
    the cell's length instead, its global batch cut to ``batch`` (1 by
    default), and prints the cell's metric a request: the prefill's ms and
    tokens/s (``prefill_32k``) or the decode's ms a token and tokens/s at
    that context (``decode_32k``); the reduced run prints both. The cache
    holds the prompt and the generated tokens. → {"tokens" (each request's
    i64[batch, gen_len] as numpy), "prefill_ms", "decode_ms" (each
    request's prefill, and its decode a token; host clock, synchronised on
    a card), "cache_bytes", "cfg", "params", and the last request's
    "cache" and "logits" (one more decode step fits the cache)}."""
    import torch
    from ..configs import get_arch
    from ..device import resolve_device
    from ..models.transformer import (init_params, make_decode_step,
                                      make_prefill)
    dev = resolve_device(device)
    entry = get_arch(arch)
    if shape is None:
        cfg, batch, prompt, kind = (entry.config(reduced=True), batch or 4,
                                    LM_PROMPT, None)
    else:
        spec = entry.shape(shape)
        cfg, batch, prompt, kind = (entry.config(), batch or 1,
                                    spec.params["seq_len"], spec.kind)
        log(f"[serve] {cfg.name} at {shape}: batch {batch} x prompt {prompt}"
            f" + {gen_len} generated; cut: global batch "
            f"{spec.params['global_batch']} -> {batch}")

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    params = init_params(cfg, 0, device=dev)
    prefill = make_prefill(cfg, max_len=prompt + gen_len)
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(1)
    out = dict(tokens=[], prefill_ms=[], decode_ms=[], cfg=cfg,
               params=params)
    for r in range(requests):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt))
                                ).to(dev)
        t0 = clock()
        cache, logits = prefill(params, toks)
        t1 = clock()
        gen = [torch.argmax(logits, -1)]
        for _ in range(gen_len - 1):
            cache, logits = decode(params, cache, gen[-1])
            gen.append(torch.argmax(logits, -1))
        t2 = clock()
        pre_ms = (t1 - t0) * 1e3
        dec_ms = ((t2 - t1) * 1e3 / (gen_len - 1) if gen_len > 1
                  else float("nan"))
        toks_out = torch.stack(gen, 1).cpu().numpy()
        metric = dict(
            prefill=f"prefill {pre_ms:.1f} ms, "
                    f"{batch * prompt / pre_ms * 1e3:.0f} tokens/s",
            decode=f"decode {dec_ms:.2f} ms a token, "
                   f"{batch / dec_ms * 1e3:.0f} tokens/s at context {prompt}")
        log(f"[serve] req {r}: generated {toks_out.shape} in {t2 - t0:.2f}s "
            f"({metric[kind] if kind else '; '.join(metric.values())}); "
            f"sample={toks_out[0].tolist()}")
        out["tokens"].append(toks_out)
        out["prefill_ms"].append(pre_ms)
        out["decode_ms"].append(dec_ms)
    out.update(cache=cache, logits=logits, cache_bytes=_tensor_bytes(cache))
    return out


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in a (nested) dict."""
    import torch
    if isinstance(tree, dict):
        return sum(_tensor_bytes(x) for x in tree.values())
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


RECSYS_CANDIDATES = 1000       # the JAX launcher's candidates a request
RECSYS_TOP = 5


def serve_recsys(arch: str, requests: int, device, *,
                 shape: str | None = None, batch: int | None = None,
                 params: dict | None = None, log=print) -> dict:
    """The JAX launcher's recsys loop: ``requests`` batches of ``batch``
    users (numpy seed 2; 4 by default, 4 profile tags a user) on the
    reduced config, each request's interests extracted and the first
    user's top-5 of 1,000 random candidates printed (indices into the
    candidates, as the JAX launcher prints them). ``shape`` runs the full
    config instead: ``serve_p99`` / ``serve_bulk`` extract the interests of
    the cell's batch (``batch`` cuts it; ``cfg.profile_tags`` tags a user)
    and print the extraction's ms a batch and users/s, the host's batch
    preparation (the bag layout and the copy) beside it;
    ``retrieval_cand`` extracts one user's interests and prints the ms to
    score the cell's 10⁶ random candidates, and their top-5. Times: host
    clock, synchronised on a card. ``params`` replaces the seeded init. →
    {"ms", "prep_ms" (each request's), "users", "cfg", "params", and the
    last request's "batch" (on the device), "interests", "scores",
    "cand_ids" and "top"}."""
    import torch
    from ..configs import get_arch
    from ..device import resolve_device
    from ..models import recsys
    from .train import recsys_device_batch, recsys_host_batch
    dev = resolve_device(device)
    entry = get_arch(arch)
    kind = None
    if shape is None:
        cfg, users, tags = entry.config(reduced=True), batch or 4, 4
        n_cand = RECSYS_CANDIDATES
    else:
        spec = entry.shape(shape)
        kind = spec.kind
        if kind not in ("serve", "retrieval"):
            raise SystemExit(f"--shape {shape} is a {kind} cell; train it "
                             "with repro_torch.launch.train")
        cfg = entry.config()
        tags = cfg.profile_tags
        users = batch or spec.params["batch"]
        n_cand = spec.params.get("n_candidates", RECSYS_CANDIDATES)
        log(f"[serve] {cfg.name} at {shape}: {users} users a request, "
            f"{tags} profile tags a user"
            + (f", {n_cand} candidates" if kind == "retrieval" else "")
            + "; cut: " + (f"batch {spec.params['batch']} -> {users}"
                           if users != spec.params["batch"] else "nothing"))

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    if params is None:
        params = recsys.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(2)
    out = dict(ms=[], prep_ms=[], users=users, cfg=cfg, params=params)
    with torch.no_grad():
        for r in range(requests):
            t0 = clock()
            b = recsys_device_batch(recsys_host_batch(cfg, users, rng,
                                                      tags=tags, train=False),
                                    cfg, dev)
            t1 = clock()
            u = recsys.user_interests(
                params, b["hist_ids"], b["hist_mask"], b["profile_ids"],
                b["profile_bags"], cfg, profile_layout=b["profile_layout"])
            t2 = clock()
            cands = torch.from_numpy(rng.integers(0, cfg.n_items, (n_cand,))
                                     ).to(dev)
            t3 = clock()
            scores = recsys.retrieval_scores(params, u[0], cands, cfg)
            top = torch.topk(scores, RECSYS_TOP).indices.cpu().numpy()
            t4 = clock()
            prep, ext, score = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                (t4 - t3) * 1e3)
            if kind == "serve":
                ms, metric = ext, (f"interests of {users} users {ext:.2f} "
                                   f"ms, {users / ext * 1e3:.0f} users/s")
            elif kind == "retrieval":
                ms, metric = score, (f"scored {n_cand} candidates in "
                                     f"{score:.3f} ms")
            else:
                ms, metric = ext + score, f"{ext + score:.1f} ms"
            log(f"[serve] req {r}: top-{RECSYS_TOP} items {top.tolist()} "
                f"({metric}; batch prepared in {prep:.1f} ms)")
            out["ms"].append(ms)
            out["prep_ms"].append(prep)
    out.update(batch=b, interests=u, scores=scores, cand_ids=cands, top=top)
    return out


def main(argv=None):
    from ..configs import ARCHS, PORT_ARCHS, get_arch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=[a for a, e in {**ARCHS, **PORT_ARCHS}.items()
                             if e.family in ("psi", "lm", "recsys")],
                    help="psi-score, an LM arch (prefill + greedy decode) "
                         "or mind (interests + retrieval)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=None,
                    help="users a request (psi-score, default 4; mind: 4 "
                         "reduced, the cell's with --shape); prompts a "
                         "request (LM: 4 reduced, 1 with --shape)")
    ap.add_argument("--gen-len", type=int, default=8,
                    help="LM: tokens generated a request")
    ap.add_argument("--shape", default=None,
                    choices=("prefill_32k", "decode_32k", "serve_p99",
                             "serve_bulk", "retrieval_cand"),
                    help="LM: the full config with prompts of this "
                         "cell's length, printing its metric (prefill or "
                         "decode time); mind: the full config at this "
                         "cell's batch (interest extraction, or scoring "
                         "10^6 candidates)")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--backend", default=None,
                    help="ψ solver backend: reference (default) | cuda "
                         "(alias pallas) | auto | accelerated | push "
                         "(local residual push, certified top-k) | "
                         "distributed | async; with "
                         "--tenants > 1 a fleet regime: auto (default) | "
                         "dense | reference | cuda (alias pallas)")
    ap.add_argument("--accelerate", action="store_true",
                    help="wrap the backend's step in the Aitken-"
                         "extrapolated loop")
    ap.add_argument("--check-every", type=int, default=1,
                    help="evaluate the convergence gap every k-th iteration")
    ap.add_argument("--microbench", action="store_true",
                    help="auto backend: time one push launch of every regime "
                         "candidate instead of trusting the cost model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve K independent (graph, activity) tenants "
                         "from one TenantFleet; 1 keeps the single-tenant "
                         "PsiService path")
    ap.add_argument("--bucket-sizes", default=None,
                    help="comma list of node-capacity rungs for the fleet "
                         "bucket policy, e.g. '512,2048,8192'")
    ap.add_argument("--executor", default=None, choices=("sync", "async"),
                    help="run the fault-tolerant chunk driver instead of "
                         "PsiService — sync (bulk-synchronous PsiDriver "
                         "over the 2-D distributed schedule) or async "
                         "(bounded-staleness AsyncPsiDriver)")
    ap.add_argument("--staleness-tau", type=int, default=2,
                    help="async executor: max epoch lag a chunk may fall "
                         "behind (0 = barriered, i.e. sync semantics)")
    ap.add_argument("--num-chunks", type=int, default=4,
                    help="async executor: dst-row chunks in the pipeline")
    ap.add_argument("--stream", default=None,
                    choices=("poisson", "burst", "flash"),
                    help="replay a synthetic live event log (posts/"
                         "reposts/follows/unfollows) through the "
                         "StreamIngestor → online λ/μ estimation → "
                         "continuously-fresh ψ")
    ap.add_argument("--stream-events", type=int, default=4_000,
                    help="approximate event count of the synthetic stream")
    ap.add_argument("--half-life", type=float, default=None,
                    help="estimator decay half-life in event-time seconds "
                         "(default: half the stream horizon)")
    ap.add_argument("--resolve-every", type=int, default=1_000,
                    help="freshness policy: re-resolve psi every N "
                         "ingested events (serve stale in between)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose the live metrics registry over HTTP "
                         "(/metrics Prometheus text, /metrics.json, "
                         "/healthz) on this localhost port")
    ap.add_argument("--metrics-dump", default=None,
                    help="write one obs snapshot (environment fingerprint "
                         "+ metrics + convergence records + recent events) "
                         "to this JSON path at exit")
    ap.add_argument("--trace-out", default=None,
                    help="record every span to this JSONL path (+ a "
                         ".chrome.json trace_event export at exit)")
    ap.add_argument("--explain", action="store_true",
                    help="print the EXPLAIN-ANALYZE decision trail of the "
                         "last resolve and read")
    ap.add_argument("--explain-out", default=None,
                    help="also write the explain tree to this text path "
                         "(implies --explain)")
    ap.add_argument("--calibration-out", default=None,
                    help="with --explain: save the cost-model calibration "
                         "store to this JSON path at exit")
    ap.add_argument("--chaos", action="store_true",
                    help="run the seeded fault-injection drill (crashes, "
                         "torn checkpoints, poisoned patches, corrupted "
                         "event feeds) and print the ResilienceReport")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the FaultPlan the drill injects")
    ap.add_argument("--slo", action="store_true",
                    help="judge the run against the default SLO catalog "
                         "(query p99, freshness, certified error, "
                         "degraded ratio): background burn-rate ticker, "
                         "verdict epilogue, /slo endpoint")
    ap.add_argument("--watch", action="store_true",
                    help="arm pre-emptive convergence anomaly detection; "
                         "with --chaos also runs the seeded α-drift "
                         "pre-emption drill")
    ap.add_argument("--profile-out", default=None,
                    help="write flamegraph folded stacks of the span "
                         "stream to this path (+ hotspot/critical-path "
                         "epilogue)")
    args = ap.parse_args(argv)
    family = get_arch(args.arch).family
    if args.shape and family not in ("lm", "recsys"):
        raise SystemExit(f"--shape: {args.arch} has no serving cell")
    if args.shape:
        try:
            get_arch(args.arch).shape(args.shape)
        except KeyError as exc:
            raise SystemExit(f"--shape {args.shape}: {exc.args[0]}") from None
    if family == "recsys":
        return serve_recsys(args.arch, args.requests, args.device,
                            shape=args.shape, batch=args.batch)
    if family == "lm":
        return serve_lm(args.arch, args.requests, args.device,
                        shape=args.shape, batch=args.batch,
                        gen_len=args.gen_len)
    args.batch = args.batch or 4
    if args.explain_out:
        args.explain = True
    args._svc = None
    if args.trace_out or args.metrics_port or args.profile_out:
        from .. import obs
        if args.trace_out:
            obs.configure(trace_out=args.trace_out)
        elif args.profile_out:
            # the profiler needs retained spans; an in-memory tracer does
            obs.configure(tracer=obs.Tracer(None))
        if args.metrics_port:
            obs.start_http_server(args.metrics_port)
            print(f"[obs] metrics on "
                  f"http://127.0.0.1:{args.metrics_port}/metrics "
                  "(+ /metrics.json /healthz /slo)")
    args._slo_engine = args._slo_stop = args._watch = None
    if args.slo:
        import threading
        from ..obs.slo import DRILL_TIME_SCALE, SLOEngine, default_slos
        engine = SLOEngine(default_slos(), time_scale=DRILL_TIME_SCALE)
        engine.install()                     # /slo endpoint
        stop = threading.Event()

        def _ticker():
            while not stop.wait(0.05):
                engine.tick()

        threading.Thread(target=_ticker, name="slo-ticker",
                         daemon=True).start()
        args._slo_engine, args._slo_stop = engine, stop
        print("[slo] default catalog armed "
              f"(windows scaled x{DRILL_TIME_SCALE:g} to drill time)")
    if args.watch:
        from ..obs.watch import ConvergenceWatch
        args._watch = ConvergenceWatch().attach()   # every finished resolve
        print("[watch] convergence watch attached to the resolve stream")
    if args.chaos or args.stream:
        # --stream X --chaos is the combined drill: streaming ingestion
        # and the fault ladder feed one registry, dumped once at the end
        if args.stream:
            _serve_stream(args)
        if args.chaos:
            _serve_chaos(args)
        if args.watch and args.chaos:
            _serve_watch(args)
        if args._slo_engine is not None:
            # multi-window burn alerts need sustained evidence: give the
            # ticker a moment to accumulate the slow window post-fault
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline:
                if args._slo_engine.report()["alerts_total"] >= 1:
                    break
                time.sleep(0.1)
        _obs_epilogue(args)
        return
    if args.executor:
        _serve_driver(args)
        _obs_epilogue(args)
        return
    if args.tenants > 1:
        _serve_fleet(args)
        _obs_epilogue(args)
        return
    args.backend = args.backend or "reference"

    from ..core import PsiService, heterogeneous
    from ..graphs import powerlaw_configuration
    g = powerlaw_configuration(10_000, 70_000, seed=5)
    act = heterogeneous(g.n, seed=6)
    t0 = time.perf_counter()
    engine_opts = {"microbench": True} if (
        args.backend == "auto" and args.microbench) else None
    svc = PsiService(g, act, tol=1e-8, backend=args.backend,
                     accelerate=args.accelerate,
                     check_every=args.check_every, device=args.device,
                     engine_opts=engine_opts)
    regime = getattr(svc.engine, "regime", None)
    plan = getattr(svc.engine, "plan", None)
    args._svc = svc                          # for the --explain epilogue
    print(f"[serve] backend={svc.backend}"
          + (f" regime={regime}" if regime else "")
          + (f" plan={plan.label()} source={plan.source}" if plan else "")
          + (" accelerated" if svc.engine.accelerate else "")
          + f" device={svc.engine.device}")
    svc.scores()
    print(f"[serve] backend={svc.backend} warm in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({svc.last_iterations()} iterations)")
    top, _ = svc.top_k(args.top_k)
    print(f"[serve] top-{args.top_k}: {top.tolist()}")
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        users = rng.integers(0, g.n, args.batch)
        t0 = time.perf_counter()
        ranks = svc.rank_of(users)        # cached order after req 0
        scores = svc.scores_batch(users)
        print(f"[serve] req {r}: users={users.tolist()} "
              f"ranks={ranks.tolist()} "
              f"psi={np.round(scores, 8).tolist()} "
              f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
        if r == args.requests // 2:       # live update mid-traffic
            u = int(users[0])
            t0 = time.perf_counter()
            svc.update_activity(np.asarray([u]),
                                lam=np.asarray([act.lam[u] * 20]))
            print(f"[serve] delta update user {u}: re-converged in "
                  f"{svc.last_iterations()} warm iterations "
                  f"({(time.perf_counter() - t0) * 1e3:.1f} ms)")
    _obs_epilogue(args)


if __name__ == "__main__":
    main()
