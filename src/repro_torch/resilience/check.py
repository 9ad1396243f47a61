"""Seeded end-to-end chaos acceptance check (CI smoke gate).

Runs the same streaming workload twice — once fault-free (the oracle),
once under a seeded :class:`~repro_torch.resilience.faults.FaultPlan` that
injects worker crashes, forced-stale reads, a torn stack checkpoint, a
NaN-poisoned patch, and a duplicated/reordered/dropped event feed — then
crashes the faulted stack mid-stream, recovers it from its newest
*complete* checkpoint, replays the log suffix exactly-once, and demands
**fixed-point parity**: the recovered stack's ψ must match the fault-free
run's to solver precision (f64: ``max|Δψ| ≤ 1e-12``). It also exercises
the supervisor ladder deterministically (a transient hang that a retry
absorbs, then a permanent hang that degrades to a staleness-tagged
last-known-good answer) and asserts the final
:class:`~repro_torch.resilience.supervisor.ResilienceReport` shows **zero
unsurvived faults**.

Run::

    PYTHONPATH=src python -m repro_torch.resilience.check --dtype float64

The JAX package's ``repro.resilience.check`` on the port. The JAX check
reads its dtype from the global x64 flag; here ``dtype`` (CLI ``--dtype``,
float32 by default, as the JAX check without the flag) and ``device``
(``"cuda"`` by default; raises without a card unless ``device="cpu"``) are
arguments. Under f32 the parity threshold relaxes to the f32 noise floor;
the fault schedule is identical either way, and the JAX package's for the
same seed.

The supervisor drill's wall-clock deadline (0.35 s) and hang (1.0 s) are
the JAX check's, sized for its few hundred nodes. A larger graph's resolves
take longer, so the deadline is derived from the drill's own healthy cold
resolve, timed just before: ``max(0.35 s, 2.5 × that wall)``, with the
hang kept at the JAX ratio to it (1.0 / 0.35). Where that resolve takes
under 0.14 s (the JAX sizes, on the CPU and on the card) the JAX values
stand.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from ..asyncexec.executor import AsyncPsiDriver
from ..core import heterogeneous
from ..graphs import powerlaw_configuration
from ..stream.events import flash_crowd_stream
from ..stream.freshness import FreshnessPolicy
from ..stream.ingest import StreamIngestor
from .faults import FaultPlan
from .recovery import ExactlyOnceReplay, StackCheckpointer, recover, reconcile
from .supervisor import ResilienceReport, ResilientResolver

__all__ = ["run_chaos", "main"]

# the supervisor drill's deadline and hang at the JAX sizes, and the factor
# over a healthy cold resolve's wall that scales them up on larger graphs
LADDER_DEADLINE_S = 0.35
LADDER_HANG_S = 1.0
LADDER_DEADLINE_FACTOR = 2.5
# no mid-stream solves: the check drives flush/solve boundaries itself
_NO_RESOLVE = FreshnessPolicy(coalesce=32, resolve_every=10 ** 9)


def _fresh_stack(graph, activity, *, num_chunks, tau, dtype, device,
                 read_hook=None, ckpt_dir=None):
    driver = AsyncPsiDriver(graph, activity, num_chunks=num_chunks, tau=tau,
                            dtype=dtype, ckpt_dir=ckpt_dir,
                            read_hook=read_hook, device=device)
    ing = StreamIngestor(driver, policy=_NO_RESOLVE)
    return driver, ing


def run_chaos(*, n: int = 300, m: int = 1800, horizon: float = 4.0,
              seed: int = 0, num_chunks: int = 4, tau: int = 2,
              solver_tol: float | None = None,
              psi_tol: float | None = None,
              workdir: str | None = None,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda"
              ) -> tuple[ResilienceReport, dict]:
    """One full chaos scenario; returns (report, metrics) and raises
    AssertionError on any violated resilience contract. Every driver runs
    on ``device`` in ``dtype``."""
    x64 = dtype == torch.float64
    if solver_tol is None:
        solver_tol = 1e-13 if x64 else 1e-6
    if psi_tol is None:
        psi_tol = 1e-12 if x64 else 2e-4
    tmp_ctx = tempfile.TemporaryDirectory() if workdir is None else None
    root = tmp_ctx.name if tmp_ctx else workdir

    g = powerlaw_configuration(n, m, seed=seed + 50)
    act = heterogeneous(g.n, seed=seed + 51)
    log = flash_crowd_stream(g, act, horizon, seed=seed + 52)
    total = len(log)

    # ---- oracle: the fault-free fixed point -------------------------- #
    t0 = time.perf_counter()
    drv_o, ing_o = _fresh_stack(g, act, num_chunks=num_chunks, tau=tau,
                                dtype=dtype, device=device)
    ing_o.ingest(log, resolve_at_end=False)
    ing_o.flush()
    oracle_ingest = time.perf_counter() - t0
    reconcile(drv_o, ing_o)
    rep_o = drv_o.run(tol=solver_tol, max_iter=4000, warm=True)
    assert rep_o.converged, "oracle run failed to converge"
    psi_ref = np.asarray(rep_o.psi, np.float64)
    oracle_wall = time.perf_counter() - t0

    # ---- chaos: same workload under a seeded fault schedule ---------- #
    plan = FaultPlan(seed=seed, crash_every=13, stale_chunk=1, stale_lag=8,
                     torn_after_saves=1, poison_kind="nan",
                     dup_every=41, drop_every=53, reorder_window=5)
    clock = plan.clock()
    t0 = time.perf_counter()
    drv_c, ing_c = _fresh_stack(g, act, num_chunks=num_chunks, tau=tau,
                                dtype=dtype, device=device)
    stack_dir = f"{root}/stack_ckpt"
    stacker = StackCheckpointer(stack_dir, keep=3)

    cut = int(total * 0.75)                     # the "process dies" point
    ckpt_every_ev = max(20, total // 6)
    replay1 = ExactlyOnceReplay(log, clock.wrap_source(log))
    delivered, step = 0, 0
    for ev in replay1:
        assert ev is log[delivered], (
            f"exactly-once prefix broke at event {delivered}")
        ing_c.submit(ev)
        delivered += 1
        if delivered % ckpt_every_ev == 0 and delivered <= cut:
            step += 1
            stacker.save(step, drv_c, ing_c)
        if delivered >= cut:
            break                               # crash: drop all live state
    assert step >= 2, f"need >=2 checkpoints before the crash; got {step}"
    del drv_c, ing_c

    # tear the newest checkpoint (torn write) before recovery touches it
    assert clock.tear_checkpoint(stack_dir), "tear did not fire"

    stack = recover(stack_dir, dtype=dtype, policy=_NO_RESOLVE,
                    ckpt_dir=f"{root}/driver_ckpt",
                    read_hook=clock.read_hook(), device=device)
    assert stack.step < step, (
        f"recovery used the torn step {step}; expected a fallback")
    clock.note_survived("torn_ckpt", clock.injected["torn_ckpt"])
    assert stack.offset == stack.step * ckpt_every_ev

    # replay the un-applied suffix through the same corrupted transport
    replay2 = ExactlyOnceReplay(
        log, clock.wrap_source(log, start=stack.offset), start=stack.offset)
    suffix = []
    for ev in replay2:
        suffix.append(ev)
        stack.ingestor.submit(ev)
    stack.ingestor.flush()
    assert suffix == list(log)[stack.offset:], "exactly-once suffix mismatch"
    for kind in ("dup", "reorder", "drop"):     # delivery parity proven
        clock.note_survived(kind, clock.injected[kind])

    # a NaN-poisoned patch must die at the validation wall
    users = np.arange(min(8, g.n))
    pu, pl, pm = clock.poison_patch(users, stack.driver.host.lam[users],
                                    stack.driver.host.mu[users])
    try:
        stack.driver.patch_activity(pu, lam=pl, mu=pm)
        raise AssertionError("poisoned patch was accepted")
    except ValueError:
        clock.note_survived("poison", clock.injected["poison"])

    # converge under periodic crash+restore, then the supervised resolve
    reconcile(stack.driver, stack.ingestor)
    rep_c = stack.driver.run(tol=solver_tol, max_iter=4000, warm=True,
                             fail_hook=clock.fail_hook())
    assert rep_c.converged, "chaos run failed to converge under crashes"
    assert rep_c.restarts >= 1, "crash schedule never fired"
    resolver = ResilientResolver(stack.driver, tol=solver_tol,
                                 max_iter=4000, attempt_deadline_s=120.0)
    out = resolver.resolve(warm=True)
    assert not out.degraded and out.escalation == "none"
    psi_chaos = np.asarray(out.psi, np.float64)
    chaos_wall = time.perf_counter() - t0

    parity_err = float(np.abs(psi_chaos - psi_ref).max())
    assert parity_err <= psi_tol, (
        f"recovered fixed point drifted: max|dpsi| = {parity_err:.3e} "
        f"> {psi_tol:g}")
    # parity is the proof the crash/staleness defenses worked
    clock.note_survived("crash", clock.injected["crash"])
    clock.note_survived("stale_read", clock.injected["stale_read"])

    # ---- supervisor ladder: transient hang -> retry; permanent -> ---- #
    # ---- degraded serving with an honest staleness tag --------------- #
    clock2 = FaultPlan(seed=seed + 1, hang_chunk=0, hang_epoch=1,
                       hang_delay_s=LADDER_HANG_S).clock()
    hang_budget = [0]                         # how many more calls hang

    def gated(chunk: int, epoch: int) -> float:
        if hang_budget[0] > 0:
            d = clock2.delay_hook()(chunk, epoch)
            if d:
                hang_budget[0] -= 1
            return d
        return 0.0

    drv_h = AsyncPsiDriver(g, act, num_chunks=2, tau=1, dtype=dtype,
                           delay_hook=gated, device=device)
    sup = ResilientResolver(drv_h, tol=1e-6, max_iter=2000,
                            attempt_deadline_s=None, max_retries=1,
                            backoff_s=0.01, allow_rechunk=False,
                            allow_sync=False)
    t1 = time.perf_counter()
    first = sup.resolve(warm=False)           # healthy: seeds last-known-good
    healthy_wall = time.perf_counter() - t1
    assert not first.degraded
    deadline = max(LADDER_DEADLINE_S, LADDER_DEADLINE_FACTOR * healthy_wall)
    clock2.plan = dataclasses.replace(
        clock2.plan, hang_delay_s=LADDER_HANG_S * deadline / LADDER_DEADLINE_S)
    sup.attempt_deadline_s = deadline
    hang_budget[0] = 1                        # one timed-out attempt, then ok
    retried = sup.resolve(warm=True)
    assert not retried.degraded and retried.escalation == "retry"
    assert sup.report.recoveries >= 1 and sup.report.mttr_samples
    hang_budget[0] = 10 ** 9                  # wedged for good
    sup.max_retries = 0
    degraded = sup.resolve(warm=True)
    assert degraded.degraded and degraded.escalation == "degraded"
    assert degraded.freshness is not None
    assert degraded.freshness.staleness_seconds >= 0.0
    assert degraded.psi_error_bound is not None
    assert np.isfinite(degraded.psi_error_bound)
    assert degraded.ranking.err_bound == degraded.psi_error_bound
    hang_budget[0] = 0
    clock2.note_survived("hang", clock2.injected["hang"])

    # ---- the ledger -------------------------------------------------- #
    report = ResilienceReport()
    report.merge_clock(clock).merge_clock(clock2)
    for r in (resolver.report, sup.report):
        report.retries += r.retries
        report.escalations += r.escalations
        report.degraded_served += r.degraded_served
        report.recoveries += r.recoveries
        report.mttr_samples += r.mttr_samples

    for kind in ("crash", "stale_read", "torn_ckpt", "poison",
                 "dup", "reorder", "drop", "hang"):
        assert report.injected.get(kind, 0) >= 1, (
            f"fault class {kind!r} never injected — the schedule is broken")
    assert not report.unsurvived, f"unsurvived faults: {report.unsurvived}"

    metrics = dict(
        n=g.n, m=g.m, events=total, offset=stack.offset,
        dtype="float64" if x64 else "float32",
        solver_tol=solver_tol, psi_tol=psi_tol, parity_err=parity_err,
        oracle_wall_s=oracle_wall, oracle_ingest_s=oracle_ingest,
        chaos_wall_s=chaos_wall,
        recovery_overhead=chaos_wall / max(oracle_wall, 1e-9),
        restarts=int(rep_c.restarts), recovered_step=stack.step,
        refetched=replay1.refetched + replay2.refetched,
        duplicates_suppressed=(replay1.duplicates_suppressed
                               + replay2.duplicates_suppressed),
        mttr_s=report.mttr_s, degraded_served=report.degraded_served,
        ladder_deadline_s=deadline,
        ladder_hang_s=clock2.plan.hang_delay_s,
    )
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    return report, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos acceptance check for the psi stack")
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--m", type=int, default=1800)
    ap.add_argument("--horizon", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--psi-tol", type=float, default=None)
    ap.add_argument("--json", type=str, default=None,
                    help="dump metrics to this path")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32", help="working float type")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print(f"[resilience-check] dtype={args.dtype} "
          f"n={args.n} m={args.m} horizon={args.horizon} seed={args.seed}")
    try:
        report, metrics = run_chaos(n=args.n, m=args.m,
                                    horizon=args.horizon, seed=args.seed,
                                    psi_tol=args.psi_tol,
                                    dtype=getattr(torch, args.dtype),
                                    device=args.device)
    except AssertionError as e:
        print(f"[resilience-check] FAIL: {e}")
        return 1
    print(f"[resilience-check] events={metrics['events']} "
          f"recovered@offset={metrics['offset']} "
          f"restarts={metrics['restarts']} "
          f"parity_err={metrics['parity_err']:.3e} "
          f"(tol {metrics['psi_tol']:g})")
    print(f"[resilience-check] oracle={metrics['oracle_wall_s']:.2f}s "
          f"chaos={metrics['chaos_wall_s']:.2f}s "
          f"overhead={metrics['recovery_overhead']:.2f}x "
          f"mttr={metrics['mttr_s'] * 1e3:.0f}ms")
    print(report.summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(metrics=metrics,
                           injected=dict(report.injected),
                           survived=dict(report.survived)), f, indent=2)
    print("[resilience-check] PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
