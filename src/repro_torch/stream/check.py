"""Streaming replay check: the smoke test of the ingestion subsystem.

Two stages over fixed seeded logs (deterministic → the thresholds are
asserted against known-good values, not statistical hopes):

1. **Rate recovery** — a ~2k-event stationary Poisson log over a small,
   highly-active user set (per-rate accuracy is information-limited at
   1/√(events per rate), so the smoke concentrates events on few users);
   asserts the l1-aggregate relative error of (λ̂, μ̂) vs ground truth is
   within ``--rate-tol`` (default 5%).
2. **ψ-parity + throughput** — a flash-crowd log (posts + follows +
   unfollow churn) ingested through a float64 ``PsiService`` under the
   freshness policy; asserts the streamed ψ after the final resolve
   matches a from-scratch batch solve on the final (graph,
   estimated-activity) state within ``--psi-tol`` (default 1e-6), and
   prints sustained events/s.

Exit code 0 iff both stages pass:

    PYTHONPATH=src python -m repro_torch.stream.check --events 2000

The JAX package's ``repro.stream.check`` on the port: the same logs, seeds,
thresholds and ``reference`` engine, at float64. ``--device cuda`` (the
default) needs a card; ``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def rate_recovery(events: int, seed: int, half_life_factor: float) -> dict:
    from ..core.activity import Activity
    from . import RateEstimator, poisson_stream

    rng = np.random.default_rng(seed)
    n = 4
    truth = Activity(rng.uniform(0.3, 1.0, n), rng.uniform(0.3, 1.0, n))
    horizon = events / float(truth.total.sum())
    log = poisson_stream(truth, horizon, seed=seed + 1)
    est = RateEstimator(n, half_life=half_life_factor * horizon)
    for ev in log:
        est.observe(ev)
    lam, mu = est.rates(horizon)
    err = (np.abs(lam - truth.lam).sum() + np.abs(mu - truth.mu).sum()) \
        / float(truth.total.sum())
    return dict(events=len(log), n=n, horizon=horizon, rate_err=float(err))


def psi_parity(events: int, seed: int, resolve_every: int, *,
               device: str = "cuda") -> dict:
    import torch

    from ..core import Activity, heterogeneous, make_engine
    from ..core.activity import RATE_FLOOR
    from ..core.incremental import PsiService
    from ..graphs import powerlaw_configuration
    from . import FreshnessPolicy, StreamIngestor, flash_crowd_stream

    n, m = 512, 3_000
    g = powerlaw_configuration(n, m, seed=seed)
    truth = heterogeneous(n, seed=seed + 1)
    horizon = events / float(truth.total.sum())
    log = flash_crowd_stream(g, truth, horizon, new_followers=48,
                             churn=0.3, seed=seed + 2)
    cold = Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))
    svc = PsiService(g, cold, tol=1e-9, dtype=torch.float64, device=device)
    ing = StreamIngestor(svc, half_life=horizon / 2,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=resolve_every))
    t0 = time.perf_counter()
    rep = ing.ingest(log)
    wall = time.perf_counter() - t0
    # from-scratch batch oracle on the final (graph, estimated-activity)
    batch = make_engine("reference", graph=svc.graph,
                        activity=svc.engine.activity, dtype=torch.float64,
                        device=device).run(tol=1e-9)
    psi_err = float(np.abs(svc.scores()
                           - batch.psi.cpu().numpy()).max())
    return dict(events=len(log), n=n, m_final=svc.graph.m, wall_s=wall,
                events_per_s=len(log) / wall, resolves=rep.resolves,
                psi_err=psi_err, device=str(svc.engine.device),
                topk_churn=max(ing.churn_history, default=0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=2_000)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--rate-tol", type=float, default=0.05)
    ap.add_argument("--psi-tol", type=float, default=1e-6)
    ap.add_argument("--resolve-every", type=int, default=500)
    ap.add_argument("--half-life-factor", type=float, default=2.0,
                    help="estimator half-life as a multiple of the horizon")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    ok = True
    r = rate_recovery(args.events, args.seed, args.half_life_factor)
    good = r["rate_err"] <= args.rate_tol
    ok &= good
    print(f"[stream-check] rate recovery: {r['events']} events over "
          f"{r['n']} users, l1 rel err={r['rate_err']:.4f} "
          f"(tol {args.rate_tol}) {'OK' if good else 'FAIL'}")

    p = psi_parity(args.events, args.seed, args.resolve_every,
                   device=args.device)
    good = p["psi_err"] <= args.psi_tol
    ok &= good
    print(f"[stream-check] psi parity: {p['events']} events on n={p['n']} "
          f"(m_final={p['m_final']}), {p['resolves']} resolves, "
          f"{p['events_per_s']:.0f} ev/s on {p['device']}, "
          f"topk_churn={p['topk_churn']:.2f}, "
          f"psi_err={p['psi_err']:.2e} (tol {args.psi_tol:.0e}) "
          f"{'OK' if good else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
