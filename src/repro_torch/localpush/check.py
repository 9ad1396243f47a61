"""Push-backend smoke check — the gate for the local-query claims.

Cold-solves a power-law platform with the push engine, perturbs a small
dirty set, warm-resolves a certified top-k through the maintained handle,
and verifies the three properties the subsystem sells:

1. the certified top-k *set* equals the exact (LU-solve) top-k,
2. the warm push stayed local (touched node fraction below a budget),
3. the certificate upper-bounds the true float64 ψ error.

Exit status 0 on success, 1 with a diagnostic on any violation::

    PYTHONPATH=src python -m repro_torch.localpush.check \
        --n 1500 --m 9000 --dirty-frac 0.01 --k 50 [--device cpu]

The engine runs on ``--device`` (``cuda`` by default, which raises without
a card; ``cpu`` runs the same host float64 push with CPU device tensors).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import exact_psi, heterogeneous, make_engine
from ..core.activity import Activity
from ..graphs import powerlaw_configuration


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--m", type=int, default=9000)
    ap.add_argument("--dirty-frac", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--drift", type=float, default=1.02,
                    help="dirty users' λ multiplier (streaming rate drift; "
                    "the locality claim is about drift-sized deltas, not "
                    "order-of-magnitude shocks)")
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--max-touched-frac", type=float, default=0.20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    g = powerlaw_configuration(args.n, args.m, seed=args.seed)
    act = heterogeneous(g.n, seed=args.seed + 1)
    eng = make_engine("push", graph=g, activity=act, device=args.device)
    cold = eng.run(tol=args.tol)

    rng = np.random.default_rng(args.seed + 2)
    dirty = rng.choice(g.n, size=max(1, int(args.dirty_frac * g.n)),
                       replace=False)
    eng.patch_activity(dirty, lam=act.lam[dirty] * args.drift)
    _, cert = eng.run_top_k(args.k, tol=args.tol, s0=cold.s)
    stats = eng.last_run_stats

    lam2 = act.lam.copy()
    lam2[dirty] = act.lam[dirty] * args.drift
    psi_true, _ = exact_psi(g, Activity(lam2, act.mu))
    exact_top = set(np.argsort(-psi_true, kind="stable")[:args.k].tolist())
    true_err = float(np.abs(eng.last_psi_host - psi_true).max())
    bound = eng.psi_error_bound()

    failures = []
    if not cert.certified:
        failures.append("top-k certificate did not close "
                        f"(margin={cert.margin:.3e}, bound={cert.err_bound})")
    if set(cert.indices.tolist()) != exact_top:
        failures.append("certified top-k set != exact top-k")
    if stats["touched_frac"] >= args.max_touched_frac:
        failures.append(f"push touched {stats['touched_frac']:.1%} of nodes "
                        f"(budget {args.max_touched_frac:.0%})")
    if bound is None or true_err > bound:
        failures.append(f"certificate {bound} < true f64 error {true_err:.3e}")

    print(f"push smoke: n={g.n} m={g.m} dirty={dirty.size} k={args.k} | "
          f"rounds={stats['rounds']} edge_work={stats['edge_work']} "
          f"touched={stats['touched_frac']:.1%} | "
          f"true_err={true_err:.3e} <= cert={bound if bound is None else f'{bound:.3e}'} | "
          f"certified={cert.certified}")
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
