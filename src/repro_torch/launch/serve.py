"""Serving launcher: batched ψ-score queries on one graph.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --backend auto --microbench --requests 4

The single-tenant loop of the JAX package's launcher, on the same graph and
seeds, printing the same lines: a cold solve, the top-k, ``--requests``
batches of ``rank_of`` + ``scores_batch``, and a live activity update
mid-traffic. ``--backend auto`` lets the autotuner pick the kernel regime
(``--microbench`` times every candidate instead of trusting the cost
model) and prints the plan; ``--accelerate`` wraps any backend's step in
the Aitken-extrapolated loop. ``--device cuda`` (the default) needs a card;
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=("psi-score",),
                    help="model family; this package serves psi-score")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--backend", default="reference",
                    help="ψ solver backend: reference | cuda (alias pallas) "
                         "| auto | accelerated")
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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    main()
