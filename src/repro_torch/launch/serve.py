"""Serving launcher: batched ψ-score queries on one graph or a fleet.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --backend auto --microbench --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch psi-score \
        --tenants 4 --device cpu

The single-tenant loop of the JAX package's launcher, on the same graph and
seeds, printing the same lines: a cold solve, the top-k, ``--requests``
batches of ``rank_of`` + ``scores_batch``, and a live activity update
mid-traffic. ``--backend auto`` lets the autotuner pick the kernel regime
(``--microbench`` times every candidate instead of trusting the cost
model) and prints the plan; ``--accelerate`` wraps any backend's step in
the Aitken-extrapolated loop. ``--device cuda`` (the default) needs a card;
``--device cpu`` runs the plain PyTorch versions of the kernels.

``--tenants K`` (K > 1) serves K independent tenants from one
:class:`~repro_torch.serving.TenantFleet` instead — the JAX launcher's fleet
path, with its tenants and seeds: the request loop goes round-robin across
the tenants, one tenant gets a live activity update mid-traffic, and the run
ends with the fleet-wide top-k. ``--backend`` then names a fleet regime
(``auto`` by default; on a card ``auto`` runs the lane-batched CUDA kernels
for the buckets above ``dense_max_n``); ``--bucket-sizes`` sets the node
rungs of the bucket policy.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=("psi-score",),
                    help="model family; this package serves psi-score")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--backend", default=None,
                    help="ψ solver backend: reference (default) | cuda "
                         "(alias pallas) | auto | accelerated; with "
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
    args = ap.parse_args(argv)
    if args.tenants > 1:
        _serve_fleet(args)
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
