"""Serving scenario on the PyTorch port: an influence-ranking service with
live updates, and a certified top-k read.

Batched queries against a warm ψ-score state; activity/graph updates go
through the engine's O(Δ) delta hooks and re-converge from the previous
fixed point in a handful of iterations. Any registered backend serves; the
run ends with a ``top_k_certified`` read from a ``push`` service, whose set
is provably the exact top-k:

    PYTHONPATH=src python examples/torch_influence_service.py \
        [reference|cuda|auto|push] [--device cpu]

``--device cuda`` (the default) needs a card.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import PsiService, heterogeneous  # noqa: E402
from repro_torch.graphs import powerlaw_configuration  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("backend", nargs="?", default="reference")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    g = powerlaw_configuration(30_000, 200_000, seed=1, name="platform")
    act = heterogeneous(g.n, seed=2)
    t0 = time.perf_counter()
    svc = PsiService(g, act, tol=1e-8, backend=args.backend,
                     device=args.device)
    svc.scores()
    print(f"cold start [{svc.backend} on {svc.engine.device}]: "
          f"{time.perf_counter() - t0:.2f}s for n={g.n}, m={g.m} "
          f"({svc.last_iterations()} iterations)")

    # batched ranking queries — first pays the sort, repeats hit the cache
    users = np.random.default_rng(0).integers(0, g.n, 512)
    t0 = time.perf_counter()
    svc.rank_of(users)
    print(f"batched rank query (512 users): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    t0 = time.perf_counter()
    svc.rank_of(users)
    print(f"  …repeated (cached ranking): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    t0 = time.perf_counter()
    svc.scores_batch(users)
    print(f"  …scores_batch (no sort): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    top, vals = svc.top_k(3)
    print("top-3:", top.tolist(), np.round(vals, 6).tolist())

    # a user goes viral: posting rate ×50 → warm re-converge
    u = int(users[0])
    before = svc.rank_of(np.asarray([u]))[0]
    t0 = time.perf_counter()
    svc.update_activity(np.asarray([u]), lam=np.asarray([act.lam[u] * 50]))
    dt = time.perf_counter() - t0
    after = svc.rank_of(np.asarray([u]))[0]
    print(f"activity update: rank {before} → {after} in {dt:.2f}s "
          f"({svc.last_iterations()} warm iterations)")

    # new follow edges arrive
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    svc.add_edges(rng.integers(0, g.n, 100), np.full(100, u))
    dt = time.perf_counter() - t0
    print(f"+100 followers of user {u}: rank → "
          f"{svc.rank_of(np.asarray([u]))[0]} in {dt:.2f}s "
          f"({svc.last_iterations()} warm iterations)")

    # a certified read: the push backend stops a deferred re-solve as soon
    # as the top-10 set is provably the exact one
    push = PsiService(g, act, tol=1e-8, backend="push", device=args.device)
    push.scores()
    push.update_activity(np.asarray([u]), lam=np.asarray([act.lam[u] * 50]),
                         resolve=False)
    t0 = time.perf_counter()
    cert = push.top_k_certified(10)
    stats = push.engine.last_run_stats
    print(f"certified top-10 [push]: {cert.indices.tolist()} "
          f"certified={cert.certified} (±{cert.err_bound:.2e}) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, touching "
          f"{stats['touched_frac']:.1%} of the users")


if __name__ == "__main__":
    main()
