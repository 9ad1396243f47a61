"""Streaming scenario on the PyTorch port: a flash crowd, watched live
through fresh ψ.

The platform starts *cold* — nobody's posting rates are known (everyone at
the RATE_FLOOR clamp) — and a live event log plays: stationary background
posts/reposts teach the online estimator every user's λ/μ, then a flash
crowd forms around one mid-pack user (new followers + a repost storm), and
a fraction of the crowd churns away afterwards (unfollow tombstones). The
``StreamIngestor`` coalesces all of it into batched O(Δ) patches and
re-resolves ψ at a fixed event cadence, so we can watch the user's
influence rank climb *while the stream is still running* — and certify
exactly how stale every answer was:

    PYTHONPATH=src python examples/torch_influence_stream.py \
        [reference|cuda|auto] [--quick] [--device cpu]

The JAX package's ``examples/influence_stream.py`` on the port, with its
graph, seeds and checks (float64). ``--device cuda`` (the default) needs a
card; the ``cuda`` backend then solves every resolve with ``power_step``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (RATE_FLOOR, Activity, PsiService,  # noqa: E402
                              heterogeneous, make_engine)
from repro_torch.graphs import powerlaw_configuration  # noqa: E402
from repro_torch.stream import (FreshnessPolicy, StreamIngestor,  # noqa: E402
                                flash_crowd_stream)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("backend", nargs="?", default="reference")
    ap.add_argument("--quick", action="store_true",
                    help="a 400-user graph and 1,500 events")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    n, m, events = ((400, 2_400, 1_500) if args.quick
                    else (2_000, 12_000, 6_000))
    g = powerlaw_configuration(n, m, seed=11)
    truth = heterogeneous(n, seed=12)
    horizon = events / float(truth.total.sum())
    celebrity = int(np.argsort(-g.in_degree)[8])   # mid-pack: room to climb
    log = flash_crowd_stream(g, truth, horizon, celebrity=celebrity,
                             new_followers=max(24, n // 16), storm_mu=6.0,
                             churn=0.4, seed=13)
    print(f"flash crowd around user {celebrity}: {len(log)} events "
          f"({log.counts()}) over {horizon:.1f}s event-time")

    cold = Activity(np.full(n, RATE_FLOOR), np.full(n, RATE_FLOOR))
    svc = PsiService(g, cold, tol=1e-9, backend=args.backend,
                     dtype=torch.float64, device=args.device)
    ing = StreamIngestor(
        svc, half_life=horizon / 2, topk=10,
        policy=FreshnessPolicy(coalesce=64, resolve_every=None))

    # drive the stream manually so we can snapshot the celebrity's rank at
    # every resolve (a fixed event cadence, like the serving launcher's)
    resolve_every = max(200, len(log) // 8)
    t0 = time.perf_counter()
    trajectory = []
    for i, ev in enumerate(log):
        ing.submit(ev)
        if (i + 1) % resolve_every == 0:
            ing.resolve()
            rank = int(svc.rank_of(np.asarray([celebrity]))[0])
            rep = ing.freshness()
            trajectory.append((i + 1, rank))
            churn = (None if rep.topk_churn is None
                     else round(rep.topk_churn, 2))
            print(f"  event {i + 1:5d} (t={rep.event_time:6.1f}s): "
                  f"celebrity rank {rank:4d}, churn={churn}")
    ing.resolve()
    wall = time.perf_counter() - t0
    final_rank = int(svc.rank_of(np.asarray([celebrity]))[0])
    print(f"\ningested {len(log)} events in {wall:.2f}s "
          f"({len(log) / wall:.0f} ev/s) over {ing.resolves} resolves on "
          f"{svc.engine.device}; celebrity rank {trajectory[0][1]} → "
          f"{final_rank}")
    if not final_rank < trajectory[0][1]:
        raise SystemExit("the flash crowd should lift the celebrity's rank")

    # freshness certification: a stale read vs a certified-fresh read
    tail = ing.freshness()
    print(f"freshness at end: staleness={tail.staleness_events} events, "
          f"dirty_mass={tail.dirty_mass:.2e}, "
          f"certified fresh={tail.certify(max_events=0)}")

    # the acceptance invariant: replay + O(Δ) patches == batch recompute
    batch = make_engine("reference", graph=svc.graph,
                        activity=svc.engine.activity, dtype=torch.float64,
                        device=args.device).run(tol=1e-9)
    err = float(np.abs(svc.scores() - batch.psi.cpu().numpy()).max())
    print(f"psi parity vs from-scratch batch solve: {err:.2e}")
    if err > 1e-8:
        raise SystemExit(f"streamed psi diverged from batch: {err}")
    return final_rank, trajectory, err


if __name__ == "__main__":
    main()
