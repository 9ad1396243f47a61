"""The fleet part of ``chip_smoke.py``'s ``stream`` phase, run through the
JAX package on the host: how many lane solves of an f32 fleet fed a live
stream run to ``max_iter`` in the reference implementation.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/stream_fleet_reference.py

Four dblp stand-ins (``load_dataset("dblp", seed=s)``, s = 1…4) admitted
cold (every rate at ``RATE_FLOOR``) to ``TenantFleet(backend="auto",
tol=1e-8)`` at float32 (on the host ``auto`` runs them in the ``reference``
regime), one ``burst_stream`` a tenant (truth ``heterogeneous(n,
seed=200 + k)``, ~20,000 events, 16 users ×10, seed 300 + k), interleaved,
ingested with a fleet resolve every 2,000 events — the events, seeds and
policy of the port's ``stream_fleet``. Prints each tenant's per-resolve
iteration counts (from the convergence tracker) and how many reached
``max_iter``. Takes about a minute.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro import obs  # noqa: E402
from repro.core import Activity, heterogeneous  # noqa: E402
from repro.core.activity import RATE_FLOOR  # noqa: E402
from repro.graphs import load_dataset  # noqa: E402
from repro.serving import TenantFleet  # noqa: E402
from repro.stream import (FreshnessPolicy, StreamIngestor,  # noqa: E402
                          burst_stream, tenant_interleave)


def main() -> None:
    obs.configure(tracker=obs.ConvergenceTracker(keep=4096))
    fleet = TenantFleet(backend="auto", tol=1e-8)
    sources, horizons = {}, []
    for k, seed in enumerate((1, 2, 3, 4)):
        tid = f"dblp-{seed}"
        g = load_dataset("dblp", seed=seed)
        truth = heterogeneous(g.n, seed=200 + k)
        horizon = 20_000 / float(truth.total.sum())
        rng = np.random.default_rng(300 + k)
        sources[tid] = burst_stream(truth, horizon, seed=300 + k,
                                    burst_users=rng.integers(0, g.n, 16),
                                    burst_factor=10.0)
        horizons.append(horizon)
        fleet.admit(tid, g, Activity(np.full(g.n, RATE_FLOOR),
                                     np.full(g.n, RATE_FLOOR)))
    log = tenant_interleave(sources)
    ing = StreamIngestor(fleet, half_life=max(horizons) / 2, topk=10,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=2000))
    t0 = time.perf_counter()
    rep = ing.ingest(log)
    iters = {tid: [r.iterations for r in
                   obs.convergence.get_tracker().series(tid)]
             for tid in sources}
    capped = sum(i >= fleet.max_iter for v in iters.values() for i in v)
    print(f"{len(log)} events, {rep.resolves} fleet resolves in "
          f"{time.perf_counter() - t0:.1f} s (host); regimes "
          f"{ {str(s): a['regime'] for s, a in fleet.occupancy().items()} }")
    for tid, v in iters.items():
        print(f"{tid}: {v}")
    print(f"{capped} of {sum(map(len, iters.values()))} lane solves ran to "
          f"max_iter={fleet.max_iter}")


if __name__ == "__main__":
    main()
