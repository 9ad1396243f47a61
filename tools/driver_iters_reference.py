"""The iteration counts of the fault-tolerant driver path, computed by the
JAX package at float64 on the host: the reference list that
``chip_smoke.py``'s ``driver`` phase holds the port's card run to
(``DRIVER_ITERS``).

    PYTHONPATH=src python tools/driver_iters_reference.py

The twitter stand-in ``load_dataset("twitter")`` (Table II's size) with
``heterogeneous(n, seed=6)``, tol 1e-9 on the drivers' raw l1 gap. Prints
one JSON list:

* the bulk-synchronous ``PsiDriver`` over ``DistributedPsi`` on a
  ``(1, 1)`` mesh, 16 iterations a chunk: iterations, chunks;
* the ``AsyncPsiDriver`` with 4 chunks at τ = 0 (the bulk-synchronous
  schedule): epochs, chunk steps, verification sweeps.
"""
import json
import os
import sys

import jax

jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax.numpy as jnp  # noqa: E402

from repro.asyncexec import AsyncPsiDriver  # noqa: E402
from repro.core import heterogeneous  # noqa: E402
from repro.core.distributed import DistributedPsi  # noqa: E402
from repro.graphs import load_dataset  # noqa: E402
from repro.runtime import PsiDriver  # noqa: E402

TOL = 1e-9


def main() -> None:
    g = load_dataset("twitter")
    act = heterogeneous(g.n, seed=6)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         devices=jax.devices()[:1])
    sync = PsiDriver(DistributedPsi.from_graph(g, act, mesh,
                                               dtype=jnp.float64),
                     chunk_iters=16).run(tol=TOL)
    asy = AsyncPsiDriver(g, act, num_chunks=4, tau=0,
                         dtype=jnp.float64).run(tol=TOL)
    print(json.dumps([sync.iterations, sync.chunks, asy.iterations,
                      asy.chunks, asy.sync_sweeps]))


if __name__ == "__main__":
    main()
