"""The mat-vec and iteration counts of the paper's comparison path, computed
by the JAX package at float64 on the host: the reference list that
``chip_smoke.py``'s ``paper`` phase holds the port's card run to
(``PAPER_ITERS``).

    PYTHONPATH=src python tools/paper_iters_reference.py

The DBLP stand-in ``load_dataset("dblp")`` (Table II's size), the setup of
``benchmarks/exp2_matvecs.py``: tols 1e-1 … 1e-9, Power-NF over 256 origins
(``np.random.default_rng(1)``, sorted) in chunks of 256. Prints one JSON
list in this order:

* for each tol, heterogeneous activity (``heterogeneous(n, seed=7)``):
  Power-ψ mat-vecs, Power-NF mat-vecs and Power-NF's worst per-origin
  iteration count over the 256 origins;
* for each tol, homogeneous activity (λ = 0.15, μ = 0.85): Power-ψ mat-vecs
  and PageRank (α = 0.85) mat-vecs;
* Power-NF over all origins at tol 1e-9: mat-vecs and worst iterations.
"""
import json
import os
import sys

import jax

jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (build_operators, build_pagerank_ops,  # noqa: E402
                        heterogeneous, homogeneous, pagerank, power_nf,
                        power_psi)
from repro.graphs import load_dataset  # noqa: E402

TOLS = [10.0 ** -k for k in range(1, 10)]
NF_ORIGINS = 256


def main() -> None:
    g = load_dataset("dblp")
    origins = np.sort(np.random.default_rng(1).choice(g.n, NF_ORIGINS,
                                                      replace=False))
    ops = build_operators(g, heterogeneous(g.n, seed=7), dtype=jnp.float64)
    hom = build_operators(g, homogeneous(g.n, lam=0.15, mu=0.85),
                          dtype=jnp.float64)
    pro = build_pagerank_ops(g, dtype=jnp.float64)
    counts = []
    for tol in TOLS:
        nf = power_nf(ops, tol=tol, chunk=256, origins=origins)
        counts += [int(power_psi(ops, tol=tol).matvecs), nf.matvecs,
                   nf.max_iterations]
    for tol in TOLS:
        counts += [int(power_psi(hom, tol=tol).matvecs),
                   int(pagerank(pro, alpha=0.85, tol=tol).matvecs)]
    nf_all = power_nf(ops, tol=TOLS[-1], chunk=256)
    counts += [nf_all.matvecs, nf_all.max_iterations]
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
