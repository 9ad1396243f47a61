"""Quickstart on the PyTorch port: ψ-scores four ways, compared.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Exact ψ (sparse LU on the host), the paper's Power-ψ (Alg. 2), the Power-NF
baseline (Alg. 1, N systems) on 64 origins, and PageRank, which equals ψ
under homogeneous activity. ``--device cuda`` (the default) needs a card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (build_operators, build_pagerank_ops,  # noqa: E402
                              exact_psi, heterogeneous, homogeneous,
                              pagerank, power_nf, power_psi)
from repro_torch.graphs import powerlaw_configuration  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    # a small social platform: 2 000 users, heavy-tailed follows
    g = powerlaw_configuration(2000, 14000, seed=42, name="demo")
    act = heterogeneous(g.n, seed=7)     # per-user posting/re-posting rates
    ops = build_operators(g, act, device=dev)

    # 1. the paper's Power-ψ (Alg. 2): one linear system, power iteration
    res = power_psi(ops, tol=1e-9)
    print(f"Power-ψ:   {res.iterations} iterations, {res.matvecs} mat-vecs "
          f"on {ops.device}")
    psi = res.psi.cpu().numpy()

    # 2. exact solve (the oracle)
    psi_true, _ = exact_psi(g, act)
    err = np.linalg.norm(psi - psi_true) / np.linalg.norm(psi_true)
    print(f"            rel. error vs exact: {err:.2e}")

    # 3. the pre-paper baseline (Alg. 1: N systems) on a few origins
    nf = power_nf(ops, tol=1e-9, origins=np.arange(64))
    print(f"Power-NF:  {nf.matvecs} mat-vecs for just 64 of {g.n} users "
          f"(×{g.n // 64} more to finish) — the problem the paper fixes")

    # 4. homogeneous activity ⇒ ψ == PageRank (Thm 5 of [10])
    ops_h = build_operators(g, homogeneous(g.n), device=dev)
    psi_h = power_psi(ops_h, tol=1e-12).psi.cpu().numpy()
    pr = pagerank(build_pagerank_ops(g, device=dev), alpha=0.85,
                  tol=1e-12).pi.cpu().numpy()
    print(f"ψ(homog) vs PageRank max diff: {float(abs(psi_h - pr).max()):.2e}")

    top = np.argsort(-psi)[:5]
    print("top-5 influencers:", top.tolist())
    print("  ψ:", np.round(psi[top], 6).tolist())
    print("  in-degree:", g.in_degree[top].tolist(),
          " (rank ≠ pure popularity — activity matters)")


if __name__ == "__main__":
    main()
