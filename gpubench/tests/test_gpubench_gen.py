"""The benchmark's input generator: fixed by the seed, sized as stated."""
import numpy as np
import pytest
import torch

from gpubench.gen import kronecker

CPU = torch.device("cpu")
KRON = dict(structure_seed=22, scale=9, edge_factor=16, A=0.57, B=0.19,
            C=0.19, rate_low=1e-3, rate_high=1.0)
BIG_SEED = 2**31 + 11


def _same(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("src", "dst", "lam", "mu"))


def test_kronecker_is_fixed_by_the_seed():
    a = kronecker.generate(KRON, BIG_SEED, CPU)
    assert _same(a, kronecker.generate(KRON, BIG_SEED, CPU))
    assert not _same(a, kronecker.generate(KRON, BIG_SEED + 1, CPU))


def test_kronecker_seeds_relabel_one_graph_with_its_rates():
    a = kronecker.generate(KRON, 5, CPU)
    b = kronecker.generate(KRON, 6, CPU)
    assert a["n"] == b["n"] < 512 and a["sampled"] == 16 * 512
    assert a["src"].numel() == b["src"].numel()

    def profile(g):     # (in-degree, out-degree, λ, μ) of every user
        n = g["n"]
        ind = torch.bincount(g["dst"].long(), minlength=n)
        outd = torch.bincount(g["src"].long(), minlength=n)
        rows = np.stack([ind.numpy(), outd.numpy(), g["lam"].numpy(),
                         g["mu"].numpy()], axis=1)
        return rows[np.lexsort(rows.T[::-1])]

    np.testing.assert_array_equal(profile(a), profile(b))


def test_kronecker_is_undirected_without_loops_duplicates_or_isolates():
    g = kronecker.generate(KRON, 7, CPU)
    n, src, dst = g["n"], g["src"].long(), g["dst"].long()
    assert not torch.any(src == dst)
    key = src * n + dst
    assert torch.equal(key, torch.unique(key))          # sorted, once each
    assert torch.equal(torch.unique(dst * n + src), key)  # every reverse arc
    assert torch.bincount(src, minlength=n).min() > 0   # no isolated user
    assert int(src.max()) < n and g["lam"].numel() == n
    assert 0 < key.numel() <= 2 * g["sampled"]
    assert float(g["lam"].min()) >= 1e-3 and float(g["mu"].max()) <= 1.0


@pytest.mark.parametrize("n,edges,want", [
    (5, [(0, 1), (1, 0), (1, 1), (3, 1), (3, 1)],
     (3, [(0, 1), (1, 0), (1, 2), (2, 1)])),
    (4, [(2, 2)], (0, [])),
])
def test_undirected_arcs_by_hand(n, edges, want):
    u = torch.tensor([a for a, _ in edges], dtype=torch.int64)
    v = torch.tensor([b for _, b in edges], dtype=torch.int64)
    n2, src, dst = kronecker.undirected_arcs(n, u, v)
    assert (n2, list(zip(src.tolist(), dst.tolist()))) == want
