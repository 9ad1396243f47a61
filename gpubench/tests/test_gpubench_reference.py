"""The plain reference and the comparison's numbers."""
import numpy as np
import pytest
import torch

from gpubench.compare import judge, rel_max, top_rel
from gpubench.reference.psi import psi_reference


def _graph(n=60, m=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    key = np.unique(src[keep] * n + dst[keep])
    src, dst = key // n, key % n
    src = src[src < n - 5]            # the last users lead nobody
    dst = dst[: src.size]
    lam = rng.uniform(1e-3, 1.0, n)
    mu = rng.uniform(1e-3, 1.0, n)
    return n, src, dst, lam, mu


def _dense_psi(n, src, dst, lam, mu):
    """ψ from the paper's matrices by a dense linear solve."""
    total = lam + mu
    w = np.zeros(n)
    np.add.at(w, src, total[dst])
    inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    A[src, dst] = mu[dst] * inv_w[src]
    B[src, dst] = lam[dst] * inv_w[src]
    c, d = mu / total, lam / total
    s = np.linalg.solve((np.eye(n) - A).T, c)      # sᵀ = cᵀ (I − A)⁻¹
    return (B.T @ s + d) / n


def _run(n, src, dst, lam, mu, inv_n=None, **kw):
    t = torch.as_tensor
    inv_n = torch.full((n,), 1.0 / n, dtype=torch.float64) \
        if inv_n is None else inv_n
    psi, it = psi_reference(t(src), t(dst), t(lam), t(mu), inv_n, **kw)
    return psi.double().numpy(), it


def test_reference_agrees_with_a_dense_solve():
    g = _graph()
    psi, it = _run(*g)
    assert 0 < it < 3000
    np.testing.assert_allclose(psi, _dense_psi(*g), rtol=1e-12, atol=0)


def test_a_union_of_graphs_solves_each_alone():
    a, b = _graph(seed=1), _graph(n=40, m=200, seed=2)
    n = a[0] + b[0]
    cat = [np.concatenate([x, y + (a[0] if i < 2 else 0)])
           for i, (x, y) in enumerate(zip(a[1:], b[1:]))]
    inv_n = torch.cat([torch.full((a[0],), 1.0 / a[0], dtype=torch.float64),
                       torch.full((b[0],), 1.0 / b[0], dtype=torch.float64)])
    psi, _ = _run(n, *cat, inv_n=inv_n)
    np.testing.assert_allclose(psi[:a[0]], _dense_psi(*a), rtol=1e-12)
    np.testing.assert_allclose(psi[a[0]:], _dense_psi(*b), rtol=1e-12)


@pytest.mark.parametrize("storage,accumulate,floor", [
    (torch.bfloat16, torch.float32, 1e-4),
    (torch.float32, torch.float32, 1e-9)])
def test_a_lower_precision_reads_worse(storage, accumulate, floor):
    g = _graph(n=200, m=2000, seed=3)
    psi, _ = _run(*g, storage=storage, accumulate=accumulate, max_iter=300)
    assert rel_max(psi, _dense_psi(*g)) > floor


def test_rel_max_reads_shape_and_nan_as_inf():
    ref = np.array([1.0, 2.0, 4.0])
    assert rel_max(ref, ref) == 0.0
    assert rel_max([1.0, 2.0, 4.4], ref) == pytest.approx(0.1)
    assert rel_max([1.0, 2.0], ref) == float("inf")
    assert rel_max([1.0, np.nan, 4.0], ref) == float("inf")


def test_top_rel_reads_members_order_and_values():
    ref = np.array([5.0, 1.0, 4.0, 3.0, 2.0])
    assert top_rel([0, 2, 3], [5.0, 4.0, 3.0], 3, ref) == 0.0
    assert top_rel([0, 2, 4], [5.0, 4.0, 2.0], 3, ref) == pytest.approx(1 / 3)
    assert top_rel([2, 0, 3], [4.0, 5.0, 3.0], 3, ref) == pytest.approx(0.25)
    assert top_rel([0, 2, 3], [5.0, 4.0, 3.3], 3, ref) == pytest.approx(0.1)
    assert top_rel([0, 0, 3], [5.0, 5.0, 3.0], 3, ref) == float("inf")
    assert top_rel([0, 2], [5.0, 4.0], 3, ref) == float("inf")
    assert top_rel([0, 2, 9], [5.0, 4.0, 3.0], 3, ref) == float("inf")


def test_judge_needs_a_limit_for_every_number():
    ok, check = judge({"a": 1e-7, "b": 2e-3}, {"a": 1e-6, "b": 1e-3})
    assert not ok and list(check) == ["a", "b"]
    assert check["a"] == {"value": 1e-7, "limit": 1e-6}
    assert judge({"a": float("nan")}, {"a": 1.0})[0] is False
    with pytest.raises(KeyError):
        judge({"c": 0.0}, {"a": 1.0})
