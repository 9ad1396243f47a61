"""The paper's comparison path in the port against the JAX package: the
exact oracle, the Power-NF pieces of the operators, PageRank and Power-NF.

Same seeded inputs through both packages in one process; JAX runs at
float64 inside ``_x64()``. The port runs with ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.convert import operators_from_numpy


def _x64():
    """JAX's float64 switch as a context manager, across jax versions."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


GRAPHS = {
    "erdos_renyi": lambda pkg: pkg.erdos_renyi(300, 2100, seed=3),
    "powerlaw": lambda pkg: pkg.powerlaw_configuration(400, 2600, seed=5),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    """(port graph, JAX graph, port activity, JAX activity) on one seed."""
    make = GRAPHS[request.param]
    g_t, g_j = make(tg), make(jg)
    return g_t, g_j, tc.heterogeneous(g_t.n, seed=5), \
        jc.heterogeneous(g_j.n, seed=5)


def _ops(pair):
    g_t, g_j, a_t, a_j = pair
    ops_t = tc.build_operators(g_t, a_t, dtype=torch.float64, device="cpu")
    ops_j = jc.build_operators(g_j, a_j, dtype=jnp.float64)
    return ops_t, ops_j


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_exact_psi_bitwise_equal_to_jax(pair):
    g_t, g_j, a_t, a_j = pair
    psi_t, s_t = tc.exact_psi(g_t, a_t)
    psi_j, s_j = jc.exact_psi(g_j, a_j)
    assert psi_t.dtype == np.float64
    np.testing.assert_array_equal(psi_t, psi_j)
    np.testing.assert_array_equal(s_t, s_j)


def test_operators_carry_the_src_sorted_view(pair):
    with _x64():
        ops_t, ops_j = _ops(pair)
        for f in ("src_by_src", "dst_by_src"):
            np.testing.assert_array_equal(getattr(ops_t, f).numpy(),
                                          np.asarray(getattr(ops_j, f)))
    np.testing.assert_array_equal(ops_t.out_degree.numpy(),
                                  pair[0].out_degree)


@pytest.mark.parametrize("k", [None, 1, 7])
def test_right_matvec_matches_jax_f64(pair, k):
    shape = (pair[0].n,) if k is None else (pair[0].n, k)
    p = np.random.default_rng(0).uniform(size=shape)
    with _x64():
        ops_t, ops_j = _ops(pair)
        want = np.asarray(ops_j.right_matvec(jnp.asarray(p)))
    got = ops_t.right_matvec(torch.as_tensor(p)).numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("origins", [[0], [3, 17, 99, 250], "all"])
def test_b_columns_matches_jax_f64(pair, origins):
    origins = (np.arange(pair[0].n) if origins == "all"
               else np.asarray(origins))
    with _x64():
        ops_t, ops_j = _ops(pair)
        want = np.asarray(ops_j.b_columns(jnp.asarray(origins)))
    got = ops_t.b_columns(torch.as_tensor(origins)).numpy()
    assert got.shape == (pair[0].n, origins.size)
    assert _rel(got, want) <= 1e-12


def test_right_matvec_and_b_columns_match_dense(pair):
    g_t, _, a_t, _ = pair
    ops_t = tc.build_operators(g_t, a_t, dtype=torch.float64, device="cpu")
    A, B, _, _ = tc.dense_operators(g_t, a_t)
    p = np.random.default_rng(1).uniform(size=(g_t.n, 3))
    np.testing.assert_allclose(ops_t.right_matvec(torch.as_tensor(p)).numpy(),
                               A @ p, rtol=1e-12, atol=1e-15)
    origins = np.asarray([2, 40, 41])
    np.testing.assert_allclose(
        ops_t.b_columns(torch.as_tensor(origins)).numpy(), B[:, origins],
        rtol=1e-12, atol=1e-15)


def test_operators_from_numpy_carries_the_src_view(pair):
    with _x64():
        ops_t, ops_j = _ops(pair)
        fields = {k: np.asarray(getattr(ops_j, k)) for k in (
            "n", "m", "src_by_dst", "dst_by_dst", "src_by_src", "dst_by_src",
            "lam", "mu", "inv_w", "c", "d", "b_norm")}
    ops_c = operators_from_numpy(fields, device="cpu")
    p = torch.as_tensor(np.random.default_rng(2).uniform(size=(ops_c.n, 2)))
    assert torch.equal(ops_c.right_matvec(p), ops_t.right_matvec(p))


@pytest.mark.parametrize("tol", [1e-6, 1e-9, 1e-12])
def test_pagerank_matches_jax_f64(pair, tol):
    g_t, g_j, _, _ = pair
    with _x64():
        pr_j = jc.pagerank(jc.build_pagerank_ops(g_j, dtype=jnp.float64),
                           alpha=0.85, tol=tol)
        it_j, pi_j = int(pr_j.iterations), np.asarray(pr_j.pi)
    pr_t = tc.pagerank(tc.build_pagerank_ops(g_t, dtype=torch.float64,
                                             device="cpu"),
                       alpha=0.85, tol=tol)
    assert pr_t.iterations == it_j and pr_t.matvecs == it_j
    assert pr_t.converged and pr_t.gap <= tol
    assert np.abs(pr_t.pi.numpy() - pi_j).max() <= 1e-12


@pytest.mark.parametrize("tol", [1e-4, 1e-10])
@pytest.mark.parametrize("subset", [False, True])
def test_power_nf_matches_jax_f64(pair, tol, subset):
    origins = (np.sort(np.random.default_rng(1).choice(pair[0].n, 70,
                                                       replace=False))
               if subset else None)
    with _x64():
        ops_t, ops_j = _ops(pair)
        nf_j = jc.power_nf(ops_j, tol=tol, chunk=64, origins=origins)
    nf_t = tc.power_nf(ops_t, tol=tol, chunk=64, origins=origins)
    assert nf_t.matvecs == nf_j.matvecs
    assert nf_t.max_iterations == nf_j.max_iterations
    assert nf_t.psi.dtype == np.float64
    assert _rel(nf_t.psi, nf_j.psi) <= 1e-10


def test_power_nf_matches_exact_and_costs_more(pair):
    """Alg. 1 reaches the same answer with orders more mat-vecs (Fig. 4)."""
    g_t, _, a_t, _ = pair
    ops_t = tc.build_operators(g_t, a_t, dtype=torch.float64, device="cpu")
    nf = tc.power_nf(ops_t, tol=1e-10, chunk=64)
    psi_true, _ = tc.exact_psi(g_t, a_t)
    assert np.linalg.norm(nf.psi - psi_true) / np.linalg.norm(psi_true) < 1e-8
    ps = tc.power_psi(ops_t, tol=1e-10)
    assert nf.matvecs > 50 * ps.matvecs


def test_homogeneous_psi_equals_pagerank(pair):
    """[10, Thm 5]: ψ(λ, μ const) == PageRank(α = μ/(λ+μ))."""
    g_t = pair[0]
    ops = tc.build_operators(g_t, tc.homogeneous(g_t.n, lam=0.15, mu=0.85),
                             dtype=torch.float64, device="cpu")
    res = tc.power_psi(ops, tol=1e-12)
    pr = tc.pagerank(tc.build_pagerank_ops(g_t, dtype=torch.float64,
                                           device="cpu"),
                     alpha=0.85, tol=1e-12)
    assert np.abs(res.psi.numpy() - pr.pi.numpy()).max() < 1e-6


def test_paper_comparison_slice_matches_jax():
    """The slice end to end at a small size, as the card's ``paper`` phase
    runs it: exact ψ, the ``cuda`` engine (its kernel's plain version here),
    Power-NF over all origins and a sampled subset, and PageRank in the
    homogeneous regime; every count equal to the JAX package's."""
    g_t = tg.powerlaw_configuration(600, 3000, seed=11)
    g_j = jg.powerlaw_configuration(600, 3000, seed=11)
    origins = np.sort(np.random.default_rng(1).choice(g_t.n, 64,
                                                      replace=False))
    psi_true, _ = tc.exact_psi(g_t, tc.heterogeneous(g_t.n, seed=7))
    counts_t, counts_j = [], []
    with _x64():
        ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=7),
                                   dtype=jnp.float64)
        hom_j = jc.build_operators(g_j, jc.homogeneous(g_j.n, lam=0.15, mu=0.85),
                                   dtype=jnp.float64)
        pro_j = jc.build_pagerank_ops(g_j, dtype=jnp.float64)
        for tol in (1e-3, 1e-6, 1e-9):
            nf = jc.power_nf(ops_j, tol=tol, chunk=32, origins=origins)
            counts_j += [int(jc.power_psi(ops_j, tol=tol).matvecs),
                         nf.matvecs, nf.max_iterations,
                         int(jc.power_psi(hom_j, tol=tol).matvecs),
                         int(jc.pagerank(pro_j, alpha=0.85,
                                         tol=tol).matvecs)]
        nf_all_j = jc.power_nf(ops_j, tol=1e-9, chunk=256)
        counts_j += [nf_all_j.matvecs, nf_all_j.max_iterations]
    kw = dict(dtype=torch.float64, device="cpu")
    ops_t = tc.build_operators(g_t, tc.heterogeneous(g_t.n, seed=7), **kw)
    hom_act = tc.homogeneous(g_t.n, lam=0.15, mu=0.85)
    pro_t = tc.build_pagerank_ops(g_t, **kw)
    eng = tc.make_engine("cuda", graph=g_t,
                         activity=tc.heterogeneous(g_t.n, seed=7), **kw)
    hom_eng = tc.make_engine("cuda", graph=g_t, activity=hom_act, **kw)
    for tol in (1e-3, 1e-6, 1e-9):
        nf = tc.power_nf(ops_t, tol=tol, chunk=32, origins=origins)
        res = eng.run(tol=tol)
        hom = hom_eng.run(tol=tol)
        pr = tc.pagerank(pro_t, alpha=0.85, tol=tol)
        counts_t += [res.matvecs, nf.matvecs, nf.max_iterations,
                     hom.matvecs, pr.matvecs]
    nf_all = tc.power_nf(ops_t, tol=1e-9, chunk=256)
    counts_t += [nf_all.matvecs, nf_all.max_iterations]
    assert counts_t == counts_j
    for psi in (nf_all.psi, res.psi.numpy()):
        assert np.linalg.norm(psi - psi_true) / np.linalg.norm(psi_true) \
            <= 1e-6
    assert np.abs(hom.psi.numpy() - pr.pi.numpy()).max() <= 1e-6


def test_entry_points_default_to_the_card():
    g = tg.erdos_renyi(50, 200, seed=1)
    if torch.cuda.is_available():
        assert tc.build_pagerank_ops(g).inv_outdeg.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tc.build_pagerank_ops(g)


def test_quickstart_example_runs_on_cpu(capsys):
    """``examples/torch_quickstart.py`` with ``--device cpu``: every solver
    line printed, ψ within 1e-6 of exact and PageRank of homogeneous ψ."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for head in ("Power-ψ:", "rel. error vs exact:", "Power-NF:",
                 "PageRank max diff:", "top-5 influencers:"):
        assert head in out
    err = float(out.split("rel. error vs exact: ")[1].split()[0])
    diff = float(out.split("PageRank max diff: ")[1].split()[0])
    assert err <= 1e-6 and diff <= 1e-6
