"""The port's operators and host mirror against the JAX package's."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.convert import operators_from_numpy


def _pair(seed=3, n=300, m=1800):
    return (tg.powerlaw_configuration(n, m, seed=seed),
            jg.powerlaw_configuration(n, m, seed=seed))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("seed", [3, 8])
def test_build_operators_fields_match_jax_f32(seed):
    g_t, g_j = _pair(seed)
    act = tc.heterogeneous(g_t.n, seed=4)
    ops_t = tc.build_operators(g_t, act, device="cpu")
    ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=4))
    assert (ops_t.n, ops_t.m) == (ops_j.n, ops_j.m)
    for f in ("src_by_dst", "dst_by_dst"):
        np.testing.assert_array_equal(_np(getattr(ops_t, f)),
                                      _np(getattr(ops_j, f)))
    for f in ("lam", "mu", "inv_w", "c", "d", "b_norm"):
        assert getattr(ops_t, f).dtype == torch.float32
        np.testing.assert_allclose(_np(getattr(ops_t, f)),
                                   _np(getattr(ops_j, f)), rtol=1e-6, err_msg=f)
    np.testing.assert_array_equal(_np(ops_t.in_degree), g_t.in_degree)


def test_push_epilogue_match_jax():
    g_t, g_j = _pair()
    ops_t = tc.build_operators(g_t, tc.heterogeneous(g_t.n, seed=4),
                               device="cpu")
    ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=4))
    s = np.random.default_rng(0).uniform(size=g_t.n).astype(np.float32)
    st = torch.as_tensor(s)
    for name in ("push", "left_matvec", "psi_epilogue"):
        np.testing.assert_allclose(_np(getattr(ops_t, name)(st)),
                                   _np(getattr(ops_j, name)(s)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_push_float64_matches_dense():
    g, _ = _pair()
    act = tc.heterogeneous(g.n, seed=4)
    ops = tc.build_operators(g, act, dtype=torch.float64, device="cpu")
    A, B, c, d = tc.dense_operators(g, act)
    s = np.random.default_rng(1).uniform(size=g.n)
    np.testing.assert_allclose(_np(ops.left_matvec(torch.as_tensor(s))),
                               s @ A, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(_np(ops.psi_epilogue(torch.as_tensor(s))),
                               (s @ B + d) / g.n, rtol=1e-12, atol=1e-15)


def _host_fields(h):
    return {f.name: getattr(h, f.name) for f in dataclasses.fields(h)}


def test_host_operator_patch_sequence_matches_jax_exactly():
    g_t, g_j = _pair(seed=5, n=200, m=1000)
    ht = tc.HostOperators.from_graph(g_t, tc.heterogeneous(g_t.n, seed=2))
    hj = jc.HostOperators.from_graph(g_j, jc.heterogeneous(g_j.n, seed=2))
    rng = np.random.default_rng(9)
    users = rng.integers(0, g_t.n, 12)
    lam = rng.uniform(0.01, 2.0, 12)
    new_src = rng.integers(0, g_t.n, 40)
    new_dst = rng.integers(0, g_t.n, 40)
    # a follower losing every leader must land on w == 0 exactly
    j0 = int(g_t.src[0])
    gone_dst = g_t.dst[g_t.src == j0]
    gone_src = np.full(gone_dst.size, j0)
    steps = [
        ("patch_activity", (users,), dict(lam=lam)),
        ("patch_activity", (users[:3],), dict(mu=0.5)),
        ("patch_edges", (new_src, new_dst), {}),
        ("remove_edges", (np.concatenate([gone_src, new_src[:5]]),
                          np.concatenate([gone_dst, new_dst[:5]])), {}),
        ("patch_edges", (new_src[:5], new_dst[:5]), {}),
    ]
    for name, args, kw in steps:
        out_t = getattr(ht, name)(*args, **kw)
        out_j = getattr(hj, name)(*args, **kw)
        if isinstance(out_t, tuple):
            for x, y in zip(out_t, out_j):
                np.testing.assert_array_equal(x, y)
        else:
            assert out_t == out_j
        ft, fj = _host_fields(ht), _host_fields(hj)
        for k in ft:
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=f"{name}:{k}")
    assert ht.w[j0] == 0.0
    assert ht.b_norm == hj.b_norm
    for x, y in zip(ht.cd(), hj.cd()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -1.0])
def test_patch_activity_rejects_poisoned_rates(bad):
    g, _ = _pair()
    h = tc.HostOperators.from_graph(g, tc.heterogeneous(g.n, seed=2))
    before = h.w.copy()
    with pytest.raises(ValueError):
        h.patch_activity(np.asarray([1, 2]), lam=np.asarray([0.5, bad]))
    np.testing.assert_array_equal(h.w, before)


def test_device_operators_do_not_alias_the_host_mirror():
    g, _ = _pair()
    h = tc.HostOperators.from_graph(g, tc.heterogeneous(g.n, seed=2))
    ops = h.to_device(torch.float64, "cpu")
    lam0 = ops.lam.clone()
    h.patch_activity(np.arange(10), lam=np.full(10, 3.0))
    assert torch.equal(ops.lam, lam0)


def test_operators_from_numpy_of_jax_gives_the_same_push():
    g_t, g_j = _pair()
    ops_j = jc.build_operators(g_j, jc.heterogeneous(g_j.n, seed=4))
    fields = {f.name: np.asarray(getattr(ops_j, f.name))
              for f in dataclasses.fields(ops_j)}
    ops_c = operators_from_numpy(fields, device="cpu")
    ops_t = tc.build_operators(g_t, tc.heterogeneous(g_t.n, seed=4),
                               device="cpu")
    s = np.random.default_rng(0).uniform(size=g_t.n).astype(np.float32)
    assert ops_c.dtype == torch.float32
    np.testing.assert_array_equal(_np(ops_c.push(torch.as_tensor(s))),
                                  _np(ops_t.push(torch.as_tensor(s))))
    np.testing.assert_allclose(_np(ops_c.push(torch.as_tensor(s))),
                               _np(ops_j.push(s)), rtol=1e-5, atol=1e-7)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    g, _ = _pair()
    with pytest.raises(RuntimeError, match="cuda"):
        tc.build_operators(g, tc.heterogeneous(g.n, seed=4))
