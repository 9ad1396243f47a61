"""The port's residual-push backend against the JAX package: the host
float64 push state bit for bit, the certificates, the ``push`` engine in
both frontiers, and certified top-k serving.

Same seeded inputs through both packages in one process; the port runs with
``device="cpu"``. The host push (``frontier="bucket"``, the warm reseeds,
the certificates) is the JAX package's numpy code, so it must agree to the
last bit; the device rounds (``frontier="jit"``) run in float32 and are held
to the certificate against ``exact_psi`` and to JAX's certified set.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro.localpush as jl
import repro_torch.core as tc
import repro_torch.graphs as tg
import repro_torch.localpush as tl
from repro.core.incremental import RankingCache as JRankingCache
from repro.localpush import warm as jwarm
from repro_torch.core.incremental import RankingCache as TRankingCache
from repro_torch.localpush import push as tpush
from repro_torch.localpush import warm as twarm


@pytest.fixture(scope="module")
def platform():
    """(port graph, JAX graph, port activity, JAX activity, exact ψ)."""
    g_t = tg.powerlaw_configuration(400, 2600, seed=5)
    g_j = jg.powerlaw_configuration(400, 2600, seed=5)
    a_t = tc.heterogeneous(g_t.n, seed=6)
    psi_true, _ = tc.exact_psi(g_t, a_t)
    return g_t, g_j, a_t, jc.heterogeneous(g_j.n, seed=6), psi_true


def _hosts(platform):
    g_t, g_j, a_t, a_j, _ = platform
    return (tc.HostOperators.from_graph(g_t, a_t),
            jc.HostOperators.from_graph(g_j, a_j))


def _same_state(st_t, st_j):
    for f in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(st_t, f), getattr(st_j, f),
                                      err_msg=f)


def _same_host(h_t, h_j):
    for f in dataclasses.fields(h_j):
        a, b = getattr(h_t, f.name), getattr(h_j, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)


# --------------------------------------------------------------------- #
# Host float64 push: bitwise the JAX package's
# --------------------------------------------------------------------- #
def test_norms_and_certificate_prefactors_bitwise(platform):
    h_t, h_j = _hosts(platform)
    assert tl.a_norm(h_t) == jl.a_norm(h_j)
    assert tl.cert_scale(h_t) == jl.cert_scale(h_j)
    np.testing.assert_array_equal(tl.pernode_cert_scale(h_t),
                                  jl.pernode_cert_scale(h_j))
    np.testing.assert_array_equal(tl.mass_weights(h_t),
                                  jl.mass_weights(h_j))


@pytest.mark.parametrize("tol_r", [1e-4, 1e-11])
def test_push_scalar_bitwise(platform, tol_r):
    h_t, h_j = _hosts(platform)
    st_t, pushes_t, ew_t = tl.push_scalar(h_t, tol_r=tol_r)
    st_j, pushes_j, ew_j = jl.push_scalar(h_j, tol_r=tol_r)
    assert (pushes_t, ew_t) == (pushes_j, ew_j) and pushes_t > 0
    _same_state(st_t, st_j)


@pytest.mark.parametrize("bucket_ratio", [0.5, 0.9])
def test_push_round_sequence_bitwise(platform, bucket_ratio):
    h_t, h_j = _hosts(platform)
    st_t, st_j = tl.cold_state(h_t), jl.cold_state(h_j)
    for _ in range(25):
        nodes_t, ew_t = tl.push_round(h_t, st_t, bucket_ratio=bucket_ratio)
        nodes_j, ew_j = jl.push_round(h_j, st_j, bucket_ratio=bucket_ratio)
        np.testing.assert_array_equal(nodes_t, nodes_j)
        assert ew_t == ew_j
        _same_state(st_t, st_j)
    assert tl.push_until(h_t, st_t, tol_r=1e-10) == \
        jl.push_until(h_j, st_j, tol_r=1e-10)
    _same_state(st_t, st_j)
    np.testing.assert_array_equal(tl.psi_value(h_t, st_t),
                                  jl.psi_value(h_j, st_j))


def test_reseed_state_bitwise(platform):
    h_t, h_j = _hosts(platform)
    x = np.random.default_rng(3).uniform(size=h_t.n)
    _same_state(tl.reseed_state(h_t, x), jl.reseed_state(h_j, x))
    with pytest.raises(ValueError, match="node order"):
        tl.reseed_state(h_t, x[:-1])


def test_warm_reseeds_bitwise_after_interleaved_patches(platform):
    g_t = platform[0]
    h_t, h_j = _hosts(platform)
    st_t, st_j = tl.cold_state(h_t), jl.cold_state(h_j)
    tl.push_until(h_t, st_t, tol_r=1e-9)
    jl.push_until(h_j, st_j, tol_r=1e-9)
    users, lam = np.asarray([3, 17, 99]), np.asarray([2.0, 0.7, 1.3])
    assert twarm.apply_activity_patch(h_t, st_t, users, lam=lam) == \
        jwarm.apply_activity_patch(h_j, st_j, users, lam=lam)
    _same_state(st_t, st_j)
    add_s = np.asarray([0, 5, int(g_t.src[0])], np.int32)
    add_d = np.asarray([30, 31, int(g_t.dst[0])], np.int32)
    for a, b in zip(twarm.apply_edge_insert(h_t, st_t, add_s, add_d),
                    jwarm.apply_edge_insert(h_j, st_j, add_s, add_d)):
        np.testing.assert_array_equal(a, b)
    _same_state(st_t, st_j)
    rm_s = np.asarray([0, 7], np.int32)
    rm_d = np.asarray([30, (int(g_t.dst[7]) + 1) % g_t.n], np.int32)
    for a, b in zip(twarm.apply_edge_remove(h_t, st_t, rm_s, rm_d),
                    jwarm.apply_edge_remove(h_j, st_j, rm_s, rm_d)):
        np.testing.assert_array_equal(a, b)
    _same_state(st_t, st_j)
    _same_host(h_t, h_j)
    # the invariant r = c + μ⊙p − x survives the patches
    fresh = tl.reseed_state(h_t, st_t.x)
    np.testing.assert_allclose(st_t.p, fresh.p, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(st_t.r, fresh.r, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("tol_r", [1e-2, 1e-6, 1e-10])
def test_neumann_error_bound_and_certify_top_k_equal(platform, tol_r):
    h_t, h_j = _hosts(platform)
    st_t, st_j = tl.cold_state(h_t), jl.cold_state(h_j)
    tl.push_until(h_t, st_t, tol_r=tol_r)
    jl.push_until(h_j, st_j, tol_r=tol_r)
    radii_t, ew_t = tl.neumann_error_bound(h_t, st_t.r)
    radii_j, ew_j = jl.neumann_error_bound(h_j, st_j.r)
    np.testing.assert_array_equal(radii_t, radii_j)
    assert ew_t == ew_j
    for k in (1, 10, 50):
        c_t = tl.certify_top_k(tl.psi_value(h_t, st_t), k, radii_t)
        c_j = jl.certify_top_k(jl.psi_value(h_j, st_j), k, radii_j)
        np.testing.assert_array_equal(c_t.indices, c_j.indices)
        assert (c_t.err_bound, c_t.margin, c_t.certified) == \
            (c_j.err_bound, c_j.margin, c_j.certified)


@pytest.mark.parametrize("k,err_bound", [(1, 0.04), (2, 0.01), (2, None),
                                         (4, 0.5), (0, 0.1)])
def test_certify_top_k_edge_cases_equal(k, err_bound):
    psi = np.asarray([0.5, 0.4, 0.39, 0.1])
    c_t = tl.certify_top_k(psi, k, err_bound)
    c_j = jl.certify_top_k(psi, k, err_bound)
    np.testing.assert_array_equal(c_t.indices, c_j.indices)
    assert (c_t.err_bound, c_t.margin, c_t.certified) == \
        (c_j.err_bound, c_j.margin, c_j.certified)


# --------------------------------------------------------------------- #
# The push engine
# --------------------------------------------------------------------- #
def test_push_backend_is_registered():
    assert "push" in tc.available_backends()
    assert tc.make_engine("push", device="cpu").name == "push"


@pytest.mark.parametrize("tol", [1e-4, 1e-7, 1e-10])
def test_bucket_engine_equals_jax_and_bounds_the_error(platform, tol):
    g_t, g_j, a_t, a_j, psi_true = platform
    e_t = tc.make_engine("push", graph=g_t, activity=a_t, device="cpu")
    e_j = jc.make_engine("push", graph=g_j, activity=a_j)
    r_t, r_j = e_t.run(tol=tol), e_j.run(tol=tol)
    assert e_t.last_run_stats == e_j.last_run_stats
    assert (r_t.iterations, r_t.matvecs, r_t.converged) == \
        (int(r_j.iterations), int(r_j.matvecs), bool(r_j.converged))
    np.testing.assert_array_equal(e_t.last_psi_host, e_j.last_psi_host)
    assert e_t.psi_error_bound() == e_j.psi_error_bound()
    assert np.abs(e_t.last_psi_host - psi_true).max() <= e_t.psi_error_bound()
    assert r_t.psi.device.type == "cpu" and r_t.psi.dtype == torch.float32


@pytest.mark.parametrize("k", [1, 10, 40])
def test_bucket_run_top_k_equals_jax(platform, k):
    g_t, g_j, a_t, a_j, psi_true = platform
    e_t = tc.make_engine("push", graph=g_t, activity=a_t, device="cpu")
    e_j = jc.make_engine("push", graph=g_j, activity=a_j)
    (r_t, c_t), (r_j, c_j) = (e_t.run_top_k(k, tol=1e-10),
                              e_j.run_top_k(k, tol=1e-10))
    assert c_t.certified and c_j.certified
    np.testing.assert_array_equal(c_t.indices, c_j.indices)
    assert (c_t.err_bound, c_t.margin) == (c_j.err_bound, c_j.margin)
    assert e_t.last_run_stats == e_j.last_run_stats
    assert set(c_t.indices.tolist()) == \
        set(np.argsort(-psi_true, kind="stable")[:k].tolist())


def test_engine_warm_patch_locality_and_savings():
    """A 0.1% dirty warm certified-top-k resolve touches a small fraction
    of the graph, beats the cold solve's work, and equals the JAX run."""
    g_t = tg.powerlaw_configuration(2000, 9000, seed=7)
    g_j = jg.powerlaw_configuration(2000, 9000, seed=7)
    act = tc.heterogeneous(g_t.n, seed=8)
    e_t = tc.make_engine("push", graph=g_t, activity=act, device="cpu")
    e_j = jc.make_engine("push", graph=g_j,
                         activity=jc.heterogeneous(g_j.n, seed=8))
    cold_t, cold_j = e_t.run(tol=1e-10), e_j.run(tol=1e-10)
    cold_work = e_t.last_run_stats["edge_work"]
    users = np.random.default_rng(0).choice(g_t.n, size=2, replace=False)
    for e in (e_t, e_j):
        e.patch_activity(users, lam=act.lam[users] * 1.5)
    assert e_t.psi_error_bound() is None     # patch invalidated the cert
    res, cert = e_t.run_top_k(20, tol=1e-10, s0=cold_t.s)
    _, cert_j = e_j.run_top_k(20, tol=1e-10, s0=cold_j.s)
    stats = e_t.last_run_stats
    assert stats == e_j.last_run_stats
    assert stats["reseed_matvecs"] == 0      # identity handle: no reseed
    assert cert.certified and stats["touched_frac"] < 0.5
    assert stats["edge_work"] < cold_work
    np.testing.assert_array_equal(cert.indices, cert_j.indices)
    lam2 = act.lam.copy()
    lam2[users] = act.lam[users] * 1.5
    psi_true, _ = tc.exact_psi(g_t, tc.Activity(lam2, act.mu))
    assert set(cert.indices.tolist()) == \
        set(np.argsort(-psi_true, kind="stable")[:20].tolist())
    e_t.run(tol=1e-10, s0=res.s)
    assert np.abs(e_t.last_psi_host - psi_true).max() <= e_t.psi_error_bound()
    # a foreign s0 (a copy, not the handle) pays one honest reseed
    e_t.run(tol=1e-10, s0=res.s.clone())
    assert e_t.last_run_stats["reseed_matvecs"] == 1


@pytest.mark.parametrize("tol", [1e-6, 1e-9])
def test_jit_frontier_f32_certificate_and_set(platform, tol):
    g_t, g_j, a_t, a_j, psi_true = platform
    e_t = tc.make_engine("push", graph=g_t, activity=a_t, frontier="jit",
                         frontier_size=64, device="cpu")
    e_j = jc.make_engine("push", graph=g_j, activity=a_j, frontier="jit",
                         frontier_size=64)
    res = e_t.run(tol=tol)
    assert res.converged and e_t.last_run_stats["rounds"] > 0
    # the certificate covers the float64 host ψ (verified after the device
    # phase), never raw device state
    assert np.abs(e_t.last_psi_host - psi_true).max() <= e_t.psi_error_bound()
    assert np.abs(res.psi.numpy() - psi_true).max() <= 1e-5
    _, c_t = e_t.run_top_k(10, tol=tol)
    _, c_j = e_j.run_top_k(10, tol=tol)
    assert c_t.certified and c_j.certified
    assert set(c_t.indices.tolist()) == set(c_j.indices.tolist()) == \
        set(np.argsort(-psi_true, kind="stable")[:10].tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_frontier_loop_repeats_bitwise(platform, dtype):
    h_t, _ = _hosts(platform)
    fops = tpush.build_frontier_ops(h_t, dtype=dtype, device="cpu")
    assert fops.leaders.shape == (h_t.n, int(h_t.graph().out_degree.max()))
    loop = tpush.make_frontier_loop(fops, frontier_size=32)
    st = tl.cold_state(h_t)
    args = [torch.as_tensor(v, dtype=dtype) for v in (st.x, st.r, st.p)]
    out1 = loop(*args, 1e-6, 300)
    out2 = loop(*args, 1e-6, 300)
    assert out1[3:] == out2[3:] and 0 < out1[3] <= 300
    for a, b in zip(out1[:3], out2[:3]):
        assert torch.equal(a, b)
    assert torch.equal(args[0], torch.as_tensor(st.x, dtype=dtype))


def test_frontier_loop_keeps_the_invariant_f64(platform):
    """Each round is a batch of elementary pushes, so at float64 the device
    state still satisfies p = push(x) and r = c + μ⊙p − x."""
    h_t, _ = _hosts(platform)
    fops = tpush.build_frontier_ops(h_t, dtype=torch.float64, device="cpu")
    st = tl.cold_state(h_t)
    x, r, p, t, ew = tpush.make_frontier_loop(fops, frontier_size=32)(
        *(torch.as_tensor(v) for v in (st.x, st.r, st.p)), 1e-8, 500)
    assert 0 < t <= 500 and ew > 0
    fresh = tl.reseed_state(h_t, x.numpy())
    np.testing.assert_allclose(p.numpy(), fresh.p, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(r.numpy(), fresh.r, rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("rounds", [1, 40, 300])
def test_frontier_loop_matches_jax_rounds_f32(platform, rounds):
    """The device rounds are the JAX package's: the same top-k frontiers
    (rounds and edge work equal) and states within float32 rounding (the
    JAX scatter's update may contract into an FMA)."""
    import jax.numpy as jnp
    h_t, h_j = _hosts(platform)
    fj = jl.push.build_frontier_ops(h_j, dtype=jnp.float32)
    st = jl.cold_state(h_j)
    *want, tj, ewj = jl.push.make_frontier_loop(fj, frontier_size=16)(
        *(jnp.asarray(v, jnp.float32) for v in (st.x, st.r, st.p)),
        jnp.asarray(1e-6, jnp.float32), jnp.asarray(rounds, jnp.int32))
    ft = tpush.build_frontier_ops(h_t, dtype=torch.float32, device="cpu")
    st = tl.cold_state(h_t)
    *got, t, ew = tpush.make_frontier_loop(ft, frontier_size=16)(
        *(torch.as_tensor(v, dtype=torch.float32) for v in (st.x, st.r, st.p)),
        1e-6, rounds)
    assert (t, ew) == (int(tj), int(ewj))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_jit_frontier_rebuilt_after_edge_patch(platform):
    g_t, _, a_t, _, _ = platform
    eng = tc.make_engine("push", graph=g_t, activity=a_t, frontier="jit",
                         device="cpu")
    eng.run(tol=1e-6)
    assert eng._fops is not None
    eng.patch_edges(np.asarray([0]), np.asarray([13]))
    assert eng._fops is None                 # padded leader table regrows
    g2 = tg.Graph(g_t.n, np.concatenate([g_t.src, [0]]),
                  np.concatenate([g_t.dst, [13]])).dedup()
    psi_true, _ = tc.exact_psi(g2, a_t)
    eng.run(tol=1e-8)
    assert np.abs(eng.last_psi_host - psi_true).max() <= 1e-6
    assert eng.frontier_ops().leaders.device.type == "cpu"


def test_push_engine_validates_options():
    with pytest.raises(ValueError, match="l1"):
        tc.make_engine("push", device="cpu",
                       criterion=tc.ConvergenceCriterion(norm="linf"))
    with pytest.raises(ValueError, match="accelerate"):
        tc.make_engine("push", accelerate=True, device="cpu")
    with pytest.raises(ValueError, match="frontier"):
        tc.make_engine("push", frontier="heap", device="cpu")
    with pytest.raises(ValueError, match="bucket_ratio"):
        tc.make_engine("push", bucket_ratio=0.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tc.make_engine("push")           # the default device is the card


def test_push_engine_rejects_lambda_free_feed():
    """α ≥ 1 (a feed with zero λ mass) has no finite certificate."""
    g = tg.Graph(3, np.asarray([0, 1]), np.asarray([2, 2]))
    act = tc.Activity(np.asarray([1.0, 1.0, 0.0]), np.asarray([1.0, 1.0, 1.0]))
    with pytest.raises(ValueError, match="α"):
        tc.make_engine("push", graph=g, activity=act, device="cpu")


# --------------------------------------------------------------------- #
# Certified serving
# --------------------------------------------------------------------- #
def test_ranking_cache_certified_bound_equals_jax(platform):
    """The f32 served copy adds a dtype-cast term on top of the float64
    certificate — the same inflated bound and indices as the JAX cache."""
    g_t, _, a_t, _, _ = platform
    eng = tc.make_engine("push", graph=g_t, activity=a_t, device="cpu")
    res = eng.run(tol=1e-10)
    raw = eng.psi_error_bound()
    psi32 = res.psi.numpy()
    for psi in (psi32, eng.last_psi_host):
        c_t = TRankingCache(torch.as_tensor(psi),
                            err_bound=raw).top_k_certified(3)
        c_j = JRankingCache(psi, err_bound=raw).top_k_certified(3)
        np.testing.assert_array_equal(c_t.indices, c_j.indices)
        assert (c_t.err_bound, c_t.certified) == (c_j.err_bound,
                                                  c_j.certified)
    eps_term = np.finfo(np.float32).eps * np.abs(psi32).max()
    c32 = TRankingCache(res.psi, err_bound=raw).top_k_certified(3)
    assert c32.err_bound >= raw + 0.5 * eps_term
    c64 = TRankingCache(torch.as_tensor(eng.last_psi_host),
                        err_bound=raw).top_k_certified(3)
    assert c64.err_bound == raw


def test_service_top_k_certified_early_stop_then_resolve(platform):
    g_t, g_j, a_t, a_j, psi_true = platform
    u = int(np.argsort(-psi_true)[5])
    certs = []
    for pkg, g, act, kw in ((tc, g_t, a_t, dict(device="cpu")),
                            (jc, g_j, a_j, {})):
        svc = pkg.PsiService(g, act, tol=1e-10, backend="push", **kw)
        svc.scores()
        svc.update_activity(np.asarray([u]),
                            lam=np.asarray([act.lam[u] * 1.2]),
                            resolve=False)
        certs.append((svc, svc.top_k_certified(10)))
    (svc, cert), (_, cert_j) = certs
    assert cert.certified and cert_j.certified
    np.testing.assert_array_equal(cert.indices, cert_j.indices)
    assert cert.err_bound == cert_j.err_bound
    lam2 = a_t.lam.copy()
    lam2[u] = a_t.lam[u] * 1.2
    psi2, _ = tc.exact_psi(g_t, tc.Activity(lam2, a_t.mu))
    assert set(cert.indices.tolist()) == \
        set(np.argsort(-psi2, kind="stable")[:10].tolist())
    assert svc._early                        # stopped at the certificate
    # a fresh read serves the same set from the cache, against the bound
    np.testing.assert_array_equal(svc.top_k_certified(10).indices,
                                  cert.indices)
    svc.resolve()
    assert not svc._early
    assert np.abs(svc.scores() - psi2).max() <= 1e-6
    assert svc.top_k_certified(10).err_bound is not None


def test_service_noncertifying_backend_is_honest(platform):
    g_t, _, a_t, _, _ = platform
    svc = tc.PsiService(g_t, a_t, tol=1e-9, backend="reference",
                        device="cpu")
    cert = svc.top_k_certified(5)
    assert not cert.certified                # no residual bound to certify
    assert cert.err_bound is None
    assert cert.indices.shape == (5,)        # indices still served
    assert svc.engine.psi_error_bound() is None
