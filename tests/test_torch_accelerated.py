"""The port's Aitken-accelerated loop against the JAX package's.

At float64 the accelerated loop makes the same jump decisions as the JAX
package's ``_make_accelerated_loop`` on the seeds of
``tests/test_accelerated.py``, so it consumes the same number of mat-vecs.
The tols are 1e-6 and 1e-9: far above the f64 rounding floor, where a last
bit of a sum taken in another order cannot move a decision (at 1e-12 the
homogeneous case differs by one body). At float32 a jump can land in a
basin whose plain iteration limit-cycles above a tol near the f32 floor
(the JAX package's precision note), so the service checks run at float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.obs import calibrate


@pytest.fixture(autouse=True)
def _fresh_port_calibration_store():
    """The port's calibration store is process-wide planner input: samples
    an ``auto`` engine feeds in one test would reach later tests' plans."""
    prev = calibrate.set_store(calibrate.CalibrationStore())
    yield
    calibrate.set_store(prev)


def _x64():
    """JAX's float64 switch as a context manager, across jax versions."""
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


def _activity(pkg, n, regime):
    return (pkg.heterogeneous(n, seed=5) if regime == "het"
            else pkg.homogeneous(n))


@pytest.fixture(scope="module")
def graphs():
    return (tg.powerlaw_configuration(3000, 20000, seed=4),
            jg.powerlaw_configuration(3000, 20000, seed=4))


@pytest.mark.parametrize("regime", ["het", "hom"])
@pytest.mark.parametrize("tol", [1e-6, 1e-9])
def test_matvecs_equal_jax_at_f64(graphs, regime, tol):
    g_t, g_j = graphs
    with _x64():
        res_j = jc.make_engine("accelerated", graph=g_j,
                               activity=_activity(jc, g_j.n, regime),
                               dtype=jnp.float64).run(tol=tol)
        want = (int(res_j.matvecs), int(res_j.iterations))
    kw = dict(graph=g_t, activity=_activity(tc, g_t.n, regime),
              dtype=torch.float64, device="cpu")
    res = tc.make_engine("accelerated", **kw).run(tol=tol)
    assert (res.matvecs, res.iterations) == want
    assert res.converged and res.gap <= tol
    plain = tc.make_engine("reference", **kw).run(tol=tol)
    assert res.matvecs < plain.matvecs
    # the functional entry point and the cuda engine run the same loop
    fn = tc.power_psi_accelerated(tc.build_operators(
        g_t, kw["activity"], dtype=torch.float64, device="cpu"), tol=tol)
    cuda = tc.make_engine("cuda", accelerate=True, **kw).run(tol=tol)
    assert fn.matvecs == cuda.matvecs == res.matvecs


@pytest.mark.parametrize("regime", ["het", "hom"])
def test_accelerated_psi_matches_exact(graphs, regime):
    g_t, g_j = graphs
    exact, _ = jc.exact_psi(g_j, _activity(jc, g_j.n, regime))
    for backend, opts in (("accelerated", {}), ("cuda", {"accelerate": True}),
                          ("cuda", {"accelerate": True, "regime": "bsr"})):
        res = tc.make_engine(backend, graph=g_t,
                             activity=_activity(tc, g_t.n, regime),
                             dtype=torch.float64, device="cpu",
                             **opts).run(tol=1e-9)
        err = np.abs(res.psi.numpy() - exact).max()
        assert res.converged and err <= 1e-9, (backend, opts, err)


def test_accelerated_never_terminates_early_spuriously():
    """The Eq. 19 guarantee: the gap is always measured after a plain step
    (the JAX package's test, at f64)."""
    g = tg.erdos_renyi(400, 2600, seed=6)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=7),
                             dtype=torch.float64, device="cpu")
    base = tc.power_psi(ops, tol=1e-12)
    for tol in (1e-4, 1e-6, 1e-8):
        acc = tc.power_psi_accelerated(ops, tol=tol)
        assert acc.converged
        delta = float((acc.psi - base.psi).abs().sum())
        assert delta <= 10 * tol + 1e-6


def test_extrapolate_every_and_check_every_options():
    g = tg.powerlaw_configuration(300, 1800, seed=3)
    act = tc.heterogeneous(g.n, seed=4)
    kw = dict(graph=g, activity=act, dtype=torch.float64, device="cpu")
    a = tc.make_engine("accelerated", extrapolate_every=4, **kw).run(tol=1e-9)
    b = tc.make_engine("accelerated", check_every=3, **kw).run(tol=1e-9)
    assert a.converged and b.converged and b.iterations % 2 == 0
    assert tc.make_engine("reference", device="cpu").accelerate is False
    assert tc.make_engine("accelerated", device="cpu").accelerate is True


@pytest.mark.parametrize("backend,accelerate", [("auto", False),
                                                ("auto", True)])
def test_auto_service_top_k_matches_jax(backend, accelerate):
    g_t = tg.powerlaw_configuration(300, 1800, seed=3)
    g_j = jg.powerlaw_configuration(300, 1800, seed=3)
    svc_j = jc.PsiService(g_j, jc.heterogeneous(g_j.n, seed=4))
    svc_t = tc.PsiService(g_t, tc.heterogeneous(g_t.n, seed=4),
                          backend=backend, accelerate=accelerate,
                          dtype=torch.float64, tol=1e-10, device="cpu")
    assert svc_t.engine.accelerate is accelerate
    np.testing.assert_array_equal(svc_t.top_k(10)[0], svc_j.top_k(10)[0])
    np.testing.assert_allclose(svc_t.scores(), np.asarray(svc_j.scores()),
                               rtol=1e-5, atol=1e-9)
    users = np.asarray([3, 17, 42])
    lam = np.asarray([2.0, 0.3, 1.5])
    for svc in (svc_t, svc_j):
        svc.update_activity(users, lam=lam)
    np.testing.assert_array_equal(svc_t.top_k(10)[0], svc_j.top_k(10)[0])


def test_service_records_the_solver_verdict_before_a_resolve():
    from repro_torch.obs import explain
    prev = explain.set_log(explain.DecisionLog())
    try:
        g = tg.powerlaw_configuration(300, 1800, seed=3)
        svc = tc.PsiService(g, tc.heterogeneous(g.n, seed=4),
                            backend="auto", device="cpu")
        svc.scores()
        svc.update_activity(np.arange(30), lam=np.full(30, 2.0),
                            resolve=False)
        assert svc._dirty == 30
        svc.resolve()
        rec = explain.get_log().last(kind="solver_choice")
        assert rec.inputs["dirty_frac"] == pytest.approx(0.1)
        assert svc._dirty == 0
    finally:
        explain.set_log(prev)


def test_accelerate_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    g = tg.powerlaw_configuration(300, 1800, seed=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.make_engine("accelerated")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.PsiService(g, tc.heterogeneous(g.n, seed=4), backend="auto",
                      accelerate=True)
