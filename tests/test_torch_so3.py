"""The port's SO(3) machinery (``repro_torch.models.gnn.so3``) against the
JAX package's on the same inputs, and the port's own versions of
``tests/test_so3.py``'s representation checks.

Tolerances: the host tables (``real_cg``, the small-d tables) are the same
numpy code, so equal bit for bit; the tensor half (Wigner matrices,
spherical harmonics, rotation angles) at float64 within 1e-12 of JAX at
x64 (sums of a few dozen products taken in another order); the property
checks at the JAX tests' own limits, at float64.
"""
import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import so3 as jso3
from repro_torch.models.gnn import so3

F64 = 1e-12


@contextlib.contextmanager
def _x64():
    """JAX at float64 for the duration."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _unit_vectors(k=24, seed=0):
    """Random unit vectors, with the poles and the zero vector (a sentinel
    edge's r̂) among them."""
    r = np.random.default_rng(seed).normal(size=(k, 3))
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    r[0], r[1], r[2] = [0, 0, 1], [0, 0, -1], [0, 0, 0]
    return r


@pytest.mark.parametrize("path", [(0, 0, 0), (1, 1, 0), (1, 1, 2),
                                  (2, 1, 1), (2, 2, 2), (3, 2, 3),
                                  (6, 2, 6), (6, 2, 5)])
def test_real_cg_equals_jax(path):
    assert np.array_equal(so3.real_cg(*path), jso3.real_cg(*path))


@pytest.mark.parametrize("l", range(7))
def test_wigner_real_matches_jax_f64(l):
    rng = np.random.default_rng(l)
    alpha = rng.uniform(-np.pi, np.pi, 16)
    cb = np.concatenate([rng.uniform(-1, 1, 14), [1.0, -1.0]])
    with _x64():
        want = np.asarray(jso3.wigner_real(l, jnp.asarray(alpha),
                                           jnp.asarray(cb)))
    got = so3.wigner_real(l, torch.tensor(alpha), torch.tensor(cb))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64)


def test_sph_harm_and_rotation_angles_match_jax_f64():
    r = _unit_vectors()
    with _x64():
        ys = [np.asarray(y) for y in jso3.sph_harm_all(6, jnp.asarray(r))]
        al, cb = (np.asarray(a) for a in jso3.rotation_angles(
            jnp.asarray(r)))
    a_t, cb_t = so3.rotation_angles(torch.tensor(r))
    np.testing.assert_allclose(a_t.numpy(), al, rtol=0, atol=F64)
    np.testing.assert_allclose(cb_t.numpy(), cb, rtol=0, atol=F64)
    got = so3.sph_harm_all(6, torch.tensor(r))
    assert len(got) == 7
    for l, (g, w) in enumerate(zip(got, ys)):
        assert g.shape == (r.shape[0], 2 * l + 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F64)


def test_host_helpers_equal_jax():
    assert so3.l_offsets(6) == jso3.l_offsets(6)
    assert so3.irreps_dim(6) == jso3.irreps_dim(6) == 49
    for lm, mm in [(2, 1), (6, 2), (3, 3)]:
        assert np.array_equal(so3.m_truncation_index(lm, mm),
                              jso3.m_truncation_index(lm, mm))
    for l in range(7):
        for a, b in zip(so3._d_tables(l), jso3._d_tables(l)):
            assert np.array_equal(a, b)


def test_rotate_to_frame_matches_einsum():
    rng = np.random.default_rng(5)
    d = torch.tensor(rng.normal(size=(4, 5, 5)))
    x = torch.tensor(rng.normal(size=(4, 5, 3)))
    np.testing.assert_allclose(so3.rotate_to_frame(x, d).numpy(),
                               np.einsum("bmk,bkc->bmc", d, x), atol=F64)
    np.testing.assert_allclose(so3.rotate_to_frame(x, d, inverse=True
                                                   ).numpy(),
                               np.einsum("bkm,bkc->bmc", d, x), atol=F64)


# ------------------------------------------------------------------- #
# tests/test_so3.py's properties, on the port (float64)
# ------------------------------------------------------------------- #
@pytest.mark.parametrize("l", range(7))
def test_wigner_orthogonal(l):
    rng = np.random.default_rng(l)
    a = torch.tensor(rng.uniform(-np.pi, np.pi, (4,)))
    cb = torch.tensor(rng.uniform(-1, 1, (4,)))
    D = so3.wigner_real(l, a, cb).numpy()
    eye = np.einsum("bij,bkj->bik", D, D)
    assert np.abs(eye - np.eye(2 * l + 1)).max() < 1e-4


@pytest.mark.parametrize("l", range(5))
def test_sph_harm_norm(l):
    r = _unit_vectors(seed=7)[3:]
    y = so3.sph_harm_all(l, torch.tensor(r))[l].numpy()
    want = math.sqrt((2 * l + 1) / (4 * math.pi))
    assert np.abs(np.linalg.norm(y, axis=-1) - want).max() < 1e-5


@pytest.mark.parametrize("alpha,cbeta", [(0.3, 0.2), (-2.9, -0.95),
                                         (1.7, 0.6), (3.0, -0.1)])
def test_sph_harm_equivariance(alpha, cbeta):
    """Y(R r) = D(R) Y(r) with R extracted from the l=1 block."""
    r = _unit_vectors(k=8, seed=0)[3:]
    D1 = so3.wigner_real(1, torch.tensor([alpha]),
                         torch.tensor([cbeta]))[0].numpy()
    M = np.array([[0., -1, 0], [0, 0, 1], [1, 0, 0]])   # xyz → (−y,z,x)
    R = np.linalg.inv(M) @ D1 @ M
    for l in range(4):
        D = so3.wigner_real(l, torch.tensor([alpha]),
                            torch.tensor([cbeta]))[0].numpy()
        y = so3.sph_harm_all(l, torch.tensor(r))[l].numpy()
        y_rot = so3.sph_harm_all(l, torch.tensor(r @ R.T))[l].numpy()
        assert np.abs(y_rot - y @ D.T).max() < 1e-4


@pytest.mark.parametrize("path", [(1, 1, 0), (1, 1, 2), (2, 1, 1),
                                  (2, 2, 2), (3, 2, 3), (6, 2, 6),
                                  (6, 2, 5)])
def test_cg_equivariance(path):
    l1, l2, l3 = path
    C = so3.real_cg(l1, l2, l3)
    rng = np.random.default_rng(sum(path))
    x = rng.normal(size=(2 * l1 + 1,))
    y = rng.normal(size=(2 * l2 + 1,))
    ds = [so3.wigner_real(l, torch.tensor([0.83]),
                          torch.tensor([-0.41]))[0].numpy()
          for l in (l1, l2, l3)]
    lhs = np.einsum("pqr,p,q->r", C, ds[0] @ x, ds[1] @ y)
    rhs = ds[2] @ np.einsum("pqr,p,q->r", C, x, y)
    assert np.abs(lhs - rhs).max() < 1e-5


def test_rotation_to_edge_frame_concentrates_m0():
    """The eSCN precondition: D(angles(r̂))ᵀ Y(r̂) has support only at
    m=0 — also at the poles."""
    rh = torch.tensor(_unit_vectors(k=12, seed=3)[np.r_[0, 1, 3:12]])
    al, cb = so3.rotation_angles(rh)
    for l in (1, 2, 4, 6):
        D = so3.wigner_real(l, al, cb).numpy()
        y = so3.sph_harm_all(l, rh)[l].numpy()
        rot = np.einsum("bmk,bm->bk", D, y)
        assert np.abs(np.delete(rot, l, axis=1)).max() < 1e-4
        assert np.all(rot[:, l] > 0)


def test_float32_tables_follow_the_input():
    r = torch.tensor(_unit_vectors()[3:], dtype=torch.float32)
    ys = so3.sph_harm_all(3, r)
    assert all(y.dtype == torch.float32 for y in ys)
    ref = so3.sph_harm_all(3, r.double())
    for a, b in zip(ys, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
