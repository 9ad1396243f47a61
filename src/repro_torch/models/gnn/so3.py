"""SO(3) representation machinery for the equivariant GNNs.

A port of the JAX package's ``models/gnn/so3.py``. The host half — complex
Clebsch–Gordan coefficients by the Racah formula, the complex→real change
of basis U_l, the real CG tensors, the Wigner small-d polynomial tables and
the eSCN truncation index — is a copy of the JAX module's numpy code
(float64, memoized). The device half is written on tensors:

  * real Wigner matrices D^l(α, β) in real arithmetic only (the
    column-phase decomposition of Re(U · diag(e^{−imα}) · d(β) · U^†)),
  * real spherical harmonics defined from them,
    Y_l(r̂) = √((2l+1)/4π) · D^l(φ, θ)[:, m=0].

The small-d matrix is a polynomial in (cos β/2, sin β/2): its term values
are scattered into the matrix by a product with a one-hot [terms, K²]
table, a fixed-order sum (no atomics on a card). Host tables move to the
input's device and dtype once per call.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["real_cg", "wigner_d_beta", "wigner_real", "sph_harm_all",
           "rotation_angles", "rotate_to_frame", "irreps_dim", "l_offsets",
           "m_truncation_index"]


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_offsets(l_max: int) -> list[int]:
    return [l * l for l in range(l_max + 1)]


# --------------------------------------------------------------------- #
# Complex CG (Racah) and the real basis
# --------------------------------------------------------------------- #
@lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return float(math.factorial(n))


def _cg_complex(j1: int, m1: int, j2: int, m2: int, j3: int, m3: int
                ) -> float:
    if m3 != m1 + m2 or not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1) * _fact(j3 + j1 - j2) * _fact(j3 - j1 + j2) *
        _fact(j1 + j2 - j3) / _fact(j1 + j2 + j3 + 1))
    pref *= math.sqrt(
        _fact(j3 + m3) * _fact(j3 - m3) / (_fact(j1 + m1) * _fact(j1 - m1) *
                                           _fact(j2 + m2) * _fact(j2 - m2)))
    total = 0.0
    for k in range(max(0, j2 + m3 - j1), min(j3 - j1 + j2, j3 + m3) + 1):
        total += ((-1) ** (k + j2 + m2) * _fact(j2 + j3 + m1 - k) *
                  _fact(j1 - m1 + k) /
                  (_fact(k) * _fact(j3 - j1 + j2 - k) * _fact(j3 + m3 - k) *
                   _fact(k + j1 - j2 - m3)))
    return pref * total


@lru_cache(maxsize=None)
def _u_matrix(l: int) -> np.ndarray:
    """Complex→real change of basis: Y^real = U @ Y^complex.

    Row order: m' = −l..l (sin components negative, cos positive).
    """
    k = 2 * l + 1
    u = np.zeros((k, k), np.complex128)
    u[l, l] = 1.0
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(1, l + 1):
        u[l + m, l + m] = (-1) ** m * s2        # cos row ← Y_m
        u[l + m, l - m] = s2                    # cos row ← Y_{−m}
        u[l - m, l - m] = 1j * s2               # sin row ← Y_{−m}
        u[l - m, l + m] = -1j * (-1) ** m * s2  # sin row ← Y_m
    return u


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C[m1', m2', m3'] (float64).

    Defined so that for real Wigner matrices D:
      C · (D^{l1} x) ⊗ (D^{l2} y) = D^{l3} (C · x ⊗ y).
    The complex CG picks up a phase under the real transform; we take the
    component (real or imaginary) that carries the weight and verify
    equivariance in tests.
    """
    k1, k2, k3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    cg = np.zeros((k1, k2, k3), np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                cg[l1 + m1, l2 + m2, l3 + m3] = _cg_complex(
                    l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = _u_matrix(l1), _u_matrix(l2), _u_matrix(l3)
    # C_real = (U1 ⊗ U2) C (U3)^†  with the CG viewed as map (m1,m2)→m3
    creal = np.einsum("ac,bd,cde,fe->abf", u1, u2, cg, np.conj(u3))
    re, im = np.real(creal), np.imag(creal)
    if np.abs(im).max() > np.abs(re).max():
        return np.ascontiguousarray(im)
    return np.ascontiguousarray(re)


# --------------------------------------------------------------------- #
# Wigner small-d polynomial tables
# --------------------------------------------------------------------- #
@lru_cache(maxsize=None)
def _d_tables(l: int):
    """Coefficients/exponents so that d[mp, m] = Σ_t coef·c^pc·s^ps."""
    k = 2 * l + 1
    terms: list[tuple[int, int, float, int, int]] = []
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(_fact(l + mp) * _fact(l - mp) *
                             _fact(l + m) * _fact(l - m))
            for s in range(max(0, m - mp), min(l + m, l - mp) + 1):
                denom = (_fact(l + m - s) * _fact(s) * _fact(mp - m + s) *
                         _fact(l - mp - s))
                coef = (-1) ** (mp - m + s) * pref / denom
                pc = 2 * l + m - mp - 2 * s
                ps = mp - m + 2 * s
                terms.append((l + mp, l + m, coef, pc, ps))
    idx = np.array([(t[0], t[1]) for t in terms], np.int32)
    coef = np.array([t[2] for t in terms], np.float64)
    pc = np.array([t[3] for t in terms], np.int32)
    ps = np.array([t[4] for t in terms], np.int32)
    return k, idx, coef, pc, ps


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


@lru_cache(maxsize=None)
def _d_onehot(l: int) -> np.ndarray:
    """f64[T, K²]: term t adds into flat cell idx[t, 0]·K + idx[t, 1]."""
    k, idx, coef, _, _ = _d_tables(l)
    onehot = np.zeros((coef.shape[0], k * k))
    onehot[np.arange(coef.shape[0]), idx[:, 0] * k + idx[:, 1]] = 1.0
    return onehot


def wigner_d_beta(l: int, cos_beta: torch.Tensor) -> torch.Tensor:
    """Real small-d matrix d^l(β): [..., 2l+1, 2l+1] from cos β."""
    k, _, coef, pc, ps = _d_tables(l)
    cb2 = torch.sqrt(torch.clamp((1 + cos_beta) / 2, 0, 1))
    sb2 = torch.sqrt(torch.clamp((1 - cos_beta) / 2, 0, 1))
    # [..., T] term values
    vals = (_table(coef, cos_beta)
            * cb2[..., None] ** _table(pc, cos_beta)
            * sb2[..., None] ** _table(ps, cos_beta))
    return (vals @ _table(_d_onehot(l), cos_beta)).reshape(
        cos_beta.shape + (k, k))


@lru_cache(maxsize=None)
def _u_parts(l: int):
    u = _u_matrix(l)
    return (np.ascontiguousarray(np.real(u)),
            np.ascontiguousarray(np.imag(u)))


def wigner_real(l: int, alpha: torch.Tensor,
                cos_beta: torch.Tensor) -> torch.Tensor:
    """Real Wigner matrix D^l(α, β, γ=0): [..., 2l+1, 2l+1].

    D^r = Re( U · diag(e^{−imα}) · d(β) · U^† ), evaluated with real
    arithmetic only (Mr/Mi column-phase decomposition).
    """
    ur, ui = (_table(a, alpha) for a in _u_parts(l))
    m = torch.arange(-l, l + 1, dtype=alpha.dtype, device=alpha.device)
    ca = torch.cos(alpha[..., None] * m)       # [..., K]
    sa = torch.sin(alpha[..., None] * m)
    # M = U diag(e^{-imα}):  M[:, m] = U[:, m]·(cos − i sin)
    mr = ur * ca[..., None, :] + ui * sa[..., None, :]
    mi = ui * ca[..., None, :] - ur * sa[..., None, :]
    d = wigner_d_beta(l, cos_beta)             # [..., K, K]
    # V = U^† → Vr = urᵀ, Vi = −uiᵀ;  Re(M d V) = Mr d Vr − Mi d Vi
    vr, vi = ur.T, -ui.T
    return (mr @ d) @ vr - (mi @ d) @ vi


def rotation_angles(rhat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(α=φ, cos β=cos θ) of the rotation R(φ,θ) with R·ẑ = r̂."""
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]
    return torch.atan2(y, x), torch.clamp(z, -1.0, 1.0)


def sph_harm_all(l_max: int, rhat: torch.Tensor) -> list[torch.Tensor]:
    """Real orthonormal spherical harmonics [Y_0, …, Y_{l_max}].

    Y_l(r̂) = √((2l+1)/4π) · D^l(φ, θ)[:, m=0] — consistent with
    ``wigner_real`` by construction. Each element: [..., 2l+1].
    """
    alpha, cb = rotation_angles(rhat)
    return [math.sqrt((2 * l + 1) / (4 * math.pi))
            * wigner_real(l, alpha, cb)[..., :, l] for l in range(l_max + 1)]


def rotate_to_frame(x_l: torch.Tensor, d_l: torch.Tensor,
                    inverse: bool = False) -> torch.Tensor:
    """Apply D (or Dᵀ) blockwise: x [..., K, C], D [..., K, K]."""
    if inverse:
        return torch.einsum("...km,...kc->...mc", d_l, x_l)
    return torch.einsum("...mk,...kc->...mc", d_l, x_l)


def m_truncation_index(l_max: int, m_max: int) -> np.ndarray:
    """Flat irrep indices with |m| ≤ m_max (eSCN truncation)."""
    idx = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= m_max:
                idx.append(l * l + l + m)
    return np.asarray(idx, np.int32)
