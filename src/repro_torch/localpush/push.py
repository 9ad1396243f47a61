"""Gauss-Southwell forward push on the Eq. 19 residual — local ψ solves.

Power-ψ iterates the affine contraction ``s ← M s + c`` with
``M[i, j] = μ_i / w_j`` for each follow edge (j → i) (the column form of
``sᵀ ← sᵀA + cᵀ``). Instead of sweeping all N coordinates per iteration,
forward push maintains the *residual decomposition*

    s* = x + (I − M)⁻¹ r          (push invariant)

where ``x`` is the settled part and ``r`` is unpushed mass. Pushing a
follower ``j`` moves its residual into ``x`` and forwards the discounted
remainder to the leaders it follows:

    x_j += r_j;   r_i += μ_i · r_j / w_j   for every i ∈ L(j);   r_j = 0.

Each push strictly shrinks ``‖r‖₁`` by at least ``(1 − α)·|r_j|`` with

    α = ‖M‖₁ = max_j (w_j − Σ_{i∈L(j)} λ_i) / w_j  < 1,

so work concentrates where residual actually lives — after a localized
patch that is the affected subgraph, not the platform.

Certificate (the running Eq. 19-style bound): with the companion vector
``p = push(x)`` (``p_i = Σ_{(j→i)} x_j / w_j``), the served scores are
``ψ̂ = (λ ⊙ p + d)/N`` — an O(N) read, no mat-vec — and

    ‖ψ_exact − ψ̂‖₁ ≤ ‖B‖₁ · ‖r‖₁ / ((1 − α) · N)

(hence per-node too, since l∞ ≤ l1). ``p`` rides the same scatter as ``r``
during pushes (``p_i += r_j / w_j``), which is what makes the certificate
and the certified top-k check (:mod:`repro_torch.localpush.topk`) free of O(M)
work.

Precision: the push state is float64 numpy regardless of the engine's
device dtype. The residual recurrence contracts geometrically with no
floor, but a float32 ``x`` accumulation (or a float32 warm reseed
``r = c + M x − x``, which cancels catastrophically) would make the
certificate anti-conservative near tight tolerances — exactly what a
*certificate* must never be.

Two frontier loops share the elementary batched push
(:func:`push_nodes`):

* :func:`push_round` — one bucketed round: push every node whose ``|r|``
  is within ``bucket_ratio`` of the current max (a frexp-style magnitude
  bucket — no heap, no per-push priority maintenance).
* :func:`push_scalar` — the pure-Python bucket-queue Gauss-Southwell
  loop, kept as the parity oracle for the vectorized and device paths.

:func:`make_frontier_loop` runs fixed-frontier-size batched rounds on a
torch device (``torch.topk`` + padded out-edge gather + one segment sum
over the stably sorted heads, so a round adds in a fixed order and repeats
bit for bit); its float32 iterate is always re-verified on the host in
float64 before any certificate is emitted (see ``PushEngine``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.operators import HostOperators
from ..device import numpy_dtype, resolve_device

__all__ = ["PushState", "cold_state", "reseed_state", "a_norm", "cert_scale",
           "psi_value", "l1", "push_nodes", "push_round", "push_until",
           "push_scalar", "FrontierOps", "build_frontier_ops",
           "make_frontier_loop"]


# --------------------------------------------------------------------- #
# State + invariant helpers
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class PushState:
    """Mutable float64 push state; arrays are updated in place.

    Invariants (checked by the tests after every patch):
      * ``s* = x + (I − M)⁻¹ r``
      * ``p = push(x)``  and therefore  ``r = c + μ ⊙ p − x``.
    """

    x: np.ndarray   # f64[N] settled series mass
    r: np.ndarray   # f64[N] unpushed residual
    p: np.ndarray   # f64[N] = push(x), maintained alongside r

    def copy(self) -> "PushState":
        return PushState(self.x.copy(), self.r.copy(), self.p.copy())


def _masked_inv(w: np.ndarray) -> np.ndarray:
    return np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)


def l1(v: np.ndarray) -> float:
    return float(np.abs(v).sum())


def a_norm(host: HostOperators) -> float:
    """α = ‖M‖₁ = max_j (w_j − row_lam_j)/w_j — the push contraction rate.

    Strictly < 1 iff every non-empty news feed carries some λ mass
    (``row_lam_j > 0`` wherever ``w_j > 0``); α = 1 makes the residual
    certificate vacuous, so callers must reject it at prepare time.
    """
    if host.n == 0:
        return 0.0
    return float(((host.w - host.row_lam) * host.inv_w).max())


def cert_scale(host: HostOperators, alpha: float | None = None) -> float:
    """‖B‖₁ / ((1 − α)·N): multiply by ‖r‖₁ for the ψ l1/l∞ error bound."""
    alpha = a_norm(host) if alpha is None else float(alpha)
    if alpha >= 1.0:
        return math.inf
    return host.b_norm / ((1.0 - alpha) * max(1, host.n))


def pernode_cert_scale(host: HostOperators) -> np.ndarray:
    """f64[N] per-node certificate prefactor ρ with ``|ψ_i − ψ̂_i| ≤ ρ_i·S``.

    From ``δψ_i = λ_i/N · Σ_{j→i} δs_j/w_j`` (sum over i's followers j):

        |δψ_i| ≤ λ_i/N · min(g_i·‖δs‖∞, h_i·‖δs‖₁) ≤ λ_i·min(g_i, h_i)/N · S

    with ``g_i = Σ_{j→i} 1/w_j``, ``h_i = max_{j→i} 1/w_j`` and ``S`` any
    upper bound on ``‖δs‖₁`` (:func:`neumann_error_bound` supplies the
    tight one). A node followed by nobody has ρ_i = 0 — its ψ̂ is exact.
    """
    n = host.n
    if n == 0:
        return np.zeros(0)
    g = np.zeros(n)
    h = np.zeros(n)
    contrib = host.inv_w[host.src_by_dst]
    np.add.at(g, host.dst_by_dst, contrib)
    np.maximum.at(h, host.dst_by_dst, contrib)
    return host.lam * np.minimum(g, h) / n


def apply_abs_M(host: HostOperators, v: np.ndarray
                ) -> tuple[np.ndarray, int]:
    """``M·v`` for non-negative ``v``, touching only supp(v)'s out-edges.

    Returns ``(Mv, edge_work)``; the cost is the out-degree sum of v's
    support — O(Δ-neighborhood) while the residual is local, one full
    mat-vec at worst.
    """
    idx = np.nonzero(v)[0]
    out = np.zeros(host.n)
    if idx.size == 0:
        return out, 0
    lo = np.searchsorted(host.src_by_src, idx, side="left")
    hi = np.searchsorted(host.src_by_src, idx, side="right")
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if total:
        offs = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts))
        eidx = np.repeat(lo, counts) + offs
        heads = host.dst_by_src[eidx]
        vals = np.repeat(v[idx] * _masked_inv(host.w[idx]), counts)
        np.add.at(out, heads, host.mu[heads] * vals)
    return out, total


def mass_weights(host: HostOperators) -> np.ndarray:
    """``β_j = (Σ_{i: j→i} μ_i)/w_j`` — the per-source ℓ₁ mass of ``M``.

    For ``v ≥ 0``, ``‖Mv‖₁ = Σ_i μ_i Σ_{j→i} v_j/w_j = Σ_j v_j β_j``: the
    ℓ₁ norm of a product with ``M`` is a support-sized dot product, no
    mat-vec required. O(m) to build once; cache it with the norms.
    """
    row_mu = np.zeros(host.n)
    np.add.at(row_mu, host.src_by_src, host.mu[host.dst_by_src])
    return row_mu * host.inv_w


CERT_TAIL_FRAC = 1e-3
"""Residual-mass fraction the certificate may bound at the worst-case rate.

The heavy entries of ``|r|`` carrying ``1 − CERT_TAIL_FRAC`` of its mass go
through the exact Neumann terms; the dust tail — often supported on most of
the graph while holding almost none of the mass — is charged
``α‖tail‖₁/(1 − α)`` wholesale. Inflates the bound by at most a factor
``1 + CERT_TAIL_FRAC·α/(1 − α)`` on the leading term while keeping each
certificate check local to the heavy support.
"""


def neumann_error_bound(host: HostOperators, r: np.ndarray, *,
                        alpha: float | None = None,
                        pernode: np.ndarray | None = None,
                        beta: np.ndarray | None = None
                        ) -> tuple[np.ndarray, int]:
    """Per-node confidence radii ``E`` with ``|ψ_exact − ψ̂|_i ≤ E_i``.

    The error iterate is ``δs = Σ_t M^t r``; instead of bounding the whole
    series by ``‖r‖₁/(1 − α)`` (α is a worst-case column sum — typically
    orders looser than the mass an actual push loses), the first two terms
    are computed *exactly* over the heavy part ``b`` of ``|r| = b + tail``
    and only the series tails pay the worst-case rate:

        ‖δs‖₁ ≤ ‖r‖₁ + ‖Mb‖₁ + ‖M²b‖₁/(1 − α) + α‖tail‖₁/(1 − α)

    (``M ≥ 0`` elementwise; ``tail`` is the :data:`CERT_TAIL_FRAC` dust).
    Cost: ONE ``M`` application restricted to the heavy support (returned
    as ``edge_work`` so callers account for the certificate the same as
    for pushes) — ``‖Mb‖₁`` and ``‖M²b‖₁ = ‖M(Mb)‖₁`` come from the ``β``
    dot product of :func:`mass_weights`, so no second mat-vec is ever
    paid. The tighter S is what lets a warm top-k query certify while the
    push is still confined to the dirty neighborhood.
    """
    alpha = a_norm(host) if alpha is None else float(alpha)
    if pernode is None:
        pernode = pernode_cert_scale(host)
    if beta is None:
        beta = mass_weights(host)
    if alpha >= 1.0:
        return np.full(host.n, math.inf), 0
    absr = np.abs(np.asarray(r, np.float64))
    t0 = float(absr.sum())
    if t0 == 0.0:
        return pernode * 0.0, 0
    order = np.argsort(absr)                       # dust first
    csum = np.cumsum(absr[order])
    cut = int(np.searchsorted(csum, CERT_TAIL_FRAC * t0, side="right"))
    tail_mass = float(csum[cut - 1]) if cut else 0.0
    big = absr.copy()
    big[order[:cut]] = 0.0
    m1, e1 = apply_abs_M(host, big)
    s_mass = (t0 + float(m1.sum()) + float((m1 * beta).sum()) / (1.0 - alpha)
              + alpha * tail_mass / (1.0 - alpha))
    return pernode * s_mass, e1


def psi_value(host: HostOperators, state: PushState) -> np.ndarray:
    """ψ̂ᵀ = (λ ⊙ p + dᵀ)/N from the maintained companion vector — O(N)."""
    _, d = host.cd()
    return (host.lam * state.p + d) / max(1, host.n)


def cold_state(host: HostOperators) -> PushState:
    """x = 0, r = c — the push form of Alg. 2's s₀ = c cold start."""
    c, _ = host.cd()
    n = host.n
    return PushState(x=np.zeros(n), r=c.astype(np.float64, copy=True),
                     p=np.zeros(n))


def reseed_state(host: HostOperators, x: np.ndarray) -> PushState:
    """Restart from an arbitrary node-order iterate (one host mat-vec).

    ``p = push(x)`` is rebuilt exactly, then ``r = c + μ ⊙ p − x`` restores
    the invariant — the honest warm start for a foreign ``s0``. The O(Δ)
    patch reseeds in :mod:`repro_torch.localpush.warm` avoid even this.
    """
    x = np.asarray(x, np.float64).reshape(-1)
    if x.shape != (host.n,):
        raise ValueError(f"s0 must be f[{host.n}] in node order; "
                         f"got {x.shape}")
    p = np.zeros(host.n)
    np.add.at(p, host.dst_by_dst, (x * host.inv_w)[host.src_by_dst])
    c, _ = host.cd()
    return PushState(x=x.copy(), r=c + host.mu * p - x, p=p)


# --------------------------------------------------------------------- #
# Vectorized frontier rounds (the engine's host hot path)
# --------------------------------------------------------------------- #
def push_nodes(host: HostOperators, state: PushState,
               nodes: np.ndarray) -> int:
    """Batched elementary push of ``nodes``; returns edge work (out-degree
    sum). Residuals are zeroed *before* the scatter, so mass a pushed node
    receives from a same-batch neighbour stays in ``r`` for a later round
    (the invariant holds per elementary operation and therefore per batch).
    """
    nodes = np.asarray(nodes, np.int64).reshape(-1)
    if nodes.size == 0:
        return 0
    rf = state.r[nodes].copy()
    state.r[nodes] = 0.0
    state.x[nodes] += rf
    lo = np.searchsorted(host.src_by_src, nodes, side="left")
    hi = np.searchsorted(host.src_by_src, nodes, side="right")
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if total:
        # gather each node's contiguous out-edge slice without a Python loop
        offs = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(counts) - counts, counts))
        eidx = np.repeat(lo, counts) + offs
        heads = host.dst_by_src[eidx]
        vals = np.repeat(rf * _masked_inv(host.w[nodes]), counts)
        np.add.at(state.p, heads, vals)
        np.add.at(state.r, heads, host.mu[heads] * vals)
    return total


def push_round(host: HostOperators, state: PushState, *,
               bucket_ratio: float = 0.5
               ) -> tuple[np.ndarray, int]:
    """One bucketed Gauss-Southwell round: push every node whose ``|r|``
    falls in the top magnitude bucket ``[bucket_ratio·max|r|, max|r|]``.

    Returns ``(nodes_pushed, edge_work)``. When residual is spread platform
    wide the bucket naturally widens to most nodes and the round degrades
    gracefully to a full residual sweep (a Jacobi iteration in push form) —
    the solver's own local-vs-global crossover, with no mode switch.
    """
    absr = np.abs(state.r)
    rmax = float(absr.max()) if absr.size else 0.0
    if rmax <= 0.0:
        return np.empty(0, np.int64), 0
    nodes = np.nonzero(absr >= rmax * bucket_ratio)[0]
    return nodes, push_nodes(host, state, nodes)


def push_until(host: HostOperators, state: PushState, *, tol_r: float,
               max_rounds: int = 100_000, bucket_ratio: float = 0.5
               ) -> tuple[int, int, int]:
    """Drive rounds until ``‖r‖₁ ≤ tol_r``; returns (rounds, pushes, edges)."""
    rounds = pushes = edges = 0
    while rounds < max_rounds and l1(state.r) > tol_r:
        nodes, ew = push_round(host, state, bucket_ratio=bucket_ratio)
        if nodes.size == 0:
            break
        rounds += 1
        pushes += int(nodes.size)
        edges += ew
    return rounds, pushes, edges


# --------------------------------------------------------------------- #
# Pure-Python bucket-queue oracle
# --------------------------------------------------------------------- #
def push_scalar(host: HostOperators, *, tol_r: float,
                state: PushState | None = None,
                max_pushes: int = 1_000_000) -> tuple[PushState, int, int]:
    """One-node-at-a-time Gauss-Southwell with a frexp bucket queue.

    Buckets are keyed by the binary exponent of ``|r_i|`` (power-of-two
    magnitude classes — the scalar analogue of :func:`push_round`'s
    ``bucket_ratio = 0.5`` band); entries are re-filed lazily on pop, so
    there is no heap and no decrease-key. This is the parity oracle the
    vectorized and device paths are tested against, not a hot path.

    Returns ``(state, pushes, edge_work)``.
    """
    if state is None:
        state = cold_state(host)
    x, r, p = state.x, state.r, state.p
    mu, w = host.mu, host.w
    sbs, dbs = host.src_by_src, host.dst_by_src

    def bkt(v: float) -> int:
        return math.frexp(v)[1]

    buckets: dict[int, list[int]] = {}
    for i in np.nonzero(r)[0]:
        buckets.setdefault(bkt(abs(float(r[i]))), []).append(int(i))
    norm = l1(r)
    pushes = edge_work = 0
    while norm > tol_r and buckets and pushes < max_pushes:
        k = max(buckets)
        lst = buckets[k]
        if not lst:
            del buckets[k]
            continue
        j = lst.pop()
        rj = float(r[j])
        if rj == 0.0:
            continue                       # stale entry, already absorbed
        kj = bkt(abs(rj))
        if kj != k:
            buckets.setdefault(kj, []).append(j)   # lazy re-file
            continue
        r[j] = 0.0
        x[j] += rj
        norm -= abs(rj)
        pushes += 1
        if w[j] > 0:
            contrib = rj / float(w[j])
            a = int(np.searchsorted(sbs, j, side="left"))
            b = int(np.searchsorted(sbs, j, side="right"))
            for e in range(a, b):
                i = int(dbs[e])
                old = float(r[i])
                new = old + float(mu[i]) * contrib
                r[i] = new
                p[i] += contrib
                norm += abs(new) - abs(old)
                if new != 0.0:
                    buckets.setdefault(bkt(abs(new)), []).append(i)
                edge_work += 1
    return state, pushes, edge_work


# --------------------------------------------------------------------- #
# Batched-frontier rounds on a torch device
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FrontierOps:
    """Device-resident padded out-edge table for the device push round.

    ``leaders[j]`` holds follower j's leader list padded with the sentinel
    ``n`` (one extra scatter slot absorbs pad traffic, the same trick as the
    kernels' sentinel edge slots); node vectors are in the engine dtype.
    """

    n: int
    dmax: int
    leaders: torch.Tensor   # i32[N, dmax] sentinel-padded with n
    deg: torch.Tensor       # i64[N]
    inv_w: torch.Tensor     # f[N]
    mu: torch.Tensor        # f[N]

    @property
    def device(self) -> torch.device:
        return self.inv_w.device


def build_frontier_ops(host: HostOperators, *, dtype: torch.dtype,
                       device: str | torch.device = "cuda") -> FrontierOps:
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    n = host.n
    lo = np.searchsorted(host.src_by_src, np.arange(n), side="left")
    hi = np.searchsorted(host.src_by_src, np.arange(n), side="right")
    deg = (hi - lo).astype(np.int64)
    dmax = int(max(1, deg.max())) if n else 1
    leaders = np.full((n, dmax), n, np.int32)
    total = int(deg.sum())
    if total:
        cols = (np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(deg) - deg, deg))
        leaders[np.repeat(np.arange(n), deg), cols] = host.dst_by_src
    return FrontierOps(
        n=n, dmax=dmax,
        leaders=torch.as_tensor(leaders, device=dev),
        deg=torch.as_tensor(deg, device=dev),
        inv_w=torch.tensor(host.inv_w.astype(np_dtype), device=dev),
        mu=torch.tensor(host.mu.astype(np_dtype), device=dev))


def make_frontier_loop(fops: FrontierOps, *, frontier_size: int):
    """Fixed-frontier push on the device: per round ``torch.topk(|r|, F)``
    picks the frontier, one padded gather + segment sum applies the batched
    push.

    Returns ``loop(x, r, p, tol_r, max_rounds) -> (x, r, p, rounds,
    edge_work)`` with ``rounds`` and ``edge_work`` Python ints. Zero-residual
    picks are masked (they push nothing), pad lanes land in the sentinel
    slot ``n`` which is dropped. The edge-work counter counts *real*
    out-edges of non-masked picks; the padded scatter itself costs F·dmax
    per round — the price of a fixed shape, charged to wall clock but not
    to the locality metric.

    The round's scatter sorts the F·dmax heads stably and sums each head's
    run with ``torch.segment_reduce``: a fixed order, no atomics, so the
    rounds and the bits repeat run to run on the card. The loop reads
    ``‖r‖₁ > tol_r`` on the host once a round (the JAX package's
    ``lax.while_loop`` condition).

    The caller re-derives ``r``/``p`` from ``x`` on the host in float64
    before certifying anything (device dtype may be f32); the loop's own
    ``tol_r`` check is only a steering heuristic, exactly like the async
    backend's unverified chunk gaps.
    """
    F = int(frontier_size)
    if not 1 <= F <= max(1, fops.n):
        raise ValueError(f"frontier_size must be in [1, {fops.n}]; got {F}")
    n, dmax = fops.n, fops.dmax

    def loop(x, r, p, tol_r, max_rounds):
        x, r, p = x.clone(), r.clone(), p.clone()
        tol_t = torch.as_tensor(tol_r, dtype=r.dtype, device=r.device)
        t = 0
        ew = torch.zeros((), dtype=torch.int64, device=r.device)
        while t < max_rounds and bool(torch.sum(torch.abs(r)) > tol_t):
            vals, nodes = torch.topk(torch.abs(r), F)
            live = vals > 0
            rf = torch.where(live, r[nodes], torch.zeros_like(vals))
            r[nodes] -= rf                     # zero the pushed residuals
            x[nodes] += rf                     # (topk indices are unique)
            contrib = rf * fops.inv_w[nodes]                    # [F]
            heads = fops.leaders[nodes].reshape(-1)             # [F·dmax]
            order = torch.argsort(heads, stable=True)
            sheet = contrib.repeat_interleave(dmax)[order]
            lengths = torch.bincount(heads, minlength=n + 1)
            delta = torch.segment_reduce(sheet, "sum", lengths=lengths,
                                         unsafe=True)[:n]
            p += delta
            r += fops.mu * delta
            ew += torch.sum(torch.where(live, fops.deg[nodes], 0))
            t += 1
        return x, r, p, t, int(ew)

    return loop
