"""O(Δ) residual reseeding — warm restarts that never pay a mat-vec.

A converged push state (x, r≈0, p) plus a platform patch is *almost* a
valid state for the new operators: ``x`` is still a fine iterate, but the
invariant ``r = c + μ ⊙ p − x`` now refers to the patched (c, μ, w, E).
Each helper here applies the corresponding :class:`HostOperators` patch
AND repairs ``(r, p)`` exactly, touching only the affected subgraph:

* activity patch on users U — ``w`` changes at U's followers F, so
  ``p`` changes at the leaders reachable from F (``Δp_i = Σ_f x_f·Δ(1/w_f)``
  over F's out-edges) and ``r`` changes where ``c``, ``μ·p`` moved:
  ``r += Δc + Δ(μ ⊙ p)`` over ``U ∪ heads(F)``.
* edge insert/remove at followers J — retract J's old out-edge
  contributions ``x_j/w_j^old`` and scatter the new ones ``x_j/w_j^new``
  (``c``/``μ`` are untouched, so ``Δr = μ ⊙ Δp``).

Cost: O(Δ · deg) edge work + O(|affected|) vector work — this is the
"resolve after a flash crowd touches the affected subgraph only" path the
streaming ingestor drains the rate estimator's dirty sets into. All
arithmetic is float64 on the host mirror, so repeated patches do not
erode the certificate (see the precision note in
:mod:`repro_torch.localpush.push`).
"""
from __future__ import annotations

import numpy as np

from ..core.operators import HostOperators, _concat_ranges
from .push import PushState, _masked_inv

__all__ = ["apply_activity_patch", "apply_edge_insert", "apply_edge_remove"]


def _out_edges(host: HostOperators,
               nodes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(heads, counts): concatenated leader lists of ``nodes`` (src-sorted
    spans), copied out so they survive a subsequent edge mutation."""
    lo = np.searchsorted(host.src_by_src, nodes, side="left")
    hi = np.searchsorted(host.src_by_src, nodes, side="right")
    counts = (hi - lo).astype(np.int64)
    return host.dst_by_src[_concat_ranges(lo, hi)].copy(), counts


def _c_at(host: HostOperators, idx: np.ndarray) -> np.ndarray:
    total = host.lam[idx] + host.mu[idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(total > 0, host.mu[idx] / total, 0.0)


def _scatter(host: HostOperators, state: PushState,
             heads: np.ndarray, vals: np.ndarray) -> None:
    """Δp at ``heads`` plus the induced Δr = μ ⊙ Δp (duplicate-safe)."""
    if heads.size:
        np.add.at(state.p, heads, vals)
        np.add.at(state.r, heads, host.mu[heads] * vals)


def apply_activity_patch(host: HostOperators, state: PushState, users,
                         lam=None, mu=None) -> int:
    """``host.patch_activity`` + exact (r, p) repair; returns edges touched."""
    uniq = np.unique(np.asarray(users, np.int64).reshape(-1))
    if uniq.size == 0:
        return 0
    # followers of the updated users: contiguous dst-sorted slices
    lo = np.searchsorted(host.dst_by_dst, uniq, side="left")
    hi = np.searchsorted(host.dst_by_dst, uniq, side="right")
    followers = np.unique(host.src_by_dst[_concat_ranges(lo, hi)])
    # activity patches never move edges, so F's out-spans are stable across
    # the patch — snapshot only the reciprocals that will change
    heads, counts = _out_edges(host, followers)
    old_inv = _masked_inv(host.w[followers])
    affected = np.unique(np.concatenate([uniq, heads])) if heads.size else uniq
    old_c = _c_at(host, affected)
    old_mu_p = host.mu[affected] * state.p[affected]

    touched = host.patch_activity(users, lam=lam, mu=mu)

    if heads.size:
        dinv = _masked_inv(host.w[followers]) - old_inv
        np.add.at(state.p, heads, np.repeat(state.x[followers] * dinv,
                                            counts))
    state.r[affected] += ((_c_at(host, affected) - old_c)
                          + host.mu[affected] * state.p[affected] - old_mu_p)
    return touched


def apply_edge_insert(host: HostOperators, state: PushState, src, dst
                      ) -> tuple[np.ndarray, np.ndarray]:
    """``host.patch_edges`` + exact (r, p) repair; returns edges inserted."""
    src_k, dst_k = host.filter_new_edges(src, dst)
    if src_k.size == 0:
        return src_k, dst_k
    J = np.unique(src_k).astype(np.int64)
    old_heads, old_counts = _out_edges(host, J)
    old_inv = _masked_inv(host.w[J])

    host.insert_filtered(src_k, dst_k)

    new_heads, new_counts = _out_edges(host, J)
    new_inv = _masked_inv(host.w[J])
    xj = state.x[J]
    # retract j's contributions at the old weight, emit at the new one
    _scatter(host, state, old_heads, np.repeat(-xj * old_inv, old_counts))
    _scatter(host, state, new_heads, np.repeat(xj * new_inv, new_counts))
    return src_k, dst_k


def apply_edge_remove(host: HostOperators, state: PushState, src, dst
                      ) -> tuple[np.ndarray, np.ndarray]:
    """``host.remove_edges`` + exact (r, p) repair; returns edges removed."""
    cand = np.unique(np.asarray(src, np.int64).reshape(-1))
    if cand.size == 0:
        return (np.empty(0, np.int32),) * 2
    # tombstones may miss; snapshot every candidate's span, filter later
    cand_heads, cand_counts = _out_edges(host, cand)
    cand_inv = _masked_inv(host.w[cand])

    rem_src, rem_dst = host.remove_edges(src, dst)
    if rem_src.size == 0:
        return rem_src, rem_dst

    hit = np.isin(cand, np.unique(rem_src))
    row = np.repeat(np.arange(cand.size), cand_counts)
    keep = hit[row]
    # only actually-shrunk followers scatter: a float retract-and-re-emit
    # of an untouched span would not cancel bitwise and would erode r
    _scatter(host, state, cand_heads[keep],
             (np.repeat(state.x[cand] * -cand_inv, cand_counts))[keep])
    J = cand[hit]
    new_heads, new_counts = _out_edges(host, J)
    _scatter(host, state, new_heads,
             np.repeat(state.x[J] * _masked_inv(host.w[J]), new_counts))
    return rem_src, rem_dst
