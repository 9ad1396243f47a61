"""Edge-form ψ-score operators.

All four matrices of the paper (Table I) are functions of the edge list and
the activity rates, and every product the algorithms need reduces to one
gather → segment-sum → scale pattern:

    w_j       = Σ_{ℓ∈L(j)} (λ_ℓ + μ_ℓ)                    (news-feed rate)
    A[j, i]   = μ_i / w_j   · 1{i ∈ L(j)}
    B[j, i]   = λ_i / w_j   · 1{i ∈ L(j)}
    c_i       = μ_i / (λ_i + μ_i)
    d_i       = λ_i / (λ_i + μ_i)

Left mat-vec (Power-ψ):   (sᵀA)_i = μ_i Σ_{(j→i)∈E} s_j / w_j
Right mat-vec (Power-NF): (A p)_j = (1/w_j) Σ_{(j→i)∈E} μ_i p_i

The device operators keep the edge list twice, each sorted by its scatter
axis, so both products are a segmented sum over sorted runs
(``torch.segment_reduce`` with ``lengths = in_degree`` for the push,
``lengths = out_degree`` for the right mat-vec). That sum has a fixed order
on every device: no atomics, so the f32 iteration is a deterministic map and
can land on an exact fixed point (gap 0) the way the host reference does,
and two runs on the card give the same bits.

Nodes with no leaders (w_j = 0) have empty A/B rows — handled by a masked
reciprocal, exactly matching the linear-system semantics of the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from .activity import Activity

__all__ = ["PsiOperators", "LaneOperators", "build_operators",
           "HostOperators", "dense_operators"]


@dataclasses.dataclass(frozen=True)
class PsiOperators:
    """Device-resident edge-form operators for one (graph, activity) pair."""

    n: int
    m: int
    src_by_dst: torch.Tensor  # i64[M] follower endpoint, edges sorted by dst
    dst_by_dst: torch.Tensor  # i64[M] leader endpoint (ascending)
    in_degree: torch.Tensor   # i64[N] segment lengths of the dst-sorted view
    src_by_src: torch.Tensor  # i64[M] follower endpoint (ascending)
    dst_by_src: torch.Tensor  # i64[M] leader endpoint, edges sorted by src
    out_degree: torch.Tensor  # i64[N] segment lengths of the src-sorted view
    lam: torch.Tensor         # f[N]
    mu: torch.Tensor          # f[N]
    inv_w: torch.Tensor       # f[N], 0 where w == 0
    c: torch.Tensor           # f[N] = μ/(λ+μ)
    d: torch.Tensor           # f[N] = λ/(λ+μ)
    b_norm: torch.Tensor      # 0-dim ‖B‖ used by Alg. 2's termination rule

    @property
    def dtype(self) -> torch.dtype:
        return self.lam.dtype

    @property
    def device(self) -> torch.device:
        return self.lam.device

    def push(self, s: torch.Tensor) -> torch.Tensor:
        """Shared left gather/scatter: t_i = Σ_{(j→i)} s_j / w_j.

        ``sᵀA = μ ⊙ t`` and ``sᵀB = λ ⊙ t`` — one scatter serves both.
        """
        contrib = (s * self.inv_w)[self.src_by_dst]
        return torch.segment_reduce(contrib, "sum", lengths=self.in_degree,
                                    unsafe=True)

    def left_matvec(self, s: torch.Tensor) -> torch.Tensor:
        """sᵀA as a column vector."""
        return self.mu * self.push(s)

    def psi_epilogue(self, s: torch.Tensor) -> torch.Tensor:
        """ψᵀ = (sᵀB + dᵀ)/N  (Eq. 12 epilogue)."""
        return (self.lam * self.push(s) + self.d) / self.n

    def right_matvec(self, p: torch.Tensor) -> torch.Tensor:
        """A p — used by the Power-NF baseline. Supports batched p [N, K]."""
        col = (slice(None),) + (None,) * (p.dim() - 1)   # node axis first
        vals = (self.mu[col] * p)[self.dst_by_src]
        agg = torch.segment_reduce(vals, "sum", lengths=self.out_degree,
                                   unsafe=True)
        return self.inv_w[col] * agg

    def b_columns(self, origins: torch.Tensor) -> torch.Tensor:
        """Dense [N, K] slice of B for a chunk of origin users (Power-NF)."""
        # edge (j -> i): b[j, col] = λ_i / w_j where i == origins[col]
        hit = self.dst_by_src[:, None] == origins[None, :]        # [M, K]
        vals = torch.where(hit, self.lam[self.dst_by_src][:, None], 0.0)
        agg = torch.segment_reduce(vals, "sum", lengths=self.out_degree,
                                   unsafe=True)                    # [N, K]
        return self.inv_w[:, None] * agg


@dataclasses.dataclass(frozen=True)
class LaneOperators:
    """The edge-form operators of ``L`` same-shape lanes (the fleet's
    ``reference`` regime), stacked along a leading lane axis.

    Every lane holds ``n`` nodes (its real ones, then zero-rate pad nodes)
    and ``e`` edge slots, dst-sorted, whose unused tail points at the
    sentinel ``dst == n`` (source 0). The push flattens the lanes into one
    fixed-order segment sum: lane ℓ's node i is segment ℓ·(n+1) + i, and
    segment ℓ·(n+1) + n collects the lane's sentinel slots and is dropped.
    It holds what the step reads (1/w, μ, c); the ψ epilogue's λ and d
    stay with the caller.
    """

    n: int
    src: torch.Tensor         # i64[L, e] follower endpoint, dst-sorted
    lengths: torch.Tensor     # i64[L·(n+1)] segment lengths (sentinel last)
    inv_w: torch.Tensor       # f[L, n]
    mu: torch.Tensor          # f[L, n]
    c: torch.Tensor           # f[L, n]

    @staticmethod
    def segment_lengths(dst: np.ndarray, n: int) -> np.ndarray:
        """i64[L·(n+1)]: the counts of each lane's dst ids 0..n (n is the
        sentinel) from the stacked i32[L, e] dst-sorted dst view."""
        dst = np.asarray(dst, np.int64)
        lane = np.arange(dst.shape[0])[:, None] * (n + 1)
        return np.bincount((dst + lane).reshape(-1),
                           minlength=dst.shape[0] * (n + 1))

    def push(self, s: torch.Tensor) -> torch.Tensor:
        """t[ℓ, i] = Σ_{(j→i) in lane ℓ} s[ℓ, j] / w[ℓ, j], f[L, n]."""
        lanes = s.shape[0]
        contrib = torch.gather(s * self.inv_w, 1, self.src)
        t = torch.segment_reduce(contrib.reshape(-1), "sum",
                                 lengths=self.lengths, unsafe=True)
        return t.reshape(lanes, self.n + 1)[:, :self.n]


def _induced_l1T_norm(n, src, dst, lam, inv_w) -> np.ndarray:
    """max_j Σ_{i∈L(j)} λ_i / w_j — the operator norm with ‖sᵀB‖₁ ≤ ‖B‖‖s‖₁."""
    row = np.zeros(n, lam.dtype)
    np.add.at(row, src, lam[dst])
    return (row * inv_w).max() if n else np.asarray(0.0, lam.dtype)


def _edge_tensors(n: int, src_by_dst: np.ndarray, dst_by_dst: np.ndarray,
                  src_by_src: np.ndarray, dst_by_src: np.ndarray,
                  device: torch.device) -> dict:
    """Both sorted edge views and their segment lengths, on ``device``."""
    def idx(x):
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)

    return dict(
        src_by_dst=idx(src_by_dst), dst_by_dst=idx(dst_by_dst),
        in_degree=idx(np.bincount(dst_by_dst, minlength=n)),
        src_by_src=idx(src_by_src), dst_by_src=idx(dst_by_src),
        out_degree=idx(np.bincount(src_by_src, minlength=n)))


def build_operators(graph: Graph, activity: Activity, *,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda") -> PsiOperators:
    """Precompute the edge-form operators on host, then place on ``device``."""
    if activity.n != graph.n:
        raise ValueError("activity/graph size mismatch")
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    lam = activity.lam.astype(np_dtype)
    mu = activity.mu.astype(np_dtype)
    total = lam + mu
    # w_j = Σ_{leaders i of j} (λ_i + μ_i): scatter (λ+μ)[dst] onto src
    w = np.zeros(graph.n, np_dtype)
    np.add.at(w, graph.src, total[graph.dst])
    inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0).astype(np_dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(total > 0, mu / total, 0.0).astype(np_dtype)
        d = np.where(total > 0, lam / total, 0.0).astype(np_dtype)
    b_norm = _induced_l1T_norm(graph.n, graph.src, graph.dst, lam, inv_w)

    def vec(x):
        return torch.tensor(np.asarray(x, np_dtype), device=dev)

    return PsiOperators(
        n=graph.n, m=graph.m,
        **_edge_tensors(graph.n, *graph.edges_by_dst, *graph.edges_by_src,
                        dev),
        lam=vec(lam), mu=vec(mu), inv_w=vec(inv_w), c=vec(c), d=vec(d),
        b_norm=vec(b_norm))


# ---------------------------------------------------------------------- #
# Mutable host mirror — O(Δ) incremental patches for the serving runtime.
# ---------------------------------------------------------------------- #
def _concat_ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    if lo.size == 0:
        return np.empty(0, np.int64)
    return np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)])


def _validate_rates(lam: np.ndarray | None, mu: np.ndarray | None) -> None:
    """Reject NaN/Inf and negative rates at the mutation boundary.

    The ``Activity`` constructor validates full vectors at build time, but
    incremental patches bypass it — a single poisoned λ would silently
    corrupt the w/row_lam accumulators of every follower it touches (and a
    NaN never washes out of an incremental sum). Raise *before* any state
    is mutated so a rejected patch leaves the operators untouched.
    """
    for name, arr in (("lam", lam), ("mu", mu)):
        if arr is None:
            continue
        arr = np.asarray(arr)
        if not np.all(np.isfinite(arr)):
            raise ValueError(
                f"non-finite {name} in activity patch "
                f"(offending values include "
                f"{arr[~np.isfinite(arr)][:3].tolist()})")
        if np.any(arr < 0):
            raise ValueError(
                f"negative {name} in activity patch (rates are event "
                f"intensities ≥ 0; offending values include "
                f"{arr[arr < 0][:3].tolist()})")


def _dedup_keep_last(users: np.ndarray, *cols: np.ndarray):
    """Unique users, keeping the *last* occurrence of each (update semantics)."""
    rev = users[::-1]
    uniq, first_rev = np.unique(rev, return_index=True)
    out_cols = tuple(None if c is None else np.asarray(c)[::-1][first_rev]
                     for c in cols)
    return uniq, out_cols


@dataclasses.dataclass
class HostOperators:
    """Host-side (float64, numpy) mirror of the edge-form operator arrays.

    Unlike :func:`build_operators` this state is *mutable* and supports
    incremental patches that cost O(Δ) edge work plus O(N) vector work —
    no edge re-sort, no full reconstruction:

      * :meth:`patch_activity` — λ/μ updates touch only the followers of the
        updated users (``w``/``row_lam`` scatter over those edges).
      * :meth:`patch_edges` — new follow edges are merged into the two sorted
        edge views with ``np.searchsorted`` + ``np.insert`` (one memmove, no
        re-sort of the M existing edges).
      * :meth:`remove_edges` — unfollow tombstones delete from both sorted
        views; touched followers' ``w``/``row_lam`` are recomputed exactly
        (a follower losing its last leader must hit w = 0, not a residue).

    ``to_device`` materializes a fresh :class:`PsiOperators` from the current
    arrays; the float64 host accumulators keep repeated incremental patches
    free of drift before the cast to the device dtype.
    """

    n: int
    lam: np.ndarray          # f64[N]
    mu: np.ndarray           # f64[N]
    src_by_dst: np.ndarray   # i32[M] — dst-sorted view
    dst_by_dst: np.ndarray   # i32[M]
    src_by_src: np.ndarray   # i32[M] — src-sorted view
    dst_by_src: np.ndarray   # i32[M]
    w: np.ndarray            # f64[N] news-feed rates
    row_lam: np.ndarray      # f64[N] Σ_{i∈L(j)} λ_i (the ‖B‖ numerator)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_graph(cls, graph: Graph, activity: Activity) -> "HostOperators":
        if activity.n != graph.n:
            raise ValueError("activity/graph size mismatch")
        lam = activity.lam.astype(np.float64).copy()
        mu = activity.mu.astype(np.float64).copy()
        total = lam + mu
        w = np.zeros(graph.n)
        np.add.at(w, graph.src, total[graph.dst])
        row_lam = np.zeros(graph.n)
        np.add.at(row_lam, graph.src, lam[graph.dst])
        s_d, d_d = graph.edges_by_dst
        s_s, d_s = graph.edges_by_src
        return cls(n=graph.n, lam=lam, mu=mu,
                   src_by_dst=s_d.copy(), dst_by_dst=d_d.copy(),
                   src_by_src=s_s.copy(), dst_by_src=d_s.copy(),
                   w=w, row_lam=row_lam)

    @property
    def m(self) -> int:
        return int(self.src_by_dst.shape[0])

    @property
    def inv_w(self) -> np.ndarray:
        return np.where(self.w > 0, 1.0 / np.where(self.w > 0, self.w, 1.0),
                        0.0)

    @property
    def b_norm(self) -> float:
        return float((self.row_lam * self.inv_w).max()) if self.n else 0.0

    def activity(self) -> Activity:
        return Activity(self.lam.copy(), self.mu.copy())

    def cd(self) -> tuple[np.ndarray, np.ndarray]:
        """The paper's c = μ/(λ+μ), d = λ/(λ+μ) with silent-user masking —
        the one place the zero-total reciprocal rule lives."""
        total = self.lam + self.mu
        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.where(total > 0, self.mu / total, 0.0)
            d = np.where(total > 0, self.lam / total, 0.0)
        return c, d

    def graph(self) -> Graph:
        """Rebuild a Graph view (src-sorted order, already deduped)."""
        return Graph(self.n, self.src_by_src.copy(), self.dst_by_src.copy())

    # ------------------------------------------------------------------ #
    def patch_activity(self, users: np.ndarray, lam: np.ndarray | None = None,
                       mu: np.ndarray | None = None) -> int:
        """Apply λ/μ updates; returns the number of edges touched (Δ)."""
        users = np.asarray(users, np.int64).reshape(-1)
        if lam is not None:     # scalars / length-1 broadcast over users
            lam = np.broadcast_to(np.asarray(lam, np.float64), users.shape)
        if mu is not None:
            mu = np.broadcast_to(np.asarray(mu, np.float64), users.shape)
        users, (lam, mu) = _dedup_keep_last(users, lam, mu)
        _validate_rates(lam, mu)
        new_lam = self.lam[users] if lam is None else lam
        new_mu = self.mu[users] if mu is None else mu
        dl = new_lam - self.lam[users]
        dt = dl + (new_mu - self.mu[users])
        self.lam[users] = new_lam
        self.mu[users] = new_mu
        # followers of each updated user form a contiguous dst-sorted slice
        lo = np.searchsorted(self.dst_by_dst, users, side="left")
        hi = np.searchsorted(self.dst_by_dst, users, side="right")
        idx = _concat_ranges(lo, hi)
        counts = hi - lo
        fol = self.src_by_dst[idx]
        np.add.at(self.w, fol, np.repeat(dt, counts))
        np.add.at(self.row_lam, fol, np.repeat(dl, counts))
        return int(counts.sum())

    def filter_new_edges(self, src: np.ndarray,
                         dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The edges :meth:`patch_edges` would actually insert — self-loops
        and duplicates (in-batch or vs existing) dropped — *without*
        mutating anything."""
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        key = src.astype(np.int64) * self.n + dst
        _, uniq_idx = np.unique(key, return_index=True)
        src, dst = src[uniq_idx], dst[uniq_idx]
        fresh = np.ones(src.size, bool)
        for k, (s, d) in enumerate(zip(src, dst)):     # Δ is small in serving
            a = np.searchsorted(self.src_by_src, s, side="left")
            b = np.searchsorted(self.src_by_src, s, side="right")
            if np.any(self.dst_by_src[a:b] == d):
                fresh[k] = False
        return src[fresh], dst[fresh]

    def patch_edges(self, src: np.ndarray,
                    dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Merge new follow edges; returns the (src, dst) actually inserted
        (self-loops and duplicates — in-batch or vs existing — are dropped)."""
        src, dst = self.filter_new_edges(src, dst)
        return self.insert_filtered(src, dst)

    def insert_filtered(self, src: np.ndarray,
                        dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Commit edges that already passed :meth:`filter_new_edges`."""
        if src.size == 0:
            return src, dst
        # merge into the dst-sorted view
        o = np.argsort(dst, kind="stable")
        ins = np.searchsorted(self.dst_by_dst, dst[o], side="right")
        self.src_by_dst = np.insert(self.src_by_dst, ins, src[o])
        self.dst_by_dst = np.insert(self.dst_by_dst, ins, dst[o])
        # merge into the src-sorted view
        o2 = np.argsort(src, kind="stable")
        ins2 = np.searchsorted(self.src_by_src, src[o2], side="right")
        self.src_by_src = np.insert(self.src_by_src, ins2, src[o2])
        self.dst_by_src = np.insert(self.dst_by_src, ins2, dst[o2])
        # rate accumulators: each new edge (j → i) adds i's rates to j's feed
        np.add.at(self.w, src, self.lam[dst] + self.mu[dst])
        np.add.at(self.row_lam, src, self.lam[dst])
        return src, dst

    def remove_edges(self, src: np.ndarray,
                     dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Delete existing follow edges; returns the (src, dst) actually
        removed (pairs not present are ignored).

        O(Δ·log M) searches plus one memmove per sorted view. The touched
        followers' ``w`` / ``row_lam`` accumulators are *recomputed* from
        their remaining leader lists rather than decremented: a follower
        whose last leader disappears must land on w = 0 **exactly**.
        """
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        if src.size:
            key = src.astype(np.int64) * self.n + dst
            _, uniq = np.unique(key, return_index=True)
            src, dst = src[uniq], dst[uniq]
        hit_s: list[int] = []
        hit = np.zeros(src.size, bool)
        for k, (s, d) in enumerate(zip(src, dst)):   # Δ is small in serving
            a = np.searchsorted(self.src_by_src, s, side="left")
            b = np.searchsorted(self.src_by_src, s, side="right")
            j = np.nonzero(self.dst_by_src[a:b] == d)[0]
            if j.size:
                hit_s.append(int(a + j[0]))
                hit[k] = True
        src, dst = src[hit], dst[hit]
        if src.size == 0:
            return src, dst
        hit_d: list[int] = []
        for s, d in zip(src, dst):
            a = np.searchsorted(self.dst_by_dst, d, side="left")
            b = np.searchsorted(self.dst_by_dst, d, side="right")
            j = np.nonzero(self.src_by_dst[a:b] == s)[0]
            hit_d.append(int(a + j[0]))
        self.src_by_src = np.delete(self.src_by_src, hit_s)
        self.dst_by_src = np.delete(self.dst_by_src, hit_s)
        self.src_by_dst = np.delete(self.src_by_dst, hit_d)
        self.dst_by_dst = np.delete(self.dst_by_dst, hit_d)
        for j in np.unique(src):
            a = np.searchsorted(self.src_by_src, j, side="left")
            b = np.searchsorted(self.src_by_src, j, side="right")
            leaders = self.dst_by_src[a:b]
            self.w[j] = float((self.lam[leaders] + self.mu[leaders]).sum())
            self.row_lam[j] = float(self.lam[leaders].sum())
        return src, dst

    # ------------------------------------------------------------------ #
    def _node_arrays(self, dtype: torch.dtype, device: torch.device) -> dict:
        """The O(N) activity-derived device vectors (not the edge indices)."""
        np_dtype = numpy_dtype(dtype)
        c, d = self.cd()

        def vec(x):     # torch.tensor copies: the host arrays keep mutating
            return torch.tensor(np.asarray(x, np_dtype), device=device)

        return dict(lam=vec(self.lam), mu=vec(self.mu), inv_w=vec(self.inv_w),
                    c=vec(c), d=vec(d), b_norm=vec(self.b_norm))

    def to_device(self, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cuda") -> PsiOperators:
        dev = resolve_device(device)
        return PsiOperators(
            n=self.n, m=self.m,
            **_edge_tensors(self.n, self.src_by_dst, self.dst_by_dst,
                            self.src_by_src, self.dst_by_src, dev),
            **self._node_arrays(dtype, dev))

    def refresh_node_arrays(self, ops: PsiOperators,
                            dtype: torch.dtype = torch.float32) -> PsiOperators:
        """Post-``patch_activity`` refresh: re-upload only the O(N) node
        vectors, reusing the device-resident O(M) edge indices (an activity
        patch never touches them)."""
        return dataclasses.replace(ops, **self._node_arrays(dtype, ops.device))


# ---------------------------------------------------------------------- #
# Dense forms — oracles for tests (small N only).
# ---------------------------------------------------------------------- #
def dense_operators(graph: Graph, activity: Activity):
    """Return (A, B, c, d) as dense float64 numpy arrays."""
    n = graph.n
    lam = activity.lam.astype(np.float64)
    mu = activity.mu.astype(np.float64)
    total = lam + mu
    w = np.zeros(n)
    np.add.at(w, graph.src, total[graph.dst])
    inv_w = np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)
    A = np.zeros((n, n))
    B = np.zeros((n, n))
    A[graph.src, graph.dst] = mu[graph.dst] * inv_w[graph.src]
    B[graph.src, graph.dst] = lam[graph.dst] * inv_w[graph.src]
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(total > 0, mu / total, 0.0)
        d = np.where(total > 0, lam / total, 0.0)
    return A, B, c, d
