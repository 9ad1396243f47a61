"""Directed-graph substrate.

Edge convention (matches the paper): an edge ``(j, i)`` means *user j follows
user i*; ``i`` is a **leader** of ``j`` and ``j`` is a **follower** of ``i``.
Arrays ``src`` hold the follower endpoint ``j`` and ``dst`` the leader
endpoint ``i``.

The ψ-score left mat-vec pushes mass along follow edges (src → dst), so the
canonical on-device layout is sorted-by-dst (CSC-like) which makes the
``segment_sum`` scatter sorted. A sorted-by-src (CSR-like) view is kept for
the right mat-vec used by the Power-NF baseline and for neighbour sampling.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

__all__ = ["Graph"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable directed graph held in host (numpy) memory.

    Attributes:
      n: number of nodes.
      src: int32[M] follower endpoint of each edge.
      dst: int32[M] leader endpoint of each edge.
      name: optional human-readable tag.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    name: str = "graph"

    def __post_init__(self):
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst length mismatch")
        for arr, tag in ((self.src, "src"), (self.dst, "dst")):
            if arr.size and (arr.min() < 0 or arr.max() >= self.n):
                raise ValueError(f"{tag} ids out of range [0, {self.n})")
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))

    # ------------------------------------------------------------------ #
    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @cached_property
    def out_degree(self) -> np.ndarray:
        """#leaders of each node (|L(j)|)."""
        return np.bincount(self.src, minlength=self.n).astype(np.int32)

    @cached_property
    def in_degree(self) -> np.ndarray:
        """#followers of each node."""
        return np.bincount(self.dst, minlength=self.n).astype(np.int32)

    # -- sorted views --------------------------------------------------- #
    @cached_property
    def _dst_order(self) -> np.ndarray:
        return np.argsort(self.dst, kind="stable")

    @cached_property
    def _src_order(self) -> np.ndarray:
        return np.argsort(self.src, kind="stable")

    @cached_property
    def edges_by_dst(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) with dst ascending — scatter-friendly for left matvec."""
        o = self._dst_order
        return self.src[o], self.dst[o]

    @cached_property
    def edges_by_src(self) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) with src ascending — for right matvec / sampling."""
        o = self._src_order
        return self.src[o], self.dst[o]

    @cached_property
    def csr_indptr(self) -> np.ndarray:
        """indptr over nodes for the by-src view (neighbour lists = leaders)."""
        return np.concatenate(
            [[0], np.cumsum(self.out_degree)]).astype(np.int64)

    @cached_property
    def csc_indptr(self) -> np.ndarray:
        """indptr over nodes for the by-dst view (neighbour lists = followers)."""
        return np.concatenate(
            [[0], np.cumsum(self.in_degree)]).astype(np.int64)

    def leaders_of(self, j: int) -> np.ndarray:
        s, d = self.edges_by_src
        lo, hi = self.csr_indptr[j], self.csr_indptr[j + 1]
        return d[lo:hi]

    def followers_of(self, i: int) -> np.ndarray:
        s, d = self.edges_by_dst
        lo, hi = self.csc_indptr[i], self.csc_indptr[i + 1]
        return s[lo:hi]

    # ------------------------------------------------------------------ #
    def dedup(self) -> "Graph":
        """Remove self-loops and duplicate edges (paper's model has neither)."""
        keep = self.src != self.dst
        src, dst = self.src[keep], self.dst[keep]
        key = src.astype(np.int64) * self.n + dst
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n, src[idx], dst[idx], name=self.name)

    def reverse(self) -> "Graph":
        return Graph(self.n, self.dst.copy(), self.src.copy(),
                     name=f"{self.name}-rev")

    def to_dense(self) -> np.ndarray:
        """Dense follower→leader adjacency L[j, i] = 1 iff j follows i."""
        a = np.zeros((self.n, self.n), np.float64)
        a[self.src, self.dst] = 1.0
        return a

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Graph({self.name!r}, n={self.n}, m={self.m})"
