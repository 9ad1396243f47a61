"""2-D edge-block partitioning for the distributed Power-ψ.

Mesh axes ("data", "model") ≡ (src rows, dst columns); multi-pod folds "pod"
into the src axis. Layouts (N padded to d·mo·q):

* **dst layout** — contiguous blocks: column c owns nodes [c·Nc, (c+1)·Nc),
  Nc = N_pad / mo. The local scatter of the push lands here.
* **src (block-cyclic) layout** — row r owns pieces {c·Nc + r·q .. +q} for all
  c; local index ℓ = c·q + j. Chosen so that a reduce-scatter over the src
  group (the ranks of one column, in row order) of the dst-layout result *is
  already* piece (r, c) of the src layout — the re-distribution between
  iterations becomes reduce-scatter + all-gather with zero index shuffling
  on device (SUMMA-style SpMV with block-cyclic vectors).

Edges are grouped host-side by (row, col), dst-sorted within the group (so
the device segment sum runs over sorted runs) and padded to the global max
block size with sentinels (src → local sentinel slot holding 0, dst → Nc,
a last segment that is dropped).

A copy of the JAX package's numpy-only module: the same graph gives the
same partition, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .structure import Graph

__all__ = ["Partition2D", "partition_2d"]


@dataclasses.dataclass(frozen=True)
class Partition2D:
    n: int
    n_pad: int
    d: int                  # src rows (pod × data for multi-pod)
    mo: int                 # dst columns
    q: int                  # piece length = n_pad / (d · mo)
    src_local: np.ndarray   # i32[d, mo, e_max]; sentinel = local_src_n
    dst_local: np.ndarray   # i32[d, mo, e_max]; sentinel = nc
    e_counts: np.ndarray    # i64[d, mo] true edge counts per block

    @property
    def nc(self) -> int:
        return self.mo and self.n_pad // self.mo

    @property
    def local_src_n(self) -> int:
        return self.mo * self.q

    @property
    def e_max(self) -> int:
        return int(self.src_local.shape[-1])

    @property
    def imbalance(self) -> float:
        """max/mean edges per device — straggler indicator."""
        mean = max(1.0, float(self.e_counts.mean()))
        return float(self.e_counts.max()) / mean

    # ----- layout converters (host side) ------------------------------- #
    def to_src_layout(self, vec: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """f[n] → f[d, mo·q] in the block-cyclic src layout."""
        v = self._pad(vec, fill)
        # node g = c*nc + r*q + j  →  (r, c*q + j)
        v3 = v.reshape(self.mo, self.d, self.q)       # [c, r, j]
        return np.ascontiguousarray(v3.transpose(1, 0, 2)
                                    ).reshape(self.d, self.mo * self.q)

    def to_piece_layout(self, vec: np.ndarray, fill: float = 0.0
                        ) -> np.ndarray:
        """f[n] → f[d, mo, q]: value of piece (r, c)."""
        v = self._pad(vec, fill)
        return np.ascontiguousarray(
            v.reshape(self.mo, self.d, self.q).transpose(1, 0, 2))

    def from_src_layout(self, arr: np.ndarray) -> np.ndarray:
        """f[d, mo·q] → f[n]."""
        v3 = np.asarray(arr).reshape(self.d, self.mo, self.q).transpose(1, 0, 2)
        return v3.reshape(self.n_pad)[: self.n]

    def _pad(self, vec: np.ndarray, fill: float) -> np.ndarray:
        out = np.full(self.n_pad, fill, vec.dtype)
        out[: self.n] = vec
        return out


def partition_2d(graph: Graph, d: int, mo: int, *,
                 lane_pad: int = 128) -> Partition2D:
    """Partition edges onto a d×mo logical device grid."""
    n = graph.n
    q = -(-n // (d * mo))
    n_pad = d * mo * q
    nc = n_pad // mo

    src, dst = graph.src.astype(np.int64), graph.dst.astype(np.int64)
    # src owner under the block-cyclic layout
    c_of_src = src // nc
    off = src - c_of_src * nc
    row = off // q
    src_loc = c_of_src * q + (off - row * q)
    # dst owner under the contiguous layout
    col = dst // nc
    dst_loc = dst - col * nc

    dev = row * mo + col
    order = np.lexsort((dst_loc, dev))                # device-major, dst-sorted
    dev_s, src_s, dst_s = dev[order], src_loc[order], dst_loc[order]
    counts = np.bincount(dev_s, minlength=d * mo).reshape(d, mo)
    e_max = max(int(counts.max()), 1)
    e_max = -(-e_max // lane_pad) * lane_pad          # lane-align blocks

    flat_src = np.full((d * mo, e_max), mo * q, np.int32)   # sentinel
    flat_dst = np.full((d * mo, e_max), nc, np.int32)       # sentinel
    starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))])[:-1]
    pos = np.arange(dev_s.size) - starts[dev_s]
    flat_src[dev_s, pos] = src_s
    flat_dst[dev_s, pos] = dst_s

    return Partition2D(n=n, n_pad=n_pad, d=d, mo=mo, q=q,
                       src_local=flat_src.reshape(d, mo, e_max),
                       dst_local=flat_dst.reshape(d, mo, e_max),
                       e_counts=counts)
