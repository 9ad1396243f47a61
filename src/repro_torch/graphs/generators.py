"""Seeded synthetic graph generators.

The Konect datasets used by the paper are not available offline, so the
benchmark suite rebuilds *degree-matched stand-ins* with these generators
(see ``datasets.py``). All generators are vectorized numpy and comfortably
produce 10^8-edge graphs.
"""
from __future__ import annotations

import numpy as np

from .structure import Graph

__all__ = [
    "erdos_renyi", "barabasi_albert", "powerlaw_configuration", "rmat",
    "clustered_blocks",
]


def erdos_renyi(n: int, m: int, *, seed: int = 0, name: str = "er") -> Graph:
    """Directed G(n, m): m distinct uniform random edges, no self-loops."""
    rng = np.random.default_rng(seed)
    # oversample to survive dedup
    factor = 1.3
    src = dst = None
    while True:
        k = int(m * factor) + 16
        s = rng.integers(0, n, k, dtype=np.int64)
        d = rng.integers(0, n, k, dtype=np.int64)
        keep = s != d
        s, d = s[keep], d[keep]
        key = s * n + d
        _, idx = np.unique(key, return_index=True)
        if idx.size >= m:
            idx = idx[rng.permutation(idx.size)[:m]]
            src, dst = s[idx], d[idx]
            break
        factor *= 1.5
    return Graph(n, src.astype(np.int32), dst.astype(np.int32), name=name)


def _powerlaw_degrees(n: int, m: int, exponent: float,
                      rng: np.random.Generator, max_frac: float = 0.02
                      ) -> np.ndarray:
    """Integer degree sequence ~ Zipf(exponent) rescaled to sum ≈ m."""
    raw = rng.zipf(exponent, n).astype(np.float64)
    raw = np.minimum(raw, max(2.0, max_frac * n))
    deg = np.maximum(0, np.round(raw * (m / raw.sum()))).astype(np.int64)
    # fix the total exactly
    diff = m - int(deg.sum())
    if diff != 0:
        idx = rng.integers(0, n, abs(diff))
        np.add.at(deg, idx, 1 if diff > 0 else -1)
        deg = np.maximum(deg, 0)
        diff = m - int(deg.sum())
        if diff > 0:                       # leftover from clipping at 0
            idx = rng.integers(0, n, diff)
            np.add.at(deg, idx, 1)
    return deg


def powerlaw_configuration(n: int, m: int, *, exponent_out: float = 2.3,
                           exponent_in: float = 2.1, seed: int = 0,
                           name: str = "plconf") -> Graph:
    """Directed configuration model with heavy-tailed in/out degrees.

    Stub-matching: out-stubs and in-stubs are independently shuffled and
    paired; self-loops/multi-edges are dropped (standard erased configuration
    model), so the realized edge count is slightly below ``m`` — the dataset
    registry compensates by oversampling a few percent.
    """
    rng = np.random.default_rng(seed)
    dout = _powerlaw_degrees(n, m, exponent_out, rng)
    din = _powerlaw_degrees(n, m, exponent_in, rng)
    src = np.repeat(np.arange(n, dtype=np.int64), dout)
    dst = np.repeat(np.arange(n, dtype=np.int64), din)
    rng.shuffle(src)
    rng.shuffle(dst)
    k = min(src.size, dst.size)
    src, dst = src[:k], dst[:k]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph(n, src[idx].astype(np.int32), dst[idx].astype(np.int32),
                 name=name)


def barabasi_albert(n: int, m_per_node: int, *, seed: int = 0,
                    name: str = "ba") -> Graph:
    """Directed preferential attachment (new node follows m existing)."""
    rng = np.random.default_rng(seed)
    n0 = max(m_per_node, 2)
    src_l: list[np.ndarray] = [np.repeat(np.arange(1, n0), 1)]
    dst_l: list[np.ndarray] = [np.zeros(n0 - 1, np.int64)]
    targets = np.concatenate([np.arange(n0), np.zeros(n0 - 1, np.int64)])
    for v in range(n0, n):
        picks = targets[rng.integers(0, targets.size, m_per_node)]
        picks = np.unique(picks)
        src_l.append(np.full(picks.size, v, np.int64))
        dst_l.append(picks)
        targets = np.concatenate([targets, picks, np.full(picks.size, v)])
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    return Graph(n, src.astype(np.int32), dst.astype(np.int32), name=name)


def clustered_blocks(n: int, m: int, *, block: int = 128, p_in: float = 0.95,
                     seed: int = 0, name: str = "clustered") -> Graph:
    """Community-structured graph with id-aligned blocks of ``block`` nodes.

    A fraction ``p_in`` of edges falls inside a node's own block, the rest
    are uniform — the dense-diagonal regime where the BSR/MXU format's tile
    occupancy is high (the regime-autotuner's counterpoint to the
    hyper-sparse configuration models; see kernels/autotune.py).
    """
    rng = np.random.default_rng(seed)
    # feasibility: the retry loop below can only terminate if m distinct
    # edges exist under the block structure
    sizes = np.diff(np.append(np.arange(0, n, block), n))
    intra_cap = int((sizes * (sizes - 1)).sum())
    cap = intra_cap if p_in >= 1.0 else n * (n - 1)
    if m > cap:
        raise ValueError(f"m={m} exceeds the {cap} distinct edges possible "
                         f"for n={n}, block={block}, p_in={p_in}")
    factor = 1.3
    while True:
        k = int(m * factor) + 16
        src = rng.integers(0, n, k, dtype=np.int64)
        b0 = (src // block) * block
        bsize = np.minimum(block, n - b0)          # last block may be short
        intra = b0 + rng.integers(0, 1 << 30, k, dtype=np.int64) % bsize
        inter = rng.integers(0, n, k, dtype=np.int64)
        dst = np.where(rng.random(k) < p_in, intra, inter)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        if idx.size >= m:
            idx = idx[rng.permutation(idx.size)[:m]]
            return Graph(n, src[idx].astype(np.int32),
                         dst[idx].astype(np.int32), name=name)
        factor *= 1.5


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         name: str = "rmat") -> Graph:
    """R-MAT / Kronecker generator (Graph500 parameters by default).

    Produces the skewed, community-ish structure of real social graphs;
    used for the twitter-scale distributed dry-runs.
    """
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < ab) | (r >= abc)      # column bit
        go_down = r >= ab                                 # row bit
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    return Graph(n, src[idx].astype(np.int32), dst[idx].astype(np.int32),
                 name=name)
