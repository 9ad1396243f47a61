"""Host-side sparse formats feeding the CUDA kernels.

A copy of the JAX package's two blocked layouts, bit for bit, so both
packages' kernels consume identical arrays:

* **Edge-tile format** (``EdgeTileFormat``) — edges sorted by destination and
  grouped so every block of ``eblk`` edges scatters into a single output node
  tile of ``tile`` nodes; unused slots hold the sentinel source ``n``. The
  ``power_step`` kernel runs one CTA per node tile over that tile's block
  range (``tile_first_block`` / ``tile_num_blocks``).

* **BSR format** (``BsrFormat``) — A is cut into dense ``ts × td`` tiles and
  only non-empty tiles are materialized, in dst-major order. The
  ``bsr_spmv`` kernel runs one CTA per dst tile over that tile's block range
  (``dst_first_block`` / ``dst_num_blocks``). Wins only when the graph is
  clustered enough for decent tile occupancy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graphs.structure import Graph

__all__ = ["EdgeTileFormat", "BsrFormat", "build_edge_tiles", "build_bsr",
           "pad_edge_tile_blocks", "block_ranges"]


def block_ranges(block_tile: np.ndarray,
                 num_tiles: int) -> tuple[np.ndarray, np.ndarray]:
    """(first block, block count) of every tile, from the per-block tile ids.

    Both formats list blocks in ascending tile order, so each tile owns one
    contiguous run of blocks. The ranges come from ``block_tile`` itself,
    never from the first/last flags: ``pad_edge_tile_blocks`` appends pad
    blocks to the last tile and moves its ``block_last`` flag.
    """
    block_tile = np.asarray(block_tile)
    if block_tile.size and np.any(np.diff(block_tile) < 0):
        raise ValueError("blocks must be listed in ascending tile order")
    first = np.searchsorted(block_tile, np.arange(num_tiles)).astype(np.int32)
    count = np.bincount(block_tile, minlength=num_tiles).astype(np.int32)
    return first, count


@dataclasses.dataclass(frozen=True)
class EdgeTileFormat:
    n: int                   # logical node count
    n_pad: int               # padded node count (multiple of tile, > n)
    tile: int                # output nodes per tile
    e1: int                  # edge-block sublane dim
    e2: int                  # edge-block lane dim
    src_idx: np.ndarray      # i32[num_blocks, e1, e2] — gather index (sentinel n)
    dst_local: np.ndarray    # i32[num_blocks, e1, e2] — dst − tile_base
    block_tile: np.ndarray   # i32[num_blocks] — output tile of each block
    block_first: np.ndarray  # i32[num_blocks] — 1 on a tile's first block
    block_last: np.ndarray   # i32[num_blocks] — 1 on a tile's last block
    num_tiles: int

    @property
    def num_blocks(self) -> int:
        return int(self.src_idx.shape[0])

    @property
    def eblk(self) -> int:
        return self.e1 * self.e2

    @property
    def tile_first_block(self) -> np.ndarray:
        return block_ranges(self.block_tile, self.num_tiles)[0]

    @property
    def tile_num_blocks(self) -> np.ndarray:
        return block_ranges(self.block_tile, self.num_tiles)[1]


def build_edge_tiles(graph: Graph, *, tile: int = 256, e1: int = 8,
                     e2: int = 128) -> EdgeTileFormat:
    """Blocked, dst-sorted edge layout (see module docstring)."""
    eblk = e1 * e2
    n = graph.n
    num_tiles = max(1, -(-n // tile))
    n_pad = num_tiles * tile
    src, dst = graph.edges_by_dst
    tile_of_edge = dst // tile
    counts = np.bincount(tile_of_edge, minlength=num_tiles)
    blocks_per_tile = np.maximum(1, -(-counts // eblk))
    padded = blocks_per_tile * eblk
    offsets = np.concatenate([[0], np.cumsum(padded)])[:-1]
    total = int(padded.sum())

    flat_src = np.full(total, n, np.int32)            # sentinel: s_pre[n] == 0
    flat_dstl = np.zeros(total, np.int32)
    # position of each edge inside its tile's padded span
    tile_start_edge = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos_in_tile = np.arange(graph.m) - tile_start_edge[tile_of_edge]
    slot = offsets[tile_of_edge] + pos_in_tile
    flat_src[slot] = src
    flat_dstl[slot] = dst - tile_of_edge * tile

    num_blocks = int(blocks_per_tile.sum())
    src_idx = flat_src.reshape(num_blocks, e1, e2)
    dst_local = flat_dstl.reshape(num_blocks, e1, e2)
    block_tile = np.repeat(np.arange(num_tiles, dtype=np.int32),
                           blocks_per_tile)
    first = np.ones(num_blocks, np.int32)
    first[1:] = (block_tile[1:] != block_tile[:-1]).astype(np.int32)
    last = np.ones(num_blocks, np.int32)
    last[:-1] = (block_tile[1:] != block_tile[:-1]).astype(np.int32)
    return EdgeTileFormat(n=n, n_pad=n_pad, tile=tile, e1=e1, e2=e2,
                          src_idx=src_idx, dst_local=dst_local,
                          block_tile=block_tile, block_first=first,
                          block_last=last, num_tiles=num_tiles)


def pad_edge_tile_blocks(fmt: EdgeTileFormat,
                         num_blocks: int) -> EdgeTileFormat:
    """Grow a format to exactly ``num_blocks`` blocks with inert padding.

    The multi-tenant fleet (:mod:`repro.serving`) stacks one format per
    tenant along a lane axis, which requires every member of a bucket to
    share the block count.  Padding appends all-sentinel blocks
    (``src_idx == n`` gathers the zero slot, so they scatter nothing) to
    the *last* node tile and moves that tile's ``block_last`` flag onto the
    final pad block — the tile's epilogue then runs after the inert blocks
    have accumulated zeros, leaving the kernel's output and gap unchanged.
    """
    extra = num_blocks - fmt.num_blocks
    if extra < 0:
        raise ValueError(f"format already has {fmt.num_blocks} blocks "
                         f"> requested {num_blocks}")
    if extra == 0:
        return fmt
    pad_shape = (extra, fmt.e1, fmt.e2)
    src_idx = np.concatenate(
        [fmt.src_idx, np.full(pad_shape, fmt.n, np.int32)])
    dst_local = np.concatenate(
        [fmt.dst_local, np.zeros(pad_shape, np.int32)])
    last_tile = fmt.num_tiles - 1
    block_tile = np.concatenate(
        [fmt.block_tile, np.full(extra, last_tile, np.int32)])
    block_first = np.concatenate(
        [fmt.block_first, np.zeros(extra, np.int32)])
    block_last = np.concatenate(
        [fmt.block_last, np.zeros(extra, np.int32)])
    block_last[block_tile == last_tile] = 0
    block_last[-1] = 1
    return dataclasses.replace(fmt, src_idx=src_idx, dst_local=dst_local,
                               block_tile=block_tile,
                               block_first=block_first,
                               block_last=block_last)


@dataclasses.dataclass(frozen=True)
class BsrFormat:
    n: int
    n_src_pad: int
    n_dst_pad: int
    ts: int                  # src-tile (contraction) size
    td: int                  # dst-tile (output) size
    tiles: np.ndarray        # f32[num_blocks, ts, td] dense tile values
    src_tile: np.ndarray     # i32[num_blocks]
    dst_tile: np.ndarray     # i32[num_blocks]
    block_first: np.ndarray  # i32[num_blocks]
    num_dst_tiles: int

    @property
    def num_blocks(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def dst_first_block(self) -> np.ndarray:
        return block_ranges(self.dst_tile, self.num_dst_tiles)[0]

    @property
    def dst_num_blocks(self) -> np.ndarray:
        return block_ranges(self.dst_tile, self.num_dst_tiles)[1]

    @property
    def occupancy(self) -> float:
        return float((self.tiles != 0).mean()) if self.tiles.size else 0.0


def build_bsr(graph: Graph, *, ts: int = 128, td: int = 128,
              edge_values: np.ndarray | None = None,
              dtype=np.float32) -> BsrFormat:
    """Pack the non-empty (src-tile × dst-tile) blocks of the push matrix.

    ``edge_values`` defaults to 1.0 (adjacency); the ψ scaling (1/w_j, μ_i)
    is folded into the input/epilogue vectors by the caller.
    """
    n = graph.n
    nst = max(1, -(-n // ts))
    ndt = max(1, -(-n // td))
    src, dst = graph.edges_by_dst
    vals = (np.ones(graph.m, dtype) if edge_values is None
            else np.asarray(edge_values, dtype))
    st = src // ts
    dt = dst // td
    key = dt.astype(np.int64) * nst + st          # dst-major block ordering
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, start = np.unique(key_s, return_index=True)
    num_blocks = max(1, uniq.size)

    tiles = np.zeros((num_blocks, ts, td), dtype)
    if uniq.size:
        block_of_edge = np.searchsorted(uniq, key_s)
        r = (src[order] % ts).astype(np.int64)
        c = (dst[order] % td).astype(np.int64)
        np.add.at(tiles, (block_of_edge, r, c), vals[order])
        src_tile = (uniq % nst).astype(np.int32)
        dst_tile = (uniq // nst).astype(np.int32)
    else:  # empty graph — single zero block
        src_tile = np.zeros(1, np.int32)
        dst_tile = np.zeros(1, np.int32)
    # every dst tile must be visited at least once so its output block is
    # zero-initialized — insert an explicit zero block for uncovered tiles
    missing = np.setdiff1d(np.arange(ndt, dtype=np.int32), dst_tile)
    if missing.size:
        tiles = np.concatenate(
            [tiles, np.zeros((missing.size, ts, td), dtype)])
        src_tile = np.concatenate([src_tile, np.zeros(missing.size, np.int32)])
        dst_tile = np.concatenate([dst_tile, missing])
        order2 = np.argsort(dst_tile, kind="stable")
        tiles, src_tile, dst_tile = (tiles[order2], src_tile[order2],
                                     dst_tile[order2])
        num_blocks = tiles.shape[0]
    first = np.ones(num_blocks, np.int32)
    first[1:] = (dst_tile[1:] != dst_tile[:-1]).astype(np.int32)
    return BsrFormat(n=n, n_src_pad=nst * ts, n_dst_pad=ndt * td, ts=ts,
                     td=td, tiles=tiles, src_tile=src_tile, dst_tile=dst_tile,
                     block_first=first, num_dst_tiles=ndt)
