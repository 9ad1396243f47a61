"""Bare push over the edge-tile format: CUDA kernel and plain version.

``t_i = Σ_{(j→i)} w_e · s_pre_j`` with optional per-edge weights, over the
blocked edge layout of :mod:`repro_torch.kernels.formats` — the gather and
scatter of ``power_step`` without its μ/c epilogue and gap.
:func:`edge_spmv_call` launches ``csrc/edge_spmv.cu`` on a CUDA tensor (and
counts the launch in ``edge_spmv_call.launches``) and runs
:func:`edge_spmv_plain`, the same function in plain PyTorch, on a CPU
tensor. :func:`edge_spmv_lanes_call` is the push of ``L`` same-shape lanes
in one launch of the same kernel (the multi-tenant fleet's ψ epilogue), with
its own counter ``edge_spmv_lanes_call.launches`` and, for CPU tensors,
:func:`edge_spmv_lanes_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["edge_spmv_call", "edge_spmv_plain", "edge_spmv_lanes_call",
           "edge_spmv_lanes_plain", "edge_tile_smem_bytes", "stage_blocks",
           "check_edge_tile_smem", "check_blocks", "check_lanes",
           "heavy_first", "SMEM_LIMIT_BYTES", "STAGE_SLOTS_PER_NODE",
           "RING_SLOTS_PER_NODE"]

# The most dynamic shared memory a CTA may opt in to on the H100 (227 KB);
# the slots of one stage of the edge-tile kernels' ring, and of the whole
# ring, per node of the tile.
SMEM_LIMIT_BYTES = 232_448
STAGE_SLOTS_PER_NODE = 4
RING_SLOTS_PER_NODE = 8

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def edge_spmv_plain(s_pre: torch.Tensor, src_idx: torch.Tensor,
                    dst_local: torch.Tensor, block_tile: torch.Tensor,
                    weights: torch.Tensor | None = None, *, tile: int,
                    num_tiles: int) -> torch.Tensor:
    """The plain PyTorch version (same inputs, same layout): a gather, the
    weight multiply and an ``index_add_`` into the node tiles. Sentinel
    slots gather ``s_pre[n] == 0``. Returns f[1, num_tiles * tile]."""
    num_blocks = src_idx.shape[0]
    vals = s_pre[0][src_idx.reshape(num_blocks, -1).long()]
    if weights is not None:
        vals = vals * weights.reshape(num_blocks, -1)
    rows = (block_tile.long()[:, None] * tile
            + dst_local.reshape(num_blocks, -1).long())
    out = torch.zeros(num_tiles * tile, dtype=s_pre.dtype,
                      device=s_pre.device)
    out.index_add_(0, rows.reshape(-1), vals.reshape(-1))
    return out[None, :]


def edge_spmv_lanes_plain(s_pre: torch.Tensor, src_idx: torch.Tensor,
                          dst_local: torch.Tensor, block_tile: torch.Tensor,
                          weights: torch.Tensor | None = None, *, tile: int,
                          num_tiles: int) -> torch.Tensor:
    """The plain version of the lane-batched push: :func:`edge_spmv_plain`
    on each lane's tensors in turn. Returns f[L, 1, num_tiles * tile]."""
    return torch.stack([
        edge_spmv_plain(s_pre[i], src_idx[i], dst_local[i], block_tile[i],
                        None if weights is None else weights[i], tile=tile,
                        num_tiles=num_tiles)
        for i in range(s_pre.shape[0])])


def edge_tile_smem_bytes(tile: int, eblk: int, element_size: int,
                         sblk: int = 1, depth: int = 2,
                         weighted: bool = False) -> int:
    """Shared memory of one CTA of the edge-tile kernels (``power_step``,
    ``edge_spmv``) whose ring holds ``depth`` stages of ``sblk`` blocks, in
    bytes: ``edge_tile_smem_bytes`` of ``csrc/edge_tile_scan.cuh``. A
    128-byte header (the ring's mbarriers and counters), a 32-element
    scratch; a ring slot each: the staged int32 ``src_idx`` and
    ``dst_local`` (and the weights) and the gathered values of ``sblk ·
    eblk`` slots, the 16-bit run bounds of the rows (``2 · tile``); then an
    unsorted stage's row-grouped values (``sblk · eblk``) and the 16-bit
    row counts of its sort warps (``min(4, tile / 32) × tile``)."""
    span = sblk * eblk
    return (128 + 32 * element_size
            + depth * (span * (8 + element_size * (2 if weighted else 1))
                       + 4 * tile)
            + span * element_size + 2 * min(4, tile // 32) * tile)


def stage_blocks(tile: int, eblk: int, element_size: int,
                 weighted: bool = False) -> tuple[int, int]:
    """The edge-tile kernels' ring: ``(sblk, depth)``, blocks a stage and
    stages in the ring. A stage takes the most of 4, 2, 1 blocks within
    :data:`STAGE_SLOTS_PER_NODE` slots a node of the tile (one block if
    none is), and the ring as many stages, 2 to 4, as
    :data:`RING_SLOTS_PER_NODE` slots a node hold; where that does not fit
    :data:`SMEM_LIMIT_BYTES`, two stages of one block. At eblk 1024 that is
    two stages of one block at tiles 128 and 256 and of two blocks at tile
    512: on the H100 they beat every deeper or wider ring at the facebook
    and dblp fleet buckets (tile 512) and on the twitter stand-in (tiles 256
    and 512; PERF.md). More slots a stage cut the per-stage waits;
    more shared memory a CTA leaves fewer CTAs an SM, which a launch of
    many one-block tiles needs."""
    sblk = next((b for b in (4, 2)
                 if b * eblk <= STAGE_SLOTS_PER_NODE * tile), 1)
    depth = min(4, max(2, RING_SLOTS_PER_NODE * tile // (sblk * eblk)))
    if edge_tile_smem_bytes(tile, eblk, element_size, sblk, depth,
                            weighted) > SMEM_LIMIT_BYTES:
        return 1, 2
    return sblk, depth


def check_edge_tile_smem(kernel: str, tile: int, eblk: int,
                         element_size: int,
                         weighted: bool = False) -> tuple[int, int]:
    """The kernels' ring ``(sblk, depth)`` (:func:`stage_blocks`); raises
    unless its shared memory fits :data:`SMEM_LIMIT_BYTES`."""
    sblk, depth = stage_blocks(tile, eblk, element_size, weighted)
    need = edge_tile_smem_bytes(tile, eblk, element_size, sblk, depth,
                                weighted)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"{kernel}: tile {tile} with edge blocks of {eblk} "
                         f"slots needs {need} bytes of shared memory; the "
                         f"kernel has {SMEM_LIMIT_BYTES}")
    return sblk, depth


def check_blocks(kernel: str, eblk: int, **tensors) -> None:
    """Raise unless the edge blocks suit the ring's TMA copies and 128-slot
    chunks: ``eblk`` a multiple of 128 and every block array 16-byte
    aligned."""
    if eblk < 128 or eblk % 128:
        raise ValueError(f"{kernel}: edge blocks must hold a multiple of 128 "
                         f"slots (e1 * e2); got {eblk}")
    for name, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte "
                             f"boundary (the kernel copies its blocks with "
                             f"TMA); got address {x.data_ptr():#x}")


def check_lanes(kernel: str, lanes: int, **tensors) -> None:
    """Raise unless every tensor is contiguous with a leading ``[lanes]``
    axis and the lanes fit the lane kernels' indices: at most 65,535 (the
    grid's y dimension) and fewer than 2^31 tiles and blocks in all."""
    for name, x in tensors.items():
        if x.dim() < 2 or x.shape[0] != lanes or not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous tensor "
                             f"with a leading [{lanes}] lane axis; got "
                             f"{tuple(x.shape)}")
    tiles = tensors["tile_first_block"].shape[1]
    blocks = tensors["src_idx"].shape[1]
    if not 1 <= lanes <= 65_535 or lanes * max(tiles, blocks) >= 2 ** 31:
        raise ValueError(f"{kernel}: 1 to 65535 lanes of under 2^31 tiles "
                         f"and blocks in all; got {lanes} x {tiles} tiles, "
                         f"{blocks} blocks")


def heavy_first(tile_num_blocks: torch.Tensor) -> torch.Tensor:
    """The edge-tile kernels' launch order: tile ids with the most blocks
    first (ties in id order), so the CTAs with the longest chains start in
    the first wave (a lane-batched launch takes every lane's k-th tile
    before any lane's (k+1)-th). Any order gives the same bits; this one shortens the
    tail. :class:`~repro_torch.kernels.ops.DeviceEdgeTiles` computes it once
    as ``tile_order``; a wrapper called without one computes it here. For
    lane-stacked tables ``[L, num_tiles]`` each lane's row is ordered on
    its own."""
    return torch.argsort(tile_num_blocks, dim=-1, descending=True,
                         stable=True).to(torch.int32)


def _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, tile_order, weights, n,
                  tile) -> tuple[int, int]:
    """Raise on what the kernel does not take; returns the ring
    ``(sblk, depth)``."""
    dev, dtype = s_pre.device, s_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"edge_spmv takes float32 or float64; got {dtype}")
    named = [("s_pre", s_pre, dtype), ("src_idx", src_idx, torch.int32),
             ("dst_local", dst_local, torch.int32),
             ("tile_first_block", tile_first_block, torch.int32),
             ("tile_num_blocks", tile_num_blocks, torch.int32),
             ("tile_order", tile_order, torch.int32)]
    if weights is not None:
        named.append(("weights", weights, dtype))
    for name, x, want in named:
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"edge_spmv: {name} must be a contiguous {want} "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    num_tiles = tile_first_block.shape[0]
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"edge_spmv: tile must be a multiple of 32 in "
                         f"[32, 1024]; got {tile}")
    if tile_num_blocks.shape != (num_tiles,) or \
            tile_order.shape != (num_tiles,):
        raise ValueError("edge_spmv: tile_num_blocks and tile_order must "
                         "match tile_first_block")
    if s_pre.dim() != 2 or s_pre.shape[0] != 1 or s_pre.shape[1] < n:
        raise ValueError(f"edge_spmv: s_pre must be [1, >= {n}]")
    if src_idx.dim() != 3 or dst_local.shape != src_idx.shape:
        raise ValueError("edge_spmv: src_idx/dst_local must share a "
                         "[blocks, e1, e2] shape")
    eblk = src_idx.shape[1] * src_idx.shape[2]
    check_blocks("edge_spmv", eblk, src_idx=src_idx, dst_local=dst_local,
                 weights=weights)
    if weights is not None and weights.shape != src_idx.shape:
        raise ValueError(f"edge_spmv: weights must be "
                         f"{tuple(src_idx.shape)}; got {tuple(weights.shape)}")
    return check_edge_tile_smem("edge_spmv", tile, eblk,
                                s_pre.element_size(), weights is not None)


def _launch(s_pre, src_idx, dst_local, weights, tile_first_block,
            tile_num_blocks, tile_order, out, *, n, tile, ring, lanes):
    """One launch of ``csrc/edge_spmv.cu`` over ``lanes`` lanes (the
    tensors' leading axis when ``lanes > 1``)."""
    symbol = ("repro_edge_spmv_f32" if s_pre.dtype == torch.float32
              else "repro_edge_spmv_f64")
    fn = _build.entry("edge_spmv", symbol, _ARGTYPES)
    eblk = src_idx.shape[-1] * src_idx.shape[-2]
    with torch.cuda.device(s_pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre.data_ptr(), n, src_idx.data_ptr(),
                    dst_local.data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    tile_first_block.data_ptr(), tile_num_blocks.data_ptr(),
                    tile_order.data_ptr(), out.data_ptr(),
                    tile_first_block.shape[-1], tile, eblk, *ring, lanes,
                    s_pre.shape[-1], src_idx.shape[1] if lanes > 1 else 0,
                    stream)
    _build.check("edge_spmv", status)


def edge_spmv_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                   dst_local: torch.Tensor, block_tile: torch.Tensor,
                   tile_first_block: torch.Tensor,
                   tile_num_blocks: torch.Tensor,
                   weights: torch.Tensor | None = None, *, n: int,
                   tile: int,
                   tile_order: torch.Tensor | None = None) -> torch.Tensor:
    """The bare push over a device edge-tile format.

    Args:
      s_pre: f[1, n_gather] gather source, zero from index n on.
      src_idx / dst_local: i32[num_blocks, e1, e2] (sentinel source n).
      block_tile: i32[num_blocks]; tile_first_block / tile_num_blocks:
        i32[num_tiles], each tile's contiguous block range.
      weights: optional f[num_blocks, e1, e2] per-edge weights.
      tile_order: optional i32[num_tiles], the order in which the kernel
        takes the tiles, a permutation of the tile ids (the format's
        ``tile_order``; :func:`heavy_first` of ``tile_num_blocks`` when
        absent). It moves no bit of the result.

    Returns:
      f[1, num_tiles * tile]; the caller slices ``[:, :n]``.
    """
    num_tiles = tile_first_block.shape[0]
    if s_pre.device.type == "cpu":
        return edge_spmv_plain(s_pre, src_idx, dst_local, block_tile, weights,
                               tile=tile, num_tiles=num_tiles)
    if s_pre.device.type != "cuda":
        raise ValueError(f"edge_spmv runs on cuda or cpu; got {s_pre.device}")
    if tile_order is None:
        tile_order = heavy_first(tile_num_blocks)
    ring = _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                         tile_num_blocks, tile_order, weights, n, tile)
    out = torch.empty(1, num_tiles * tile, dtype=s_pre.dtype,
                      device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, weights, tile_first_block,
            tile_num_blocks, tile_order, out, n=n, tile=tile, ring=ring,
            lanes=1)
    edge_spmv_call.launches += 1
    return out


edge_spmv_call.launches = 0


def edge_spmv_lanes_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                         dst_local: torch.Tensor, block_tile: torch.Tensor,
                         tile_first_block: torch.Tensor,
                         tile_num_blocks: torch.Tensor,
                         weights: torch.Tensor | None = None, *, n: int,
                         tile: int, tile_order: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """The push of ``L`` lanes in one launch: :func:`edge_spmv_call`'s
    arguments, each with a leading ``[L]`` lane axis (``s_pre``
    f[L, 1, n_gather], the format i32[L, num_blocks, e1, e2], ``block_tile``
    i32[L, num_blocks], the tile tables and ``tile_order`` i32[L,
    num_tiles], ``weights`` f[L, num_blocks, e1, e2]); every lane shares
    ``n`` (the sentinel) and the shape.

    Returns:
      f[L, 1, num_tiles * tile], lane ℓ bitwise what :func:`edge_spmv_call`
      returns on lane ℓ's tensors.
    """
    num_tiles = tile_first_block.shape[-1]
    if s_pre.device.type == "cpu":
        return edge_spmv_lanes_plain(s_pre, src_idx, dst_local, block_tile,
                                     weights, tile=tile, num_tiles=num_tiles)
    if s_pre.device.type != "cuda":
        raise ValueError(f"edge_spmv_lanes runs on cuda or cpu; got "
                         f"{s_pre.device}")
    lanes = s_pre.shape[0]
    if tile_order is None:
        tile_order = heavy_first(tile_num_blocks)
    named = dict(s_pre=s_pre, src_idx=src_idx, dst_local=dst_local,
                 tile_first_block=tile_first_block,
                 tile_num_blocks=tile_num_blocks, tile_order=tile_order)
    if weights is not None:
        named["weights"] = weights
    check_lanes("edge_spmv_lanes", lanes, **named)
    ring = _check_inputs(s_pre[0], src_idx[0], dst_local[0],
                         tile_first_block[0], tile_num_blocks[0],
                         tile_order[0], None if weights is None
                         else weights[0], n, tile)
    out = torch.empty(lanes, 1, num_tiles * tile, dtype=s_pre.dtype,
                      device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, weights, tile_first_block,
            tile_num_blocks, tile_order, out, n=n, tile=tile, ring=ring,
            lanes=lanes)
    edge_spmv_lanes_call.launches += 1
    return out


edge_spmv_lanes_call.launches = 0
