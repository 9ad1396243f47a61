"""Fused Power-ψ step over the edge-tile format: CUDA kernel and plain version.

One Alg. 2 step is ``s' = μ ⊙ push(s) + c`` followed by the termination gap
``‖s' − s‖₁``. :func:`power_step_call` runs it in one pass over the blocked
edge layout of :mod:`repro_torch.kernels.formats`: on a CUDA tensor it
launches ``csrc/power_step.cu`` (and counts the launch in
``power_step_call.launches``); on a CPU tensor it runs
:func:`power_step_plain`, the same function in plain PyTorch.

:func:`power_step_lanes_call` is the same step for ``L`` lanes of one shape
at once (the multi-tenant fleet's bucket): every tensor gains a leading
``[L]``, one launch of the same kernel steps every lane, and each lane gets
exactly what :func:`power_step_call` gives on that lane's own tensors. It
counts its launches in ``power_step_lanes_call.launches``; on CPU tensors
it runs :func:`power_step_lanes_plain`, the plain version lane by lane.

:func:`row_path_plan` is the kernel's plan of one format, built once a
format on its device: each node's first slot in its tile and, per tile,
whether the kernel folds it on the row path (``csrc/edge_tile_rows.cuh``:
a sorted tile with a row longer than the ring's stage, its long rows
folded side by side) or through the ring. The plan moves no bit of the
result; without one every tile takes the ring.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..obs import trace as obs_trace
from . import _build
from .edge_spmv import (check_blocks, check_edge_tile_smem, check_lanes,
                        edge_spmv_plain, heavy_first, stage_blocks)

__all__ = ["power_step_call", "power_step_plain", "power_step_lanes_call",
           "power_step_lanes_plain", "RowPlan", "row_path_plan",
           "ring_stage_slots"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 14 + [
    ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def ring_stage_slots(tile: int, eblk: int) -> int:
    """The slots of one stage of the edge-tile kernels' ring at float64
    (:func:`~.edge_spmv.stage_blocks`; float32 has the same stage at every
    shape the autotuner picks): past this many slots a row's run sends its
    sorted tile to the row path."""
    return stage_blocks(tile, eblk, 8)[0] * eblk


class RowPlan(NamedTuple):
    """The step kernel's plan of one edge-tile format (:func:`row_path_plan`)."""

    row_start: torch.Tensor        # i32[num_tiles * tile]
    tile_row_slots: torch.Tensor   # i32[num_tiles]
    real_slots: torch.Tensor       # i64[num_tiles], every tile's real slots


def row_path_plan(src_idx: torch.Tensor, dst_local: torch.Tensor,
                  block_tile: torch.Tensor, tile_first_block: torch.Tensor,
                  *, n: int, tile: int, stage: int | None = None) -> RowPlan:
    """Which tiles of one format the step kernel folds on its row path, on
    the format's device.

    A slot is real when its source is in [0, n) and its ``dst_local`` in
    [0, tile). ``row_start[t * tile + r]`` is the first slot of node r of
    tile t in the tile's slot range: the exclusive scan of the tile's
    in-degrees. A tile takes the row path when it is sorted (its real slots
    come first, in non-decreasing ``dst_local``, and only sentinels after
    them, as a fresh :func:`~.formats.build_edge_tiles` lays every tile) and
    some row has more than ``stage`` slots (:func:`ring_stage_slots` when
    None; the tests pass 0 or a huge stage to force either path), in a
    format of tiles of 64 nodes or more (the row path's teams are two
    warps). Then ``tile_row_slots[t]`` is its real slots, the end of its
    last row, and otherwise 0: the ring, which also takes a shuffled,
    patched, idle or empty tile."""
    num_tiles = tile_first_block.shape[0]
    num_blocks = src_idx.shape[0]
    eblk = src_idx.shape[1] * src_idx.shape[2]
    if stage is None:
        stage = ring_stage_slots(tile, eblk)
    dev = src_idx.device
    src = src_idx.reshape(num_blocks, eblk)
    dst = dst_local.reshape(num_blocks, eblk)
    real = (src >= 0) & (src < n) & (dst >= 0) & (dst < tile)
    rows = block_tile[:, None] * tile + dst
    deg = torch.bincount(rows[real], minlength=num_tiles * tile).view(
        num_tiles, tile)
    slots = deg.sum(1)
    row_start = (torch.cumsum(deg, 1) - deg).reshape(-1).to(torch.int32)
    # sorted: the first `slots` of a tile's range are its real slots, and
    # every real slot's row is at least its real predecessor's
    pos = ((torch.arange(num_blocks, dtype=torch.int32, device=dev)
            - tile_first_block[block_tile])[:, None] * eblk
           + torch.arange(eblk, dtype=torch.int32, device=dev))
    bad = real != (pos < slots[block_tile][:, None])
    flat_rows, flat_real = rows.reshape(-1), real.reshape(-1)
    bad.view(-1)[:-1] |= (flat_real[1:] & flat_real[:-1]
                          & (flat_rows[1:] < flat_rows[:-1]))
    unsorted = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    unsorted.index_add_(0, block_tile, bad.any(1).to(torch.int32))
    takes = (unsorted == 0) & (deg.amax(1) > stage) & (tile >= 64)
    return RowPlan(row_start=row_start,
                   tile_row_slots=torch.where(takes, slots, 0).to(
                       torch.int32),
                   real_slots=slots)

# One int32 ticket counter a lane per (device, stream): a lane's CTAs draw
# tickets from its counter to find the last one, which sums that lane's
# partial gaps and resets the counter to 0. Launches that share a counter
# must run one after another, which launches on one stream do; launches on
# two streams may overlap, so each stream has its own counters. A launch of
# more lanes than the stream's array holds gets a new, larger array
# (zeroed on that stream, so after every launch queued before it).
_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int, lanes: int = 1) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < lanes:
        t = _TICKETS[device, stream] = torch.zeros(
            max(lanes, 1), dtype=torch.int32, device=device)
    return t


def power_step_plain(s_pre: torch.Tensor, src_idx: torch.Tensor,
                     dst_local: torch.Tensor, block_tile: torch.Tensor,
                     mu: torch.Tensor, c: torch.Tensor, s_old: torch.Tensor,
                     *, tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fused step (same inputs, same
    padded ``[1, n_pad]`` layout): the plain push of :mod:`.edge_spmv`,
    then the epilogue. Sentinel slots gather ``s_pre[n] == 0``."""
    t = edge_spmv_plain(s_pre, src_idx, dst_local, block_tile, tile=tile,
                        num_tiles=mu.shape[1] // tile)
    s_new = mu * t + c
    return s_new, torch.sum(torch.abs(s_new - s_old))


def power_step_lanes_plain(s_pre: torch.Tensor, src_idx: torch.Tensor,
                           dst_local: torch.Tensor, block_tile: torch.Tensor,
                           mu: torch.Tensor, c: torch.Tensor,
                           s_old: torch.Tensor, *, tile: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the lane-batched step: :func:`power_step_plain`
    on each lane's tensors in turn. Returns (s_new f[L, 1, n_pad],
    gap f[L])."""
    outs = [power_step_plain(s_pre[i], src_idx[i], dst_local[i],
                             block_tile[i], mu[i], c[i], s_old[i], tile=tile)
            for i in range(s_pre.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, tile_order, mu, c, s_old, n,
                  tile, row_start=None, tile_row_slots=None
                  ) -> tuple[int, int]:
    """Raise on what the kernel does not take; returns the ring
    ``(sblk, depth)``."""
    dev, dtype = s_pre.device, s_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"power_step takes float32 or float64; got {dtype}")
    named = [("mu", mu, dtype), ("c", c, dtype), ("s_old", s_old, dtype),
             ("src_idx", src_idx, torch.int32),
             ("dst_local", dst_local, torch.int32),
             ("tile_first_block", tile_first_block, torch.int32),
             ("tile_num_blocks", tile_num_blocks, torch.int32),
             ("tile_order", tile_order, torch.int32)]
    if (row_start is None) != (tile_row_slots is None):
        raise ValueError("power_step: a plan takes both row_start and "
                         "tile_row_slots")
    if row_start is not None:
        named += [("row_start", row_start, torch.int32),
                  ("tile_row_slots", tile_row_slots, torch.int32)]
    for name, x, want in named:
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"power_step: {name} must be a contiguous {want} "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    num_tiles = tile_first_block.shape[0]
    n_pad = num_tiles * tile
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"power_step: tile must be a multiple of 32 in "
                         f"[32, 1024]; got {tile}")
    if tile_num_blocks.shape != (num_tiles,) or \
            tile_order.shape != (num_tiles,):
        raise ValueError("power_step: tile_num_blocks and tile_order must "
                         "match tile_first_block")
    if row_start is not None and (row_start.shape != (n_pad,) or
                                  tile_row_slots.shape != (num_tiles,)):
        raise ValueError(f"power_step: the plan must be row_start "
                         f"[{n_pad}] and tile_row_slots [{num_tiles}]")
    for name, x in (("mu", mu), ("c", c), ("s_old", s_old)):
        if x.shape != (1, n_pad):
            raise ValueError(f"power_step: {name} must be [1, {n_pad}]; "
                             f"got {tuple(x.shape)}")
    if s_pre.dim() != 2 or s_pre.shape[0] != 1 or s_pre.shape[1] < n:
        raise ValueError(f"power_step: s_pre must be [1, >= {n}]")
    if src_idx.dim() != 3 or dst_local.shape != src_idx.shape:
        raise ValueError("power_step: src_idx/dst_local must share a "
                         "[blocks, e1, e2] shape")
    eblk = src_idx.shape[1] * src_idx.shape[2]
    check_blocks("power_step", eblk, src_idx=src_idx, dst_local=dst_local)
    return check_edge_tile_smem("power_step", tile, eblk,
                                s_pre.element_size())


def _launch(s_pre, src_idx, dst_local, tile_first_block, tile_num_blocks,
            tile_order, row_start, tile_row_slots, mu, c, s_old, s_new, gap,
            *, n, tile, ring, lanes):
    """One launch of ``csrc/power_step.cu`` over ``lanes`` lanes (the
    tensors' leading axis when ``lanes > 1``)."""
    num_tiles = tile_first_block.shape[-1]
    partial = torch.empty(lanes, num_tiles, dtype=s_pre.dtype,
                          device=s_pre.device)
    symbol = ("repro_power_step_f32" if s_pre.dtype == torch.float32
              else "repro_power_step_f64")
    fn = _build.entry("power_step", symbol, _ARGTYPES)
    eblk = src_idx.shape[-1] * src_idx.shape[-2]
    with torch.cuda.device(s_pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre.data_ptr(), n, src_idx.data_ptr(),
                    dst_local.data_ptr(), tile_first_block.data_ptr(),
                    tile_num_blocks.data_ptr(), tile_order.data_ptr(),
                    None if row_start is None else row_start.data_ptr(),
                    None if tile_row_slots is None
                    else tile_row_slots.data_ptr(), mu.data_ptr(),
                    c.data_ptr(), s_old.data_ptr(), s_new.data_ptr(),
                    partial.data_ptr(), gap.data_ptr(),
                    _ticket(s_pre.device, stream, lanes).data_ptr(),
                    num_tiles, tile, eblk, *ring, lanes, s_pre.shape[-1],
                    src_idx.shape[1] if lanes > 1 else 0, stream)
    _build.check("power_step", status)


def power_step_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                    dst_local: torch.Tensor, block_tile: torch.Tensor,
                    tile_first_block: torch.Tensor,
                    tile_num_blocks: torch.Tensor, mu: torch.Tensor,
                    c: torch.Tensor, s_old: torch.Tensor, *, n: int,
                    tile: int, tile_order: torch.Tensor | None = None,
                    row_start: torch.Tensor | None = None,
                    tile_row_slots: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused step over a device edge-tile format.

    Args:
      s_pre: f[1, n_gather] — s ⊙ 1/w, zero from index n on.
      src_idx / dst_local: i32[num_blocks, e1, e2] (sentinel source n).
      block_tile: i32[num_blocks]; tile_first_block / tile_num_blocks:
        i32[num_tiles], each tile's contiguous block range.
      mu / c / s_old: f[1, num_tiles * tile].
      tile_order: optional i32[num_tiles], the order in which the kernel
        takes the tiles, a permutation of the tile ids (the format's
        ``tile_order``; ``heavy_first`` of ``tile_num_blocks`` when absent).
        It moves no bit of the result.
      row_start / tile_row_slots: optional, both or neither: the format's
        plan (:func:`row_path_plan`: i32[num_tiles * tile], i32[num_tiles]),
        which sends its sorted tiles with a long row to the row path. It
        moves no bit of the result; without it every tile takes the ring.

    Returns:
      (s_new f[1, num_tiles * tile], gap 0-dim ‖s_new − s_old‖₁).
    """
    if s_pre.device.type == "cpu":
        return power_step_plain(s_pre, src_idx, dst_local, block_tile, mu, c,
                                s_old, tile=tile)
    if s_pre.device.type != "cuda":
        raise ValueError(f"power_step runs on cuda or cpu; got {s_pre.device}")
    with obs_trace.hot_span("power_step.check"):
        if tile_order is None:
            tile_order = heavy_first(tile_num_blocks)
        ring = _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                             tile_num_blocks, tile_order, mu, c, s_old, n,
                             tile, row_start, tile_row_slots)
    s_new = torch.empty_like(mu)
    gap = torch.empty((), dtype=s_pre.dtype, device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, tile_first_block, tile_num_blocks,
            tile_order, row_start, tile_row_slots, mu, c, s_old, s_new, gap,
            n=n, tile=tile, ring=ring, lanes=1)
    power_step_call.launches += 1
    return s_new, gap


power_step_call.launches = 0


def power_step_lanes_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                          dst_local: torch.Tensor, block_tile: torch.Tensor,
                          tile_first_block: torch.Tensor,
                          tile_num_blocks: torch.Tensor, mu: torch.Tensor,
                          c: torch.Tensor, s_old: torch.Tensor, *, n: int,
                          tile: int, tile_order: torch.Tensor | None = None,
                          row_start: torch.Tensor | None = None,
                          tile_row_slots: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused step of ``L`` lanes in one launch: :func:`power_step_call`'s
    arguments, each with a leading ``[L]`` lane axis (``s_pre``
    f[L, 1, n_gather], ``src_idx`` / ``dst_local`` i32[L, num_blocks, e1,
    e2], ``block_tile`` i32[L, num_blocks], the tile tables and
    ``tile_order`` i32[L, num_tiles], ``mu`` / ``c`` / ``s_old``
    f[L, 1, num_tiles * tile], the plan ``row_start`` i32[L, num_tiles *
    tile] and ``tile_row_slots`` i32[L, num_tiles]); every lane shares ``n``
    (the sentinel) and the shape. Each lane has its own ticket counter and
    partials.

    Returns:
      (s_new f[L, 1, num_tiles * tile], gap f[L]), lane ℓ bitwise what
      :func:`power_step_call` returns on lane ℓ's tensors.
    """
    if s_pre.device.type == "cpu":
        return power_step_lanes_plain(s_pre, src_idx, dst_local, block_tile,
                                      mu, c, s_old, tile=tile)
    if s_pre.device.type != "cuda":
        raise ValueError(f"power_step_lanes runs on cuda or cpu; got "
                         f"{s_pre.device}")
    lanes = s_pre.shape[0]
    if tile_order is None:
        tile_order = heavy_first(tile_num_blocks)
    plan = {} if row_start is None else dict(row_start=row_start)
    if tile_row_slots is not None:
        plan["tile_row_slots"] = tile_row_slots
    check_lanes("power_step_lanes", lanes, s_pre=s_pre, src_idx=src_idx,
                dst_local=dst_local, tile_first_block=tile_first_block,
                tile_num_blocks=tile_num_blocks, tile_order=tile_order,
                mu=mu, c=c, s_old=s_old, **plan)
    ring = _check_inputs(s_pre[0], src_idx[0], dst_local[0],
                         tile_first_block[0], tile_num_blocks[0],
                         tile_order[0], mu[0], c[0], s_old[0], n, tile,
                         *(None if x is None else x[0]
                           for x in (row_start, tile_row_slots)))
    s_new = torch.empty_like(mu)
    gap = torch.empty(lanes, dtype=s_pre.dtype, device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, tile_first_block, tile_num_blocks,
            tile_order, row_start, tile_row_slots, mu, c, s_old, s_new, gap,
            n=n, tile=tile, ring=ring, lanes=lanes)
    power_step_lanes_call.launches += 1
    return s_new, gap


power_step_lanes_call.launches = 0
