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
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .edge_spmv import (check_blocks, check_edge_tile_smem, check_lanes,
                        edge_spmv_plain, heavy_first)

__all__ = ["power_step_call", "power_step_plain", "power_step_lanes_call",
           "power_step_lanes_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12 + [
    ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]

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
                  tile) -> tuple[int, int]:
    """Raise on what the kernel does not take; returns the ring
    ``(sblk, depth)``."""
    dev, dtype = s_pre.device, s_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"power_step takes float32 or float64; got {dtype}")
    for name, x, want in (("mu", mu, dtype), ("c", c, dtype),
                          ("s_old", s_old, dtype),
                          ("src_idx", src_idx, torch.int32),
                          ("dst_local", dst_local, torch.int32),
                          ("tile_first_block", tile_first_block, torch.int32),
                          ("tile_num_blocks", tile_num_blocks, torch.int32),
                          ("tile_order", tile_order, torch.int32)):
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
            tile_order, mu, c, s_old, s_new, gap, *, n, tile, ring, lanes):
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
                    tile_num_blocks.data_ptr(),
                    tile_order.data_ptr(), mu.data_ptr(),
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
                    tile: int, tile_order: torch.Tensor | None = None
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

    Returns:
      (s_new f[1, num_tiles * tile], gap 0-dim ‖s_new − s_old‖₁).
    """
    if s_pre.device.type == "cpu":
        return power_step_plain(s_pre, src_idx, dst_local, block_tile, mu, c,
                                s_old, tile=tile)
    if s_pre.device.type != "cuda":
        raise ValueError(f"power_step runs on cuda or cpu; got {s_pre.device}")
    if tile_order is None:
        tile_order = heavy_first(tile_num_blocks)
    ring = _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                         tile_num_blocks, tile_order, mu, c, s_old, n, tile)
    s_new = torch.empty_like(mu)
    gap = torch.empty((), dtype=s_pre.dtype, device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, tile_first_block, tile_num_blocks,
            tile_order, mu, c, s_old, s_new, gap, n=n, tile=tile, ring=ring,
            lanes=1)
    power_step_call.launches += 1
    return s_new, gap


power_step_call.launches = 0


def power_step_lanes_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                          dst_local: torch.Tensor, block_tile: torch.Tensor,
                          tile_first_block: torch.Tensor,
                          tile_num_blocks: torch.Tensor, mu: torch.Tensor,
                          c: torch.Tensor, s_old: torch.Tensor, *, n: int,
                          tile: int, tile_order: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused step of ``L`` lanes in one launch: :func:`power_step_call`'s
    arguments, each with a leading ``[L]`` lane axis (``s_pre``
    f[L, 1, n_gather], ``src_idx`` / ``dst_local`` i32[L, num_blocks, e1,
    e2], ``block_tile`` i32[L, num_blocks], the tile tables and
    ``tile_order`` i32[L, num_tiles], ``mu`` / ``c`` / ``s_old``
    f[L, 1, num_tiles * tile]); every lane shares ``n`` (the sentinel) and
    the shape. Each lane has its own ticket counter and partials.

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
    check_lanes("power_step_lanes", lanes, s_pre=s_pre, src_idx=src_idx,
                dst_local=dst_local, tile_first_block=tile_first_block,
                tile_num_blocks=tile_num_blocks, tile_order=tile_order,
                mu=mu, c=c, s_old=s_old)
    ring = _check_inputs(s_pre[0], src_idx[0], dst_local[0],
                         tile_first_block[0], tile_num_blocks[0],
                         tile_order[0], mu[0], c[0], s_old[0], n, tile)
    s_new = torch.empty_like(mu)
    gap = torch.empty(lanes, dtype=s_pre.dtype, device=s_pre.device)
    _launch(s_pre, src_idx, dst_local, tile_first_block, tile_num_blocks,
            tile_order, mu, c, s_old, s_new, gap, n=n, tile=tile, ring=ring,
            lanes=lanes)
    power_step_lanes_call.launches += 1
    return s_new, gap


power_step_lanes_call.launches = 0
