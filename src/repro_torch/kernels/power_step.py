"""Fused Power-ψ step over the edge-tile format: CUDA kernel and plain version.

One Alg. 2 step is ``s' = μ ⊙ push(s) + c`` followed by the termination gap
``‖s' − s‖₁``. :func:`power_step_call` runs it in one pass over the blocked
edge layout of :mod:`repro_torch.kernels.formats`: on a CUDA tensor it
launches ``csrc/power_step.cu`` (and counts the launch in
``power_step_call.launches``); on a CPU tensor it runs
:func:`power_step_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .edge_spmv import edge_spmv_plain

__all__ = ["power_step_call", "power_step_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, mu, c, s_old, n, tile) -> None:
    dev, dtype = s_pre.device, s_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"power_step takes float32 or float64; got {dtype}")
    for name, x, want in (("mu", mu, dtype), ("c", c, dtype),
                          ("s_old", s_old, dtype),
                          ("src_idx", src_idx, torch.int32),
                          ("dst_local", dst_local, torch.int32),
                          ("tile_first_block", tile_first_block, torch.int32),
                          ("tile_num_blocks", tile_num_blocks, torch.int32)):
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"power_step: {name} must be a contiguous {want} "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    num_tiles = tile_first_block.shape[0]
    n_pad = num_tiles * tile
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"power_step: tile must be a multiple of 32 in "
                         f"[32, 1024]; got {tile}")
    if tile_num_blocks.shape != (num_tiles,):
        raise ValueError("power_step: tile_num_blocks must match "
                         "tile_first_block")
    for name, x in (("mu", mu), ("c", c), ("s_old", s_old)):
        if x.shape != (1, n_pad):
            raise ValueError(f"power_step: {name} must be [1, {n_pad}]; "
                             f"got {tuple(x.shape)}")
    if s_pre.dim() != 2 or s_pre.shape[0] != 1 or s_pre.shape[1] < n:
        raise ValueError(f"power_step: s_pre must be [1, >= {n}]")
    eblk = src_idx[0].numel() if src_idx.shape[0] else 0
    if dst_local.shape != src_idx.shape or eblk < 32:
        raise ValueError("power_step: src_idx/dst_local must share a "
                         "[blocks, e1, e2] shape with e1*e2 >= 32")
    if eblk * (s_pre.element_size() + 4) > 48 * 1024:
        raise ValueError(f"power_step: an edge block of {eblk} slots does "
                         f"not fit the kernel's 48 KiB of shared memory")


def power_step_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                    dst_local: torch.Tensor, block_tile: torch.Tensor,
                    tile_first_block: torch.Tensor,
                    tile_num_blocks: torch.Tensor, mu: torch.Tensor,
                    c: torch.Tensor, s_old: torch.Tensor, *, n: int,
                    tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused step over a device edge-tile format.

    Args:
      s_pre: f[1, n_gather] — s ⊙ 1/w, zero from index n on.
      src_idx / dst_local: i32[num_blocks, e1, e2] (sentinel source n).
      block_tile: i32[num_blocks]; tile_first_block / tile_num_blocks:
        i32[num_tiles], each tile's contiguous block range.
      mu / c / s_old: f[1, num_tiles * tile].

    Returns:
      (s_new f[1, num_tiles * tile], gap 0-dim ‖s_new − s_old‖₁).
    """
    if s_pre.device.type == "cpu":
        return power_step_plain(s_pre, src_idx, dst_local, block_tile, mu, c,
                                s_old, tile=tile)
    if s_pre.device.type != "cuda":
        raise ValueError(f"power_step runs on cuda or cpu; got {s_pre.device}")
    _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, mu, c, s_old, n, tile)
    num_tiles = tile_first_block.shape[0]
    s_new = torch.empty_like(mu)
    partial = torch.empty(num_tiles, dtype=s_pre.dtype, device=s_pre.device)
    gap = torch.empty((), dtype=s_pre.dtype, device=s_pre.device)
    symbol = ("repro_power_step_f32" if s_pre.dtype == torch.float32
              else "repro_power_step_f64")
    fn = _build.entry("power_step", symbol, _ARGTYPES)
    with torch.cuda.device(s_pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre.data_ptr(), n, src_idx.data_ptr(),
                    dst_local.data_ptr(), tile_first_block.data_ptr(),
                    tile_num_blocks.data_ptr(), mu.data_ptr(), c.data_ptr(),
                    s_old.data_ptr(), s_new.data_ptr(), partial.data_ptr(),
                    gap.data_ptr(), num_tiles, tile, src_idx[0].numel(),
                    stream)
    _build.check("power_step", status)
    power_step_call.launches += 1
    return s_new, gap


power_step_call.launches = 0
