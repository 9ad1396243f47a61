"""Bare push over the edge-tile format: CUDA kernel and plain version.

``t_i = Σ_{(j→i)} w_e · s_pre_j`` with optional per-edge weights, over the
blocked edge layout of :mod:`repro_torch.kernels.formats` — the gather and
scatter of ``power_step`` without its μ/c epilogue and gap.
:func:`edge_spmv_call` launches ``csrc/edge_spmv.cu`` on a CUDA tensor (and
counts the launch in ``edge_spmv_call.launches``) and runs
:func:`edge_spmv_plain`, the same function in plain PyTorch, on a CPU
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["edge_spmv_call", "edge_spmv_plain"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, weights, n, tile) -> None:
    dev, dtype = s_pre.device, s_pre.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"edge_spmv takes float32 or float64; got {dtype}")
    named = [("s_pre", s_pre, dtype), ("src_idx", src_idx, torch.int32),
             ("dst_local", dst_local, torch.int32),
             ("tile_first_block", tile_first_block, torch.int32),
             ("tile_num_blocks", tile_num_blocks, torch.int32)]
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
    if tile_num_blocks.shape != (num_tiles,):
        raise ValueError("edge_spmv: tile_num_blocks must match "
                         "tile_first_block")
    if s_pre.dim() != 2 or s_pre.shape[0] != 1 or s_pre.shape[1] < n:
        raise ValueError(f"edge_spmv: s_pre must be [1, >= {n}]")
    eblk = src_idx[0].numel() if src_idx.shape[0] else 0
    if src_idx.dim() != 3 or dst_local.shape != src_idx.shape or eblk < 32:
        raise ValueError("edge_spmv: src_idx/dst_local must share a "
                         "[blocks, e1, e2] shape with e1*e2 >= 32")
    if weights is not None and weights.shape != src_idx.shape:
        raise ValueError(f"edge_spmv: weights must be "
                         f"{tuple(src_idx.shape)}; got {tuple(weights.shape)}")
    if eblk * (s_pre.element_size() + 4) > 48 * 1024:
        raise ValueError(f"edge_spmv: an edge block of {eblk} slots does "
                         f"not fit the kernel's 48 KiB of shared memory")


def edge_spmv_call(s_pre: torch.Tensor, src_idx: torch.Tensor,
                   dst_local: torch.Tensor, block_tile: torch.Tensor,
                   tile_first_block: torch.Tensor,
                   tile_num_blocks: torch.Tensor,
                   weights: torch.Tensor | None = None, *, n: int,
                   tile: int) -> torch.Tensor:
    """The bare push over a device edge-tile format.

    Args:
      s_pre: f[1, n_gather] gather source, zero from index n on.
      src_idx / dst_local: i32[num_blocks, e1, e2] (sentinel source n).
      block_tile: i32[num_blocks]; tile_first_block / tile_num_blocks:
        i32[num_tiles], each tile's contiguous block range.
      weights: optional f[num_blocks, e1, e2] per-edge weights.

    Returns:
      f[1, num_tiles * tile]; the caller slices ``[:, :n]``.
    """
    num_tiles = tile_first_block.shape[0]
    if s_pre.device.type == "cpu":
        return edge_spmv_plain(s_pre, src_idx, dst_local, block_tile, weights,
                               tile=tile, num_tiles=num_tiles)
    if s_pre.device.type != "cuda":
        raise ValueError(f"edge_spmv runs on cuda or cpu; got {s_pre.device}")
    _check_inputs(s_pre, src_idx, dst_local, tile_first_block,
                  tile_num_blocks, weights, n, tile)
    out = torch.empty(1, num_tiles * tile, dtype=s_pre.dtype,
                      device=s_pre.device)
    symbol = ("repro_edge_spmv_f32" if s_pre.dtype == torch.float32
              else "repro_edge_spmv_f64")
    fn = _build.entry("edge_spmv", symbol, _ARGTYPES)
    with torch.cuda.device(s_pre.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre.data_ptr(), n, src_idx.data_ptr(),
                    dst_local.data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    tile_first_block.data_ptr(), tile_num_blocks.data_ptr(),
                    out.data_ptr(), num_tiles, tile, src_idx[0].numel(),
                    stream)
    _build.check("edge_spmv", status)
    edge_spmv_call.launches += 1
    return out


edge_spmv_call.launches = 0
