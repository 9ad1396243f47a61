"""Block-sparse-row push over packed dense tiles: CUDA kernel and plain version.

``t = s_preᵀ A`` where A is stored as dense ``ts × td`` tiles with a
dst-major block table (:class:`repro_torch.kernels.formats.BsrFormat`).
:func:`bsr_spmv_call` launches ``csrc/bsr_spmv.cu`` on a CUDA tensor (and
counts the launch in ``bsr_spmv_call.launches``) and runs
:func:`bsr_spmv_plain`, the same function in plain PyTorch, on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["bsr_spmv_call", "bsr_spmv_plain"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def bsr_spmv_plain(s_pre_pad: torch.Tensor, tiles: torch.Tensor,
                   src_tile: torch.Tensor, dst_tile: torch.Tensor, *,
                   num_dst_tiles: int) -> torch.Tensor:
    """The plain PyTorch version: one batched tile product per stored block,
    summed into its dst tile. Returns f[1, num_dst_tiles * td]."""
    num_blocks, ts, td = tiles.shape
    seg = s_pre_pad[0].reshape(-1, ts)[src_tile.long()]          # [B, ts]
    prod = torch.bmm(seg[:, None, :], tiles)[:, 0, :]             # [B, td]
    out = torch.zeros(num_dst_tiles, td, dtype=tiles.dtype,
                      device=tiles.device)
    out.index_add_(0, dst_tile.long(), prod)
    return out.reshape(1, -1)


def _check_inputs(s_pre_pad, tiles, src_tile, dst_first_block,
                  dst_num_blocks, num_dst_tiles) -> None:
    dev, dtype = s_pre_pad.device, s_pre_pad.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bsr_spmv takes float32 or float64; got {dtype}")
    for name, x, want in (("tiles", tiles, dtype),
                          ("src_tile", src_tile, torch.int32),
                          ("dst_first_block", dst_first_block, torch.int32),
                          ("dst_num_blocks", dst_num_blocks, torch.int32)):
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"bsr_spmv: {name} must be a contiguous {want} "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    if tiles.dim() != 3:
        raise ValueError("bsr_spmv: tiles must be [blocks, ts, td]")
    _, ts, td = tiles.shape
    if td % 32 or not 32 <= td <= 1024:
        raise ValueError(f"bsr_spmv: td must be a multiple of 32 in "
                         f"[32, 1024]; got {td}")
    if ts * s_pre_pad.element_size() > 48 * 1024:
        raise ValueError(f"bsr_spmv: ts={ts} does not fit shared memory")
    if (dst_first_block.shape != (num_dst_tiles,)
            or dst_num_blocks.shape != (num_dst_tiles,)):
        raise ValueError("bsr_spmv: block ranges must have one entry per "
                         "dst tile")
    if (s_pre_pad.dim() != 2 or s_pre_pad.shape[0] != 1
            or s_pre_pad.shape[1] % ts):
        raise ValueError("bsr_spmv: s_pre_pad must be [1, n_src_tiles * ts]")


def bsr_spmv_call(s_pre_pad: torch.Tensor, tiles: torch.Tensor,
                  src_tile: torch.Tensor, dst_tile: torch.Tensor,
                  dst_first_block: torch.Tensor, dst_num_blocks: torch.Tensor,
                  *, num_dst_tiles: int) -> torch.Tensor:
    """``t = s_preᵀ A`` over a device BSR format.

    Args:
      s_pre_pad: f[1, n_src_pad] input vector (already × 1/w).
      tiles: f[num_blocks, ts, td] packed dense tiles, dst-major.
      src_tile / dst_tile: i32[num_blocks] block table.
      dst_first_block / dst_num_blocks: i32[num_dst_tiles] block ranges.

    Returns:
      f[1, num_dst_tiles * td]; the caller slices ``[:, :n]``.
    """
    if s_pre_pad.device.type == "cpu":
        return bsr_spmv_plain(s_pre_pad, tiles, src_tile, dst_tile,
                              num_dst_tiles=num_dst_tiles)
    if s_pre_pad.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on cuda or cpu; got "
                         f"{s_pre_pad.device}")
    _check_inputs(s_pre_pad, tiles, src_tile, dst_first_block,
                  dst_num_blocks, num_dst_tiles)
    _, ts, td = tiles.shape
    out = torch.empty(1, num_dst_tiles * td, dtype=tiles.dtype,
                      device=tiles.device)
    symbol = ("repro_bsr_spmv_f32" if tiles.dtype == torch.float32
              else "repro_bsr_spmv_f64")
    fn = _build.entry("bsr_spmv", symbol, _ARGTYPES)
    with torch.cuda.device(s_pre_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre_pad.data_ptr(), tiles.data_ptr(),
                    src_tile.data_ptr(), dst_first_block.data_ptr(),
                    dst_num_blocks.data_ptr(), out.data_ptr(), num_dst_tiles,
                    ts, td, stream)
    _build.check("bsr_spmv", status)
    bsr_spmv_call.launches += 1
    return out


bsr_spmv_call.launches = 0
