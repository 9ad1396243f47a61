"""Block-sparse-row push and fused BSR step: CUDA kernels and plain versions.

``t = s_preᵀ A`` where A is stored as dense ``ts × td`` tiles with a
dst-major block table (:class:`repro_torch.kernels.formats.BsrFormat`). The
tiles are stored in the working type T or, where every cell is an integer
in [0, 255] (the ψ regime's edge counts), in ``uint8``; both give the same
bits. :func:`bsr_spmv_call` (the bare push) and :func:`bsr_step_call` (one
fused Alg. 2 step, ``s' = μ ⊙ push(s ⊙ 1/w) + c`` and the gap ‖s' − s‖₁)
launch ``csrc/bsr_spmv.cu`` on a CUDA tensor (and count the launch in their
``launches``) and run :func:`bsr_spmv_plain` / :func:`bsr_step_plain`, the
same functions in plain PyTorch, on a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .power_step import _ticket

__all__ = ["bsr_spmv_call", "bsr_spmv_plain", "bsr_step_call",
           "bsr_step_plain"]

_SPMV_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
_STEP_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int]
                  + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])


def bsr_spmv_plain(s_pre_pad: torch.Tensor, tiles: torch.Tensor,
                   src_tile: torch.Tensor, dst_tile: torch.Tensor, *,
                   num_dst_tiles: int) -> torch.Tensor:
    """The plain PyTorch version: one batched tile product per stored block
    (tiles in ``uint8`` taken in ``s_pre_pad``'s type), summed into its dst
    tile. Returns f[1, num_dst_tiles * td]."""
    num_blocks, ts, td = tiles.shape
    tiles = tiles.to(s_pre_pad.dtype)
    seg = s_pre_pad[0].reshape(-1, ts)[src_tile.long()]          # [B, ts]
    prod = torch.bmm(seg[:, None, :], tiles)[:, 0, :]             # [B, td]
    out = torch.zeros(num_dst_tiles, td, dtype=tiles.dtype,
                      device=tiles.device)
    out.index_add_(0, dst_tile.long(), prod)
    return out.reshape(1, -1)


def bsr_step_plain(s: torch.Tensor, inv_w: torch.Tensor, mu: torch.Tensor,
                   c: torch.Tensor, tiles: torch.Tensor,
                   src_tile: torch.Tensor, dst_tile: torch.Tensor, *,
                   n_src_pad: int,
                   num_dst_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the fused step over f[n] node vectors:
    ``s ⊙ 1/w`` zero-padded to ``n_src_pad``, the plain push, then
    ``μ ⊙ t + c`` and ``Σ|s' − s|``."""
    n = s.shape[0]
    s_pre = F.pad(s * inv_w, (0, n_src_pad - n))[None, :]
    t = bsr_spmv_plain(s_pre, tiles, src_tile, dst_tile,
                       num_dst_tiles=num_dst_tiles)[0, :n]
    s_new = mu * t + c
    return s_new, torch.sum(torch.abs(s_new - s))


def _cols(td: int) -> int:
    """Output columns a thread of the kernel owns (``cols_for`` in
    ``csrc/bsr_spmv.cu``): 4 where td is a multiple of 128, else 2 where it
    is a multiple of 64, else 1."""
    return 4 if td % 128 == 0 else 2 if td % 64 == 0 else 1


def _check_inputs(name, dtype, dev, tiles, tables, num_dst_tiles) -> None:
    """Raise on what the kernel does not take."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64; got {dtype}")
    if tiles.device != dev or tiles.dtype not in (dtype, torch.uint8) or \
            not tiles.is_contiguous() or tiles.dim() != 3:
        raise ValueError(f"{name}: tiles must be a contiguous [blocks, ts, "
                         f"td] {dtype} or uint8 tensor on {dev}; got "
                         f"{tiles.dtype} {tuple(tiles.shape)} on "
                         f"{tiles.device}")
    if tiles.data_ptr() % 16:
        raise ValueError(f"{name}: tiles must start on a 16-byte boundary")
    for tname, x in tables:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be a contiguous int32 "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    _, ts, td = tiles.shape
    if td % 32 or not 32 <= td <= 1024 * _cols(td):
        raise ValueError(f"{name}: td must be a multiple of 32 with at most "
                         f"1024 threads of {_cols(td)} columns; got {td}")
    if (ts + 32) * torch.finfo(dtype).bits // 8 > 48 * 1024:
        raise ValueError(f"{name}: ts={ts} does not fit shared memory")
    if any(x.shape != (num_dst_tiles,) for tname, x in tables
           if tname.startswith("dst_")):
        raise ValueError(f"{name}: block ranges must have one entry per "
                         f"dst tile")


def _check_vector(name, x, tname, dtype, dev, shape) -> None:
    if x.device != dev or x.dtype != dtype or not x.is_contiguous() or \
            x.shape != shape:
        raise ValueError(f"{name}: {tname} must be a contiguous {dtype} "
                         f"tensor of shape {shape} on {dev}; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _symbol(kind: str, dtype: torch.dtype) -> str:
    return f"repro_bsr_{kind}_{'f32' if dtype == torch.float32 else 'f64'}"


def bsr_spmv_call(s_pre_pad: torch.Tensor, tiles: torch.Tensor,
                  src_tile: torch.Tensor, dst_tile: torch.Tensor,
                  dst_first_block: torch.Tensor, dst_num_blocks: torch.Tensor,
                  *, num_dst_tiles: int) -> torch.Tensor:
    """``t = s_preᵀ A`` over a device BSR format.

    Args:
      s_pre_pad: f[1, n_src_pad] input vector (already × 1/w).
      tiles: f[num_blocks, ts, td] (or uint8) packed dense tiles, dst-major.
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
    dtype, dev = s_pre_pad.dtype, s_pre_pad.device
    _check_inputs("bsr_spmv", dtype, dev, tiles,
                  (("src_tile", src_tile),
                   ("dst_first_block", dst_first_block),
                   ("dst_num_blocks", dst_num_blocks)), num_dst_tiles)
    _, ts, td = tiles.shape
    if (s_pre_pad.dim() != 2 or s_pre_pad.shape[0] != 1
            or s_pre_pad.shape[1] % ts or not s_pre_pad.is_contiguous()):
        raise ValueError("bsr_spmv: s_pre_pad must be a contiguous "
                         "[1, n_src_tiles * ts]")
    out = torch.empty(1, num_dst_tiles * td, dtype=dtype, device=dev)
    fn = _build.entry("bsr_spmv", _symbol("spmv", dtype), _SPMV_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s_pre_pad.data_ptr(), tiles.data_ptr(),
                    int(tiles.dtype == torch.uint8), src_tile.data_ptr(),
                    dst_first_block.data_ptr(), dst_num_blocks.data_ptr(),
                    out.data_ptr(), num_dst_tiles, ts, td, stream)
    _build.check("bsr_spmv", status)
    bsr_spmv_call.launches += 1
    return out


bsr_spmv_call.launches = 0


def bsr_step_call(s: torch.Tensor, inv_w: torch.Tensor, mu: torch.Tensor,
                  c: torch.Tensor, tiles: torch.Tensor,
                  src_tile: torch.Tensor, dst_tile: torch.Tensor,
                  dst_first_block: torch.Tensor, dst_num_blocks: torch.Tensor,
                  *, n_src_pad: int,
                  num_dst_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Alg. 2 step over a device BSR format, in one launch.

    Args:
      s / inv_w / mu / c: f[n] node vectors (node order, unpadded).
      tiles, src_tile, dst_tile, dst_first_block, dst_num_blocks: as for
        :func:`bsr_spmv_call`; ``n_src_pad`` = source tiles × ts.

    Returns:
      (s_new f[n] = μ ⊙ ((s ⊙ 1/w)ᵀ A) + c, gap 0-dim ‖s_new − s‖₁).
      ``s_new`` is bitwise that composition on the same kernel's push.
    """
    if s.device.type == "cpu":
        return bsr_step_plain(s, inv_w, mu, c, tiles, src_tile, dst_tile,
                              n_src_pad=n_src_pad,
                              num_dst_tiles=num_dst_tiles)
    if s.device.type != "cuda":
        raise ValueError(f"bsr_step runs on cuda or cpu; got {s.device}")
    dtype, dev, n = s.dtype, s.device, s.shape[0]
    _check_inputs("bsr_step", dtype, dev, tiles,
                  (("src_tile", src_tile),
                   ("dst_first_block", dst_first_block),
                   ("dst_num_blocks", dst_num_blocks)), num_dst_tiles)
    for tname, x in (("s", s), ("inv_w", inv_w), ("mu", mu), ("c", c)):
        _check_vector("bsr_step", x, tname, dtype, dev, (n,))
    _, ts, td = tiles.shape
    if n > min(n_src_pad, num_dst_tiles * td):
        raise ValueError(f"bsr_step: n={n} exceeds the format's padded "
                         f"sizes")
    s_new = torch.empty_like(s)
    partial = torch.empty(num_dst_tiles, dtype=dtype, device=dev)
    gap = torch.empty((), dtype=dtype, device=dev)
    fn = _build.entry("bsr_spmv", _symbol("step", dtype), _STEP_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(s.data_ptr(), inv_w.data_ptr(), n, tiles.data_ptr(),
                    int(tiles.dtype == torch.uint8), src_tile.data_ptr(),
                    dst_first_block.data_ptr(), dst_num_blocks.data_ptr(),
                    mu.data_ptr(), c.data_ptr(), s_new.data_ptr(),
                    partial.data_ptr(), gap.data_ptr(),
                    _ticket(dev, stream).data_ptr(), num_dst_tiles, ts, td,
                    stream)
    _build.check("bsr_spmv", status)
    bsr_step_call.launches += 1
    return s_new, gap


bsr_step_call.launches = 0
