"""Blocked segment-sum of feature rows (GNN aggregation): CUDA kernel, plain
version and autograd.

``Y[i] = Σ_{e: dst_e = i} M[e, :]`` over the blocked edge layout of
:mod:`repro_torch.kernels.formats`: ``messages[num_blocks, eblk, d]`` (zero
rows in padding slots), ``dst_local`` the row of each slot within its
block's node tile. :func:`seg_mm_call` launches ``csrc/seg_mm.cu`` on a CUDA
tensor (and counts the launch in ``seg_mm_call.launches``) and runs
:func:`seg_mm_plain`, the same function in plain PyTorch, on a CPU tensor.
It goes through the operator ``torch.ops.repro_torch.seg_mm`` (a
``torch.library.custom_op`` with a registered fake): a dispatch mode sees
one call with its inputs and its output, on FakeTensors as on real ones,
and a FakeTensor gets an empty output of the kernel's shape (nothing is
launched).
:class:`SegMM` makes it differentiable: the gradient of a message row is the
output gradient of its row, a plain gather (the JAX package differentiates
its ``segment_sum`` the same way, with no kernel).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["seg_mm_call", "seg_mm_plain", "SegMM"]

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _rows(dst_local: torch.Tensor, block_tile: torch.Tensor, tile: int,
          eblk: int) -> torch.Tensor:
    """i64[num_blocks * eblk]: the output row of every slot."""
    return (block_tile.long()[:, None] * tile
            + dst_local.reshape(-1, eblk).long()).reshape(-1)


def seg_mm_plain(messages: torch.Tensor, dst_local: torch.Tensor,
                 block_tile: torch.Tensor, *, tile: int,
                 num_tiles: int) -> torch.Tensor:
    """The plain PyTorch version (same inputs, same layout): an
    ``index_add_`` of every slot's row, padding slots included, into the
    node tiles. On the CPU it adds in slot order, as the kernel does.
    Returns f[num_tiles * tile, d]."""
    d = messages.shape[-1]
    out = torch.zeros(num_tiles * tile, d, dtype=messages.dtype,
                      device=messages.device)
    out.index_add_(0, _rows(dst_local, block_tile, tile, messages.shape[1]),
                   messages.reshape(-1, d))
    return out


def _check_inputs(messages, dst_local, tile_first_block, tile_num_blocks,
                  tile_span, tile) -> None:
    dev, dtype = messages.device, messages.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"seg_mm takes float32 or float64; got {dtype}")
    named = [("messages", messages, dtype), ("dst_local", dst_local,
                                             torch.int32),
             ("tile_first_block", tile_first_block, torch.int32),
             ("tile_num_blocks", tile_num_blocks, torch.int32)]
    if tile_span is not None:
        named.append(("tile_span", tile_span, torch.int32))
    for name, x, want in named:
        if x.device != dev or x.dtype != want or not x.is_contiguous():
            raise ValueError(f"seg_mm: {name} must be a contiguous {want} "
                             f"tensor on {dev}; got {x.dtype} on {x.device}")
    if messages.dim() != 3:
        raise ValueError(f"seg_mm: messages must be [num_blocks, eblk, d]; "
                         f"got {tuple(messages.shape)}")
    num_blocks, eblk, _ = messages.shape
    if dst_local.numel() != num_blocks * eblk or (
            dst_local.dim() and dst_local.shape[0] != num_blocks):
        raise ValueError(f"seg_mm: dst_local must hold [{num_blocks}, "
                         f"{eblk}] slots; got {tuple(dst_local.shape)}")
    if tile_num_blocks.shape != tile_first_block.shape or \
            tile_first_block.dim() != 1 or (
                tile_span is not None
                and tile_span.shape != tile_first_block.shape):
        raise ValueError("seg_mm: tile_first_block / tile_num_blocks / "
                         "tile_span must be matching [num_tiles] vectors")
    if tile < 1:
        raise ValueError(f"seg_mm: tile must be positive; got {tile}")


def _vector_width(messages: torch.Tensor) -> int:
    """Elements a lane loads at once: the most of 16 / 8 / 4 bytes (f32)
    or 16 / 8 (f64) that divides a row and the pointer's alignment."""
    elt, d = messages.element_size(), messages.shape[-1]
    for vec in (16 // elt, 8 // elt):
        if d % vec == 0 and messages.data_ptr() % (vec * elt) == 0:
            return vec
    return 1


@torch.library.custom_op(
    "repro_torch::seg_mm", mutates_args=(),
    schema="(Tensor messages, Tensor dst_local, Tensor block_tile, "
           "Tensor tile_first_block, Tensor tile_num_blocks, int tile, "
           "Tensor? tile_span) -> Tensor")
def _seg_mm_op(messages, dst_local, block_tile, tile_first_block,
               tile_num_blocks, tile, tile_span):
    """The operator behind :func:`seg_mm_call` (its real implementation)."""
    num_tiles = tile_first_block.shape[0]
    if messages.device.type == "cpu":
        return seg_mm_plain(messages, dst_local, block_tile, tile=tile,
                            num_tiles=num_tiles)
    _check_inputs(messages, dst_local, tile_first_block, tile_num_blocks,
                  tile_span, tile)
    _, eblk, d = messages.shape
    out = torch.empty(num_tiles * tile, d, dtype=messages.dtype,
                      device=messages.device)
    if out.numel() == 0:
        return out
    symbol = ("repro_seg_mm_f32" if messages.dtype == torch.float32
              else "repro_seg_mm_f64")
    fn = _build.entry("seg_mm", symbol, _ARGTYPES)
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(messages.data_ptr(), dst_local.data_ptr(),
                    tile_first_block.data_ptr(), tile_num_blocks.data_ptr(),
                    None if tile_span is None else tile_span.data_ptr(),
                    out.data_ptr(), num_tiles, tile, eblk, d,
                    _vector_width(messages), stream)
    _build.check("seg_mm", status)
    seg_mm_call.launches += 1
    return out


@_seg_mm_op.register_fake
def _seg_mm_fake(messages, dst_local, block_tile, tile_first_block,
                 tile_num_blocks, tile, tile_span):
    return messages.new_empty(tile_first_block.shape[0] * tile,
                              messages.shape[-1])


def seg_mm_call(messages: torch.Tensor, dst_local: torch.Tensor,
                block_tile: torch.Tensor, tile_first_block: torch.Tensor,
                tile_num_blocks: torch.Tensor, *, tile: int,
                tile_span: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked segment-sum of message rows over a device edge-tile format.

    Args:
      messages: f[num_blocks, eblk, d], f32 or f64, in the format's slot
        order (padding rows zero). Any slot order within a tile is taken.
      dst_local: i32[num_blocks, eblk] (or [num_blocks, e1, e2]): each
        slot's row within its block's node tile.
      block_tile: i32[num_blocks]; tile_first_block / tile_num_blocks:
        i32[num_tiles], each tile's contiguous block range (the kernel reads
        the ranges, the plain version ``block_tile``).
      tile_span: optional i32[num_tiles], the slots of each tile's range up
        to its last real slot (:func:`~repro_torch.kernels.formats.
        tile_spans`); the kernel does not read the padding past it. Without
        it every slot is read. It moves no bit of the result.

    Returns:
      f[num_tiles * tile, d]; zeros for a tile without blocks. On
      FakeTensors an empty output of that shape (nothing is launched).
    """
    if messages.device.type not in ("cuda", "cpu"):   # meta: no fake here
        raise ValueError(f"seg_mm runs on cuda or cpu; got {messages.device}")
    return _seg_mm_op(messages, dst_local, block_tile, tile_first_block,
                      tile_num_blocks, tile, tile_span)


seg_mm_call.launches = 0


class SegMM(torch.autograd.Function):
    """Differentiable :func:`seg_mm_call`. Backward: ``dM[b, k, :] =
    dY[block_tile[b] * tile + dst_local[b, k], :]``, a plain gather."""

    @staticmethod
    def forward(ctx, messages, dst_local, block_tile, tile_first_block,
                tile_num_blocks, tile, tile_span=None):
        ctx.save_for_backward(dst_local, block_tile)
        ctx.tile = tile
        ctx.shape = messages.shape
        return seg_mm_call(messages, dst_local, block_tile, tile_first_block,
                           tile_num_blocks, tile=tile, tile_span=tile_span)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        dst_local, block_tile = ctx.saved_tensors
        rows = _rows(dst_local, block_tile, ctx.tile, ctx.shape[1])
        grad = grad_out.index_select(0, rows).reshape(ctx.shape)
        return (grad,) + (None,) * 6
