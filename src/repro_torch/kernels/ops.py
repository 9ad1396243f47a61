"""Device formats and the public kernel wrappers.

``DeviceEdgeTiles`` / ``DeviceBsr`` hold the arrays of a host format that the
kernels and the engine read (the per-tile block ranges the CUDA kernels walk
among them) as tensors on an explicit device. The host formats' first/last
block flags stay on the host.
:func:`power_step`, :func:`edge_spmv` and :func:`bsr_spmv` keep the
signatures of the JAX package's wrappers; each launches its CUDA kernel on
a CUDA tensor and runs the plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .bsr_spmv import bsr_spmv_call
from .edge_spmv import edge_spmv_call
from .formats import BsrFormat, EdgeTileFormat
from .power_step import power_step_call

__all__ = ["DeviceEdgeTiles", "DeviceBsr", "power_step", "edge_spmv",
           "bsr_spmv"]


def _i32(x, device) -> torch.Tensor:
    """An int32 copy of ``x`` (array or list) on ``device``."""
    return torch.tensor(np.asarray(x, np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class DeviceEdgeTiles:
    """An :class:`EdgeTileFormat` on a device.

    ``n_gather = n_pad + 1``: one zero slot past the node tiles, so the
    sentinel source id ``n`` is a valid gather index even when
    ``n == n_pad`` (the plain version reads it; the kernel skips sentinel
    slots). Edge patches write into ``src_idx`` / ``dst_local`` in place.
    """

    n: int
    n_pad: int            # num_tiles * tile
    n_gather: int         # padded gather-source length (sentinel slot zero)
    tile: int
    e1: int
    e2: int
    num_tiles: int
    src_idx: torch.Tensor           # i32[num_blocks, e1, e2]
    dst_local: torch.Tensor         # i32[num_blocks, e1, e2]
    block_tile: torch.Tensor        # i32[num_blocks]
    tile_first_block: torch.Tensor  # i32[num_tiles]
    tile_num_blocks: torch.Tensor   # i32[num_tiles]

    @classmethod
    def from_format(cls, fmt: EdgeTileFormat,
                    device: str | torch.device = "cuda") -> "DeviceEdgeTiles":
        dev = resolve_device(device)
        n_pad = fmt.num_tiles * fmt.tile
        return cls(
            n=fmt.n, n_pad=n_pad, n_gather=n_pad + 1, tile=fmt.tile,
            e1=fmt.e1, e2=fmt.e2, num_tiles=fmt.num_tiles,
            src_idx=_i32(fmt.src_idx, dev), dst_local=_i32(fmt.dst_local, dev),
            block_tile=_i32(fmt.block_tile, dev),
            tile_first_block=_i32(fmt.tile_first_block, dev),
            tile_num_blocks=_i32(fmt.tile_num_blocks, dev))

    @property
    def device(self) -> torch.device:
        return self.src_idx.device

    def pad_gather_source(self, v: torch.Tensor) -> torch.Tensor:
        """f[n] → f[1, n_gather] with zeros beyond n (sentinel = n)."""
        return F.pad(v, (0, self.n_gather - v.shape[0]))[None, :]

    def pad_node_vector(self, v: torch.Tensor) -> torch.Tensor:
        return F.pad(v, (0, self.n_pad - v.shape[0]))[None, :]


@dataclasses.dataclass(frozen=True)
class DeviceBsr:
    """A :class:`BsrFormat` on a device; BSR edge patches add into
    ``tiles`` in place."""

    n: int
    n_src_pad: int
    ts: int
    td: int
    num_dst_tiles: int
    tiles: torch.Tensor             # f[num_blocks, ts, td]
    src_tile: torch.Tensor          # i32[num_blocks]
    dst_tile: torch.Tensor          # i32[num_blocks]
    dst_first_block: torch.Tensor   # i32[num_dst_tiles]
    dst_num_blocks: torch.Tensor    # i32[num_dst_tiles]

    @classmethod
    def from_format(cls, fmt: BsrFormat,
                    device: str | torch.device = "cuda") -> "DeviceBsr":
        dev = resolve_device(device)
        return cls(n=fmt.n, n_src_pad=fmt.n_src_pad, ts=fmt.ts, td=fmt.td,
                   num_dst_tiles=fmt.num_dst_tiles,
                   tiles=torch.tensor(fmt.tiles, device=dev),
                   src_tile=_i32(fmt.src_tile, dev),
                   dst_tile=_i32(fmt.dst_tile, dev),
                   dst_first_block=_i32(fmt.dst_first_block, dev),
                   dst_num_blocks=_i32(fmt.dst_num_blocks, dev))

    @property
    def device(self) -> torch.device:
        return self.tiles.device


def power_step(s: torch.Tensor, inv_w_gather: torch.Tensor,
               mu_pad: torch.Tensor, c_pad: torch.Tensor,
               fmt: DeviceEdgeTiles) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Alg. 2 step on padded [1, n_pad] node vectors.

    Args:
      s: f[1, n_pad] current series vector (padded layout).
      inv_w_gather: f[1, n_gather] 1/w in gather layout (zeros in pads).
      mu_pad / c_pad: f[1, n_pad].
    Returns:
      (s_new f[1, n_pad], gap 0-dim ‖Δs‖₁).
    """
    s_pre = F.pad(s, (0, fmt.n_gather - fmt.n_pad)) * inv_w_gather
    return power_step_call(
        s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
        fmt.tile_first_block, fmt.tile_num_blocks, mu_pad, c_pad, s,
        n=fmt.n, tile=fmt.tile)


def edge_spmv(s_pre: torch.Tensor, fmt: DeviceEdgeTiles,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """t_i = Σ_{(j→i)} w_e s_pre_j over the edge-tile format. ``weights``
    (optional) is f[num_blocks, e1, e2] in the slot layout. Returns f[n]."""
    out = edge_spmv_call(fmt.pad_gather_source(s_pre), fmt.src_idx,
                         fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                         fmt.tile_num_blocks, weights, n=fmt.n, tile=fmt.tile)
    return out[0, :fmt.n]


def bsr_spmv(s_pre: torch.Tensor, fmt: DeviceBsr) -> torch.Tensor:
    """t = s_preᵀ A over the dense tiles. Returns f[n]."""
    s_pad = F.pad(s_pre, (0, fmt.n_src_pad - s_pre.shape[0]))[None, :]
    out = bsr_spmv_call(s_pad, fmt.tiles, fmt.src_tile, fmt.dst_tile,
                        fmt.dst_first_block, fmt.dst_num_blocks,
                        num_dst_tiles=fmt.num_dst_tiles)
    return out[0, :fmt.n]
