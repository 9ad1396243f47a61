"""Device formats and the public kernel wrappers.

``DeviceEdgeTiles`` / ``DeviceBsr`` hold the arrays of a host format that the
kernels and the engine read (the per-tile block ranges the CUDA kernels walk
among them) as tensors on an explicit device. The host formats' first/last
block flags stay on the host.
:func:`power_step`, :func:`edge_spmv`, :func:`bsr_spmv` and :func:`seg_mm`
keep the signatures of the JAX package's wrappers; :func:`bsr_step` is the
BSR regime's fused step. Each launches its CUDA kernel on a CUDA tensor and
runs the plain PyTorch version on a CPU tensor.

The multi-tenant fleet stacks same-shape edge-tile formats along a leading
lane axis (:meth:`DeviceEdgeTiles.stack`); :func:`power_step_lanes` and
:func:`edge_spmv_lanes` step or push every lane in one launch, which is
what the JAX package's ``power_step`` / ``edge_spmv`` compute under
``jax.vmap``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .bsr_spmv import bsr_spmv_call, bsr_step_call
from .edge_spmv import edge_spmv_call, edge_spmv_lanes_call, heavy_first
from .formats import BsrFormat, EdgeTileFormat
from .power_step import (power_step_call, power_step_lanes_call,
                         row_path_plan)
from .seg_mm import SegMM

__all__ = ["DeviceEdgeTiles", "DeviceBsr", "power_step", "edge_spmv",
           "power_step_lanes", "edge_spmv_lanes", "bsr_spmv", "bsr_step",
           "seg_mm"]


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

    Lane-stacked (:meth:`stack`): every tensor gains a leading ``[L]`` —
    ``src_idx`` / ``dst_local`` i32[L, num_blocks, e1, e2], ``block_tile``
    i32[L, num_blocks], the tile tables and ``tile_order`` i32[L,
    num_tiles], each lane's own — and the sizes are shared by every lane.

    The step kernel's plan (:func:`~.power_step.row_path_plan`, every
    lane's own): ``row_start`` i32[num_tiles * tile] and ``tile_row_slots``
    i32[num_tiles] (``[L, ...]`` stacked), added by :meth:`with_row_plan`
    where a format is built for the step (the ``cuda`` engine, the fleet)
    and kept by :meth:`write_lane`; an edge patch sends the tiles it writes
    to the ring (:meth:`take_ring`). A format without one (None: as
    :meth:`from_format` and :meth:`stack` make it, for the push and the
    aggregation, which never read it) steps every tile through the ring.
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
    tile_order: torch.Tensor        # i32[num_tiles], a permutation
    row_start: torch.Tensor | None = None       # i32[num_tiles * tile]
    tile_row_slots: torch.Tensor | None = None  # i32[num_tiles]
    row_path_share: float = 0.0     # the plan's share of the real slots

    @classmethod
    def from_format(cls, fmt: EdgeTileFormat,
                    device: str | torch.device = "cuda") -> "DeviceEdgeTiles":
        dev = resolve_device(device)
        n_pad = fmt.num_tiles * fmt.tile
        num_blocks = _i32(fmt.tile_num_blocks, dev)
        return cls(
            n=fmt.n, n_pad=n_pad, n_gather=n_pad + 1, tile=fmt.tile,
            e1=fmt.e1, e2=fmt.e2, num_tiles=fmt.num_tiles,
            src_idx=_i32(fmt.src_idx, dev), dst_local=_i32(fmt.dst_local, dev),
            block_tile=_i32(fmt.block_tile, dev),
            tile_first_block=_i32(fmt.tile_first_block, dev),
            tile_num_blocks=num_blocks, tile_order=heavy_first(num_blocks))

    @classmethod
    def stack(cls, fmts: list[EdgeTileFormat],
              device: str | torch.device = "cuda") -> "DeviceEdgeTiles":
        """Lane ℓ holds ``fmts[ℓ]``; every format must share ``n``, the
        tile shape and the block count (``pad_edge_tile_blocks``)."""
        dev = resolve_device(device)
        ref = fmts[0]
        shape = (ref.n, ref.tile, ref.e1, ref.e2, ref.num_tiles,
                 ref.num_blocks)
        for f in fmts:
            if (f.n, f.tile, f.e1, f.e2, f.num_tiles, f.num_blocks) != shape:
                raise ValueError("stacked edge-tile formats must share n, "
                                 "tile, e1, e2, num_tiles and num_blocks")
        n_pad = ref.num_tiles * ref.tile
        num_blocks = _i32(np.stack([f.tile_num_blocks for f in fmts]), dev)
        return cls(
            n=ref.n, n_pad=n_pad, n_gather=n_pad + 1, tile=ref.tile,
            e1=ref.e1, e2=ref.e2, num_tiles=ref.num_tiles,
            src_idx=_i32(np.stack([f.src_idx for f in fmts]), dev),
            dst_local=_i32(np.stack([f.dst_local for f in fmts]), dev),
            block_tile=_i32(np.stack([f.block_tile for f in fmts]), dev),
            tile_first_block=_i32(
                np.stack([f.tile_first_block for f in fmts]), dev),
            tile_num_blocks=num_blocks, tile_order=heavy_first(num_blocks))

    def _plans(self, stage: int | None) -> list:
        """The plan of each lane (one for a single-lane format)."""
        arrays = (self.src_idx, self.dst_local, self.block_tile,
                  self.tile_first_block)
        lanes = [arrays] if self.src_idx.dim() == 3 else zip(*arrays)
        return [row_path_plan(*lane, n=self.n, tile=self.tile, stage=stage)
                for lane in lanes]

    def with_row_plan(self, stage: int | None = None) -> "DeviceEdgeTiles":
        """This format with the step kernel's plan at ``stage`` (the ring's
        stage when None), every lane's own, and ``row_path_share``, the
        share of its real slots whose tile takes the row path, counted
        here (:func:`power_step` launches a single-lane format whose share
        is 0 without its plan, with the ring's shared memory)."""
        plans = self._plans(stage)
        on_rows, real = torch.stack([torch.stack(
            [p.tile_row_slots.sum(), p.real_slots.sum()])
            for p in plans]).sum(0).tolist()
        if self.src_idx.dim() == 3:
            row_start, row_slots = plans[0].row_start, plans[0].tile_row_slots
        else:
            row_start = torch.stack([p.row_start for p in plans])
            row_slots = torch.stack([p.tile_row_slots for p in plans])
        return dataclasses.replace(self, row_start=row_start,
                                   tile_row_slots=row_slots,
                                   row_path_share=on_rows / real if real
                                   else 0.0)

    def take_ring(self, tiles) -> None:
        """Send ``tiles`` (tile ids of a single-lane format) to the ring in
        place: an in-place edge patch writes slots after a tile's sorted
        ones, out of the row path's order."""
        if self.tile_row_slots is not None and len(tiles):
            self.tile_row_slots[torch.as_tensor(
                np.asarray(tiles, np.int64), device=self.device)] = 0

    def write_lane(self, lane: int, fmt: EdgeTileFormat) -> None:
        """Overwrite lane ``lane`` of a stacked format in place with
        ``fmt`` (same shape), its plan too; the other lanes are not
        touched."""
        one = DeviceEdgeTiles.stack([fmt], self.device)
        if one.src_idx.shape[1:] != self.src_idx.shape[1:] \
                or one.n != self.n:
            raise ValueError("write_lane: the format's shape differs from "
                             "the stack's")
        names = ["src_idx", "dst_local", "block_tile", "tile_first_block",
                 "tile_num_blocks", "tile_order"]
        if self.row_start is not None:
            one = one.with_row_plan()
            names += ["row_start", "tile_row_slots"]
        for name in names:
            getattr(self, name)[lane] = getattr(one, name)[0]

    @property
    def device(self) -> torch.device:
        return self.src_idx.device

    def pad_gather_source(self, v: torch.Tensor) -> torch.Tensor:
        """f[n] → f[1, n_gather] with zeros beyond n (sentinel = n); a
        stacked f[L, n] → f[L, 1, n_gather]."""
        return F.pad(v, (0, self.n_gather - v.shape[-1])).unsqueeze(-2)

    def pad_node_vector(self, v: torch.Tensor) -> torch.Tensor:
        """f[n] → f[1, n_pad]; a stacked f[L, n] → f[L, 1, n_pad]."""
        return F.pad(v, (0, self.n_pad - v.shape[-1])).unsqueeze(-2)


def narrow_tiles(tiles: np.ndarray) -> np.ndarray:
    """``tiles`` as ``uint8`` where every cell is an integer in [0, 255]
    (edge counts: the ψ regime builds its tiles so), else ``tiles``. The
    kernels convert a cell to the working type exactly, so both storages
    give the same bits."""
    small = tiles.astype(np.uint8)
    return small if np.array_equal(small, tiles) else tiles


@dataclasses.dataclass(frozen=True)
class DeviceBsr:
    """A :class:`BsrFormat` on a device. ``tiles`` is stored as
    :func:`narrow_tiles` chooses (one byte a cell for edge counts); BSR edge
    patches write into it in place."""

    n: int
    n_src_pad: int
    ts: int
    td: int
    num_dst_tiles: int
    tiles: torch.Tensor             # u8 or f[num_blocks, ts, td]
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
                   tiles=torch.tensor(narrow_tiles(fmt.tiles), device=dev),
                   src_tile=_i32(fmt.src_tile, dev),
                   dst_tile=_i32(fmt.dst_tile, dev),
                   dst_first_block=_i32(fmt.dst_first_block, dev),
                   dst_num_blocks=_i32(fmt.dst_num_blocks, dev))

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def pad_source(self, v: torch.Tensor) -> torch.Tensor:
        """f[n] → f[1, n_src_pad] with zeros beyond n."""
        return F.pad(v, (0, self.n_src_pad - v.shape[0]))[None, :]


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
    rows = fmt.row_path_share > 0
    return power_step_call(
        s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
        fmt.tile_first_block, fmt.tile_num_blocks, mu_pad, c_pad, s,
        n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order,
        row_start=fmt.row_start if rows else None,
        tile_row_slots=fmt.tile_row_slots if rows else None)


def edge_spmv(s_pre: torch.Tensor, fmt: DeviceEdgeTiles,
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """t_i = Σ_{(j→i)} w_e s_pre_j over the edge-tile format. ``weights``
    (optional) is f[num_blocks, e1, e2] in the slot layout. Returns f[n]."""
    out = edge_spmv_call(fmt.pad_gather_source(s_pre), fmt.src_idx,
                         fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                         fmt.tile_num_blocks, weights, n=fmt.n, tile=fmt.tile,
                         tile_order=fmt.tile_order)
    return out[0, :fmt.n]


def power_step_lanes(s: torch.Tensor, inv_w_gather: torch.Tensor,
                     mu_pad: torch.Tensor, c_pad: torch.Tensor,
                     fmt: DeviceEdgeTiles
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`power_step` for every lane of a stacked format in one launch.

    Args:
      s: f[L, 1, n_pad]; inv_w_gather: f[L, 1, n_gather];
      mu_pad / c_pad: f[L, 1, n_pad].
    Returns:
      (s_new f[L, 1, n_pad], gap f[L]).
    """
    s_pre = F.pad(s, (0, fmt.n_gather - fmt.n_pad)) * inv_w_gather
    return power_step_lanes_call(
        s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
        fmt.tile_first_block, fmt.tile_num_blocks, mu_pad, c_pad, s,
        n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order,
        row_start=fmt.row_start, tile_row_slots=fmt.tile_row_slots)


def edge_spmv_lanes(s_pre: torch.Tensor, fmt: DeviceEdgeTiles,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`edge_spmv` for every lane of a stacked format in one launch:
    ``s_pre`` f[L, n] → f[L, n]."""
    out = edge_spmv_lanes_call(
        fmt.pad_gather_source(s_pre), fmt.src_idx, fmt.dst_local,
        fmt.block_tile, fmt.tile_first_block, fmt.tile_num_blocks, weights,
        n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
    return out[:, 0, :fmt.n]


def bsr_spmv(s_pre: torch.Tensor, fmt: DeviceBsr) -> torch.Tensor:
    """t = s_preᵀ A over the dense tiles. Returns f[n]."""
    out = bsr_spmv_call(fmt.pad_source(s_pre), fmt.tiles, fmt.src_tile,
                        fmt.dst_tile, fmt.dst_first_block,
                        fmt.dst_num_blocks, num_dst_tiles=fmt.num_dst_tiles)
    return out[0, :fmt.n]


def bsr_step(s: torch.Tensor, inv_w: torch.Tensor, mu: torch.Tensor,
             c: torch.Tensor,
             fmt: DeviceBsr) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused Alg. 2 step over the dense tiles on f[n] node vectors:
    (s_new = μ ⊙ ((s ⊙ 1/w)ᵀ A) + c, gap ‖s_new − s‖₁)."""
    return bsr_step_call(s, inv_w, mu, c, fmt.tiles, fmt.src_tile,
                         fmt.dst_tile, fmt.dst_first_block,
                         fmt.dst_num_blocks, n_src_pad=fmt.n_src_pad,
                         num_dst_tiles=fmt.num_dst_tiles)


def seg_mm(messages: torch.Tensor, fmt: DeviceEdgeTiles, *,
           tile_span: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked segment-sum of rows, differentiable in ``messages``.
    messages: f[num_blocks, e1*e2, d] in the fmt's padded edge order
    (padding rows zero). ``tile_span`` (optional, i32[num_tiles]): each
    tile's slots up to its last real one, past which the kernel reads no
    padding (see :func:`~repro_torch.kernels.seg_mm.seg_mm_call`). Returns
    f[n, d]."""
    out = SegMM.apply(messages, fmt.dst_local, fmt.block_tile,
                      fmt.tile_first_block, fmt.tile_num_blocks, fmt.tile,
                      tile_span)
    return out[:fmt.n]
