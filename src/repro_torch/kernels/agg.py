"""Segment sums of rows through the ``seg_mm`` kernel: the layout of a set
of (sender, receiver) pairs and the sum over it.

:func:`edge_agg` builds, on the host, the edge-tile format of the pairs
whose receiver lies in ``[0, n)`` (the rest, the sentinel, are dropped) and
carries it to a device as an :class:`EdgeAgg`; :func:`seg_sum` sums rows in
the format's slot order onto the receivers through
:func:`repro_torch.kernels.ops.seg_mm`. The GNN family aggregates messages
onto nodes with them (``models/gnn/common.py``), the recsys family sums
embedding bags (``models/recsys/embedding.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.structure import Graph
from . import ops
from .formats import build_edge_tiles
from .ops import DeviceEdgeTiles

__all__ = ["DEFAULT_TILES", "EdgeAgg", "edge_agg", "seg_sum"]

# (tile, e1, e2) of the aggregation format. At the minibatch_lg shape
# (1,024 seeds, fanout (15, 10)) it pads the 168,960 real edges to ~1.34x
# their count in slots, where the JAX kernel test's (128, 8, 128) pads them
# 8x. seg_mm skips the padding past each tile's last real slot, and on an
# H100 its time at d = 602 moves by under 2% between tiles 256, 512 and
# 1024 (chip_smoke.py phase 8); a row's sum, and so every bit, does not
# depend on the tile.
DEFAULT_TILES = (512, 2, 128)


@dataclasses.dataclass(frozen=True)
class EdgeAgg:
    """The edge-tile format of a batch's real edges, on a device.

    ``fmt.src_idx`` holds the senders (sentinel ``n`` in padding slots), so
    messages gather straight into the blocked layout. ``edge_ids`` lists,
    in slot order, the position of each real edge in the edge arrays the
    format was built from, and ``slots`` the flat slot it occupies. The
    real slots of a tile come first, so ``tile_span``, each tile's count of
    real edges, is where its padding starts: ``seg_mm`` reads no slot past
    it."""

    fmt: DeviceEdgeTiles
    edge_ids: torch.Tensor       # i64[e_real]
    slots: torch.Tensor          # i64[e_real]
    in_degree: torch.Tensor      # i64[n]: real edges into each node
    tile_span: torch.Tensor      # i32[num_tiles]: real slots of each tile

    @property
    def num_slots(self) -> int:
        return self.fmt.src_idx.numel()

    @property
    def padding(self) -> float:
        """Slots in the blocked layout per real edge."""
        return self.num_slots / max(1, self.edge_ids.numel())


def edge_agg(src, dst, n: int, *, tiles: tuple[int, int, int] = DEFAULT_TILES,
             device: str | torch.device = "cuda") -> EdgeAgg:
    """The :class:`EdgeAgg` of the edges ``src → dst`` (numpy, host) over
    ``n`` nodes. Edges with ``dst`` outside ``[0, n)`` (the sentinel) are
    dropped; the rest are stably sorted by ``dst``."""
    dev = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    real = np.flatnonzero((dst >= 0) & (dst < n))
    ids = real[np.argsort(dst[real], kind="stable")]
    tile, e1, e2 = tiles
    fmt_h = build_edge_tiles(Graph(n, src[ids], dst[ids]), tile=tile, e1=e1,
                             e2=e2)
    # build_edge_tiles places the k-th edge (dst order) in the k-th real slot
    slots = np.flatnonzero(fmt_h.src_idx.reshape(-1) != n)
    span = np.bincount(dst[real] // tile, minlength=fmt_h.num_tiles)
    return EdgeAgg(fmt=DeviceEdgeTiles.from_format(fmt_h, dev),
                   edge_ids=torch.as_tensor(ids, device=dev),
                   slots=torch.as_tensor(slots, device=dev),
                   in_degree=torch.as_tensor(
                       np.bincount(dst[real], minlength=n), device=dev),
                   tile_span=torch.as_tensor(span.astype(np.int32),
                                             device=dev))


def seg_sum(msgs: torch.Tensor, agg: EdgeAgg) -> torch.Tensor:
    """f[num_slots, d] in slot order → f[n, d] through ``seg_mm``."""
    fmt = agg.fmt
    return ops.seg_mm(msgs.reshape(fmt.src_idx.shape[0], -1, msgs.shape[-1]),
                      fmt, tile_span=agg.tile_span)
