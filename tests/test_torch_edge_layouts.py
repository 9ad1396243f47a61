"""Edge-tile slot layouts the kernels must take, and the kernels' shared
memory footprint.

:func:`edge_tile_layout` builds the layouts that ``tests/test_torch_cuda.py``
holds the ``power_step`` and ``edge_spmv`` kernels to on the card; here, on
the CPU, the wrappers run their plain versions on the same layouts and are
held against a float64 product of the graph's own edges (relative 1e-12).
The footprint tests pin the shared memory that the wrappers check to the
formula of ``csrc/edge_tile_scan.cuh``.

This file imports only the port (``test_torch_cuda.py`` imports it on the
card's machine, which has no JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.kernels.autotune import EDGE_TILE_CANDIDATES
from repro_torch.kernels.edge_spmv import (SMEM_LIMIT_BYTES, STAGE_BYTES,
                                           check_edge_tile_smem,
                                           edge_tile_smem_bytes, heavy_first,
                                           stage_blocks)
from repro_torch.kernels.formats import block_ranges, build_edge_tiles
from repro_torch.kernels.ops import DeviceEdgeTiles, edge_spmv, power_step

# shuffled: slots permuted within each tile's block range; patched: a cuda
# engine after patch_edges (new edges fill sentinel slots after each tile's
# dst-sorted edges); idle tile: a tile whose one block is all sentinel;
# empty tile: a tile with no blocks; hub: one node with more than 2 x eblk
# in-edges, so its run spans three or more blocks
KINDS = ("shuffled", "patched", "idle tile", "empty tile", "hub")
TILES = (128, 256, 512)
HUB, HUB_EDGES = 1234, 2600


def _device_format(n, tile, num_tiles, src, dstl, block_tile, e1=8, e2=128):
    """A DeviceEdgeTiles from host slot arrays [B, eblk] on the CPU."""
    first, count = block_ranges(block_tile, num_tiles)
    i32 = [torch.as_tensor(np.asarray(a, np.int32)) for a in
           (src.reshape(-1, e1, e2), dstl.reshape(-1, e1, e2), block_tile,
            first, count)]
    n_pad = num_tiles * tile
    return DeviceEdgeTiles(n=n, n_pad=n_pad, n_gather=n_pad + 1, tile=tile,
                           e1=e1, e2=e2, num_tiles=num_tiles, src_idx=i32[0],
                           dst_local=i32[1], block_tile=i32[2],
                           tile_first_block=i32[3], tile_num_blocks=i32[4],
                           tile_order=heavy_first(i32[4]))


def _to(fmt: DeviceEdgeTiles, device) -> DeviceEdgeTiles:
    return dataclasses.replace(fmt, **{
        k: getattr(fmt, k).to(device) for k in
        ("src_idx", "dst_local", "block_tile", "tile_first_block",
         "tile_num_blocks", "tile_order")})


def edge_tile_layout(kind: str, tile: int, device="cpu"):
    """``(graph, fmt)``: the graph whose edges the layout holds and a
    :class:`DeviceEdgeTiles` of layout ``kind`` (see :data:`KINDS`) at
    ``(tile, 8, 128)`` on ``device``."""
    if kind in ("idle tile", "empty tile"):    # nodes [tile, 2 tile): no edge
        g = tg.erdos_renyi(2000, 20000, seed=8)
        keep = (g.dst < tile) | (g.dst >= 2 * tile)
        g = tg.Graph(g.n, g.src[keep], g.dst[keep])
    else:
        g = tg.powerlaw_configuration(5000, 40000, seed=3)
    if kind == "hub":
        rng = np.random.default_rng(12)
        src = rng.choice(np.delete(np.arange(g.n), HUB), HUB_EDGES,
                         replace=False)
        g = tg.Graph(g.n, np.concatenate([g.src, src]),
                     np.concatenate([g.dst, np.full(HUB_EDGES, HUB)]))
    if kind == "patched":
        eng = tc.make_engine("cuda", graph=g, activity=tc.heterogeneous(
            g.n, seed=4), device=device, tile=tile)
        used = np.bincount(g.dst // tile, minlength=eng.fmt.num_tiles)
        free = eng.fmt_host.tile_num_blocks * eng.fmt_host.eblk - used
        rng = np.random.default_rng(13)
        roomy = np.flatnonzero(free >= 64)
        dst = np.minimum(rng.choice(roomy, 64) * tile
                         + rng.integers(0, tile, 64), g.n - 1)
        eng.patch_edges(rng.integers(0, g.n, 64), dst)
        assert eng.format_builds == 1           # patched in place
        return eng.graph, eng.fmt
    f = build_edge_tiles(g, tile=tile)
    src = f.src_idx.reshape(f.num_blocks, -1).copy()
    dstl = f.dst_local.reshape(f.num_blocks, -1).copy()
    block_tile = f.block_tile
    if kind == "shuffled":
        rng = np.random.default_rng(9)
        first, count = block_ranges(block_tile, f.num_tiles)
        for a, c in zip(first, count):
            perm = rng.permutation(c * f.eblk)
            span = slice(a, a + c)
            src[span] = src[span].reshape(-1)[perm].reshape(c, -1)
            dstl[span] = dstl[span].reshape(-1)[perm].reshape(c, -1)
    if kind == "empty tile":
        keep = block_tile != 1
        src, dstl, block_tile = src[keep], dstl[keep], block_tile[keep]
    return g, _to(_device_format(g.n, tile, f.num_tiles, src, dstl,
                                 block_tile), device)


def slot_weights(fmt: DeviceEdgeTiles, dtype, seed: int) -> torch.Tensor:
    """Random per-edge weights in the slot layout, 0 in sentinel slots."""
    w = np.random.default_rng(seed).uniform(0.5, 2.0,
                                            size=tuple(fmt.src_idx.shape))
    w[fmt.src_idx.cpu().numpy() == fmt.n] = 0.0
    return torch.as_tensor(w, dtype=dtype, device=fmt.device)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_layout_has_the_shape_its_kind_names(kind, tile):
    g, fmt = edge_tile_layout(kind, tile)
    eblk = fmt.e1 * fmt.e2
    src = fmt.src_idx.reshape(-1, eblk).numpy()
    dstl = fmt.dst_local.reshape(-1, eblk).numpy()
    counts = fmt.tile_num_blocks.numpy()
    real = src < fmt.n
    assert int(real.sum()) == g.m                  # every edge, once
    rows = (fmt.block_tile.numpy()[:, None] * tile + dstl)[real]
    np.testing.assert_array_equal(np.bincount(rows, minlength=fmt.n_pad)
                                  [:g.n], g.in_degree)
    if kind in ("shuffled", "patched"):   # rows out of order in some tile
        assert any(np.any(np.diff(dstl[a:a + c][real[a:a + c]]) < 0)
                   for a, c in zip(fmt.tile_first_block.numpy(), counts))
    elif kind == "idle tile":
        assert counts[1] == 1
        assert not real[int(fmt.tile_first_block[1])].any()
    elif kind == "empty tile":
        assert counts[1] == 0
    else:
        assert g.in_degree[HUB] > 2 * eblk
        assert counts[HUB // tile] >= 3


def _f64_push(g, s):
    return np.bincount(g.dst, weights=s[g.src], minlength=g.n)


# The plain versions (CPU tensors) on every layout against a float64 product
# of the graph's edges, summed in another order: relative 1e-12.
@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_edge_spmv_plain_matches_f64_product_at_every_slot_layout(kind,
                                                                  tile):
    g, fmt = edge_tile_layout(kind, tile)
    s = np.random.default_rng(1).uniform(size=g.n)
    out = edge_spmv(torch.as_tensor(s), fmt)
    ref = _f64_push(g, s)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-14)
    if kind in ("idle tile", "empty tile"):
        assert not out[tile:2 * tile].any()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", KINDS)
def test_power_step_plain_matches_f64_step_at_every_slot_layout(kind, tile):
    g, fmt = edge_tile_layout(kind, tile)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=4),
                             dtype=torch.float64, device="cpu")
    s = np.random.default_rng(2).uniform(size=g.n)
    s_new, gap = power_step(fmt.pad_node_vector(torch.as_tensor(s)),
                            fmt.pad_gather_source(ops.inv_w),
                            fmt.pad_node_vector(ops.mu),
                            fmt.pad_node_vector(ops.c), fmt)
    ref = (ops.mu.numpy() * _f64_push(g, s * ops.inv_w.numpy())
           + ops.c.numpy())
    np.testing.assert_allclose(s_new[0, :g.n].numpy(), ref, rtol=1e-12,
                               atol=1e-14)
    assert not s_new[0, g.n:].any()
    np.testing.assert_allclose(float(gap), np.abs(ref - s).sum(), rtol=1e-12)


# edge_tile_smem_bytes = eblk (2 elt + 2) + 32 elt + tile * tile / 16
# + 4 tile bytes: staged and grouped values, scratch, per-warp 16-bit row
# counts, 16-bit rows, 16-bit run bounds
@pytest.mark.parametrize("tile,e1,e2,elt,want", [
    (256, 8, 128, 4, 15_488), (128, 8, 128, 4, 11_904),
    (512, 8, 128, 4, 28_800), (256, 8, 128, 8, 23_808),
    (128, 8, 128, 8, 20_224), (512, 8, 128, 8, 37_120),
    (512, 16, 128, 8, 55_552), (1024, 8, 128, 8, 88_320)])
def test_edge_tile_smem_bytes_is_the_kernel_layout(tile, e1, e2, elt, want):
    assert edge_tile_smem_bytes(tile, e1 * e2, elt) == want
    assert edge_tile_smem_bytes(tile, e1 * e2, elt, 2) == (
        want + e1 * e2 * (2 * elt + 2))
    check_edge_tile_smem("power_step", tile, e1 * e2, elt)    # fits


# The autotuner's candidates (eblk 1024) stage the most of 4, 2, 1 blocks at
# once that fit 48 KB: the slots take 10 bytes each at f32, 18 at f64.
@pytest.mark.parametrize("dtype,want", [(torch.float32, {128: 4, 256: 4,
                                                         512: 2}),
                                        (torch.float64, {128: 2, 256: 2,
                                                         512: 1})])
def test_autotuner_candidates_fit_the_kernels(dtype, want):
    elt = torch.tensor([], dtype=dtype).element_size()
    for tile, e1, e2 in EDGE_TILE_CANDIDATES:
        sblk = stage_blocks(tile, e1 * e2, elt)
        assert sblk == want[tile]
        assert check_edge_tile_smem("edge_spmv", tile, e1 * e2, elt) == sblk
        assert edge_tile_smem_bytes(tile, e1 * e2, elt, sblk) <= STAGE_BYTES
        if sblk < 4:
            assert edge_tile_smem_bytes(tile, e1 * e2, elt,
                                        2 * sblk) > STAGE_BYTES


def test_edge_tile_smem_check_raises_when_it_does_not_fit():
    need = edge_tile_smem_bytes(1024, 16 * 1024, 8)
    assert need > SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        check_edge_tile_smem("edge_spmv", 1024, 16 * 1024, 8)


def test_heavy_first_orders_tiles_by_block_count_and_follows_writes():
    counts = torch.tensor([1, 3, 1, 5, 3, 0], dtype=torch.int32)
    order = heavy_first(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    counts[5] = 9                                      # an in-place write
    assert heavy_first(counts).tolist() == [5, 3, 1, 4, 0, 2]


@pytest.mark.parametrize("kind", KINDS)
def test_device_format_tile_order_is_heavy_first(kind):
    _, fmt = edge_tile_layout(kind, 128)
    assert torch.equal(fmt.tile_order, heavy_first(fmt.tile_num_blocks))
    assert sorted(fmt.tile_order.tolist()) == list(range(fmt.num_tiles))
