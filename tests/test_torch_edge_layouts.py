"""Edge-tile slot layouts the kernels must take, and the kernels' shared
memory footprint.

:func:`edge_tile_layout` builds the layouts that ``tests/test_torch_cuda.py``
holds the ``power_step`` and ``edge_spmv`` kernels to on the card; here, on
the CPU, the wrappers run their plain versions on the same layouts and are
held against a float64 product of the graph's own edges (relative 1e-12).
The footprint tests pin the shared memory that the wrappers check to the
formula of ``csrc/edge_tile_scan.cuh`` and the ring the wrappers pick.

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
from repro_torch.kernels.edge_spmv import (RING_SLOTS_PER_NODE,
                                           SMEM_LIMIT_BYTES,
                                           STAGE_SLOTS_PER_NODE, check_blocks,
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


# edge_tile_smem_bytes = 128 + 32 elt + depth (span (8 + elt (1 + weighted))
# + 4 tile) + span elt + 2 min(4, tile / 32) tile: the header (mbarriers,
# counters), scratch; a ring slot's staged src_idx / dst_local (weights),
# gathered values and 16-bit run bounds; an unsorted stage's grouped values
# and its sort warps' 16-bit row counts. wants at one block a stage, two
# stages, unweighted.
@pytest.mark.parametrize("tile,e1,e2,elt,want", [
    (256, 8, 128, 4, 33_024), (128, 8, 128, 4, 30_976),
    (512, 8, 128, 4, 37_120), (256, 8, 128, 8, 45_440),
    (128, 8, 128, 8, 43_392), (512, 8, 128, 8, 49_536),
    (512, 16, 128, 8, 90_496), (1024, 8, 128, 8, 57_728)])
def test_edge_tile_smem_bytes_is_the_kernel_layout(tile, e1, e2, elt, want):
    eblk = e1 * e2
    assert edge_tile_smem_bytes(tile, eblk, elt) == want
    # a second block a stage: two ring slots and the grouped values grow
    assert edge_tile_smem_bytes(tile, eblk, elt, 2) == (
        want + 2 * eblk * (8 + elt) + eblk * elt)
    # a third ring slot
    assert edge_tile_smem_bytes(tile, eblk, elt, 1, 3) == (
        want + eblk * (8 + elt) + 4 * tile)
    # staged weights in every ring slot
    assert edge_tile_smem_bytes(tile, eblk, elt, 1, 2, True) == (
        want + 2 * eblk * elt)
    check_edge_tile_smem("power_step", tile, eblk, elt)    # fits


# The autotuner's candidates (eblk 1024): two stages of one block at tiles
# 128 and 256, of two blocks at tile 512, within the card's shared memory,
# at f32 and f64.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_autotuner_candidates_fit_the_kernels(dtype):
    elt = torch.tensor([], dtype=dtype).element_size()
    want = {128: (1, 2), 256: (1, 2), 512: (2, 2)}
    for tile, e1, e2 in EDGE_TILE_CANDIDATES:
        ring = stage_blocks(tile, e1 * e2, elt)
        assert ring == want[tile]
        assert check_edge_tile_smem("edge_spmv", tile, e1 * e2, elt) == ring
        assert edge_tile_smem_bytes(tile, e1 * e2, elt,
                                    *ring) <= SMEM_LIMIT_BYTES


# stage_blocks against a recomputation at every tile and dtype, weighted or
# not, for block sizes 128 to 16,384 slots: a stage of the most of 4, 2, 1
# blocks within STAGE_SLOTS_PER_NODE slots a node, as many stages (2 to 4)
# as RING_SLOTS_PER_NODE slots a node hold, else (1, 2) where that does not
# fit; check_edge_tile_smem returns it and raises exactly when it exceeds
# the card's limit.
@pytest.mark.parametrize("elt", [4, 8])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("eblk", [128, 256, 384, 640, 1024, 1280, 2048,
                                  4096, 16384])
def test_stage_blocks_at_every_tile_and_dtype(elt, weighted, eblk):
    for tile in range(32, 1025, 32):
        sblk = max([b for b in (1, 2, 4)
                    if b * eblk <= STAGE_SLOTS_PER_NODE * tile] or [1])
        want = (sblk, min(4, max(2, RING_SLOTS_PER_NODE * tile
                                 // (sblk * eblk))))
        if edge_tile_smem_bytes(tile, eblk, elt, *want,
                                weighted) > SMEM_LIMIT_BYTES:
            want = (1, 2)
        assert stage_blocks(tile, eblk, elt, weighted) == want, tile
        need = edge_tile_smem_bytes(tile, eblk, elt, *want, weighted)
        if need > SMEM_LIMIT_BYTES:
            with pytest.raises(ValueError, match="shared memory"):
                check_edge_tile_smem("edge_spmv", tile, eblk, elt, weighted)
        else:
            assert check_edge_tile_smem("edge_spmv", tile, eblk, elt,
                                        weighted) == want


# Every ring depth the wrappers pick (2, 3 and 4 stages) and every stage
# size (1, 2 and 4 blocks) occurs at some block size the card tests use.
def test_card_tests_cover_every_ring():
    rings = {stage_blocks(512, e1 * 128, 4) for e1 in (1, 2, 4, 5, 8, 10,
                                                       16)}
    assert {d for _, d in rings} == {2, 3, 4}
    assert {b for b, _ in rings} == {1, 2, 4}


# The ring's TMA copies and 128-slot chunks: eblk a multiple of 128, every
# block array on a 16-byte boundary.
def test_check_blocks_refuses_what_the_ring_cannot_copy():
    x = torch.zeros(64, dtype=torch.int32)
    check_blocks("edge_spmv", 1024, src_idx=x, dst_local=x, weights=None)
    check_blocks("edge_spmv", 128, src_idx=x)
    for eblk in (32, 96, 1000):
        with pytest.raises(ValueError, match="multiple of 128"):
            check_blocks("edge_spmv", eblk, src_idx=x)
    with pytest.raises(ValueError, match="16-byte"):
        check_blocks("power_step", 1024, src_idx=x, dst_local=x[1:])


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
