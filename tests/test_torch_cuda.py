"""Checks that need a CUDA card: each kernel against its plain version, run
to run bitwise equal, and a whole solve on the card. They skip without a
card; on one, run them with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only the port (the card's machine has no JAX).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.kernels import autotune
from repro_torch.kernels.bsr_spmv import (bsr_spmv_call, bsr_spmv_plain,
                                          bsr_step_call)
from repro_torch.kernels.edge_spmv import (edge_spmv_call,
                                           edge_spmv_lanes_call,
                                           edge_spmv_lanes_plain,
                                           edge_spmv_plain, stage_blocks)
from repro_torch.kernels.formats import (build_bsr, build_edge_tiles,
                                         pad_edge_tile_blocks, tile_spans)
from repro_torch.kernels.ops import (DeviceBsr, DeviceEdgeTiles, bsr_spmv,
                                     bsr_step, edge_spmv)
from repro_torch.kernels.power_step import (power_step_call,
                                            power_step_lanes_call,
                                            power_step_lanes_plain,
                                            power_step_plain)
from test_torch_edge_layouts import (KINDS, edge_tile_layout,
                                     long_rows_graph, slot_weights)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the card")
    return torch.device("cuda")


# The plain version runs on CPU copies of the inputs: the CPU's index_add_
# adds in slot order, as the kernel does, so only the epilogue's FMA
# contraction (<= 1 ulp) differs. (On the card index_add_ uses atomics and
# its order changes from run to run.)
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
@pytest.mark.parametrize("pad_blocks", [0, 5])
def test_power_step_kernel_matches_plain_on_card(card, dtype, rtol, atol,
                                                 pad_blocks):
    g = tg.powerlaw_configuration(5000, 40000, seed=3)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=4), dtype=dtype,
                             device=card)
    fmt_h = build_edge_tiles(g, tile=256)
    fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + pad_blocks)
    fmt = DeviceEdgeTiles.from_format(fmt_h, card)
    s = torch.as_tensor(np.random.default_rng(0).uniform(size=g.n),
                        dtype=dtype, device=card)
    s_pad = fmt.pad_node_vector(s)
    s_pre = fmt.pad_gather_source(s * ops.inv_w)
    mu, c = fmt.pad_node_vector(ops.mu), fmt.pad_node_vector(ops.c)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_pad)
    before = power_step_call.launches
    s1, gap1 = power_step_call(*args, n=g.n, tile=256)
    s2, gap2 = power_step_call(*args, n=g.n, tile=256)
    assert power_step_call.launches == before + 2
    host = [a.cpu() for a in (s_pre, fmt.src_idx, fmt.dst_local,
                              fmt.block_tile, mu, c, s_pad)]
    sp, gapp = power_step_plain(*host, tile=256)
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert abs(float(gap1) - float(gapp)) <= 1e-3 * float(gapp)


@pytest.mark.parametrize("tile", [128, 512])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_power_step_kernel_matches_plain_at_autotune_tiles(card, tile, dtype,
                                                           rtol, atol):
    """The other two edge-tile shapes the autotuner may pick or time."""
    g = tg.powerlaw_configuration(5000, 40000, seed=3)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=4), dtype=dtype,
                             device=card)
    fmt_h = build_edge_tiles(g, tile=tile)
    fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + 3)
    fmt = DeviceEdgeTiles.from_format(fmt_h, card)
    s = torch.as_tensor(np.random.default_rng(0).uniform(size=g.n),
                        dtype=dtype, device=card)
    s_pad = fmt.pad_node_vector(s)
    s_pre = fmt.pad_gather_source(s * ops.inv_w)
    mu, c = fmt.pad_node_vector(ops.mu), fmt.pad_node_vector(ops.c)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_pad)
    s1, gap1 = power_step_call(*args, n=g.n, tile=tile)
    s2, gap2 = power_step_call(*args, n=g.n, tile=tile)
    host = [a.cpu() for a in (s_pre, fmt.src_idx, fmt.dst_local,
                              fmt.block_tile, mu, c, s_pad)]
    sp, gapp = power_step_plain(*host, tile=tile)
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert abs(float(gap1) - float(gapp)) <= 1e-3 * float(gapp)


def _slot_weights(fmt_h, dtype, seed):
    """Random per-edge weights in the slot layout (0 in sentinel slots)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, size=fmt_h.src_idx.shape)
    w[fmt_h.src_idx == fmt_h.n] = 0.0
    return torch.as_tensor(w, dtype=dtype)


# edge_spmv against its plain version on CPU copies: both add in slot order,
# and the weight product is rounded before the sum in both, so they agree to
# the last bit.
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_spmv_kernel_matches_plain_on_card(card, tile, weighted, dtype):
    g = tg.powerlaw_configuration(5000, 40000, seed=3)
    fmt_h = build_edge_tiles(g, tile=tile)
    fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + 7)
    fmt = DeviceEdgeTiles.from_format(fmt_h, card)
    s = torch.as_tensor(np.random.default_rng(1).uniform(size=g.n),
                        dtype=dtype, device=card)
    w = _slot_weights(fmt_h, dtype, 2).to(card) if weighted else None
    before = edge_spmv_call.launches
    o1, o2 = edge_spmv(s, fmt, w), edge_spmv(s, fmt, w)
    assert edge_spmv_call.launches == before + 2
    assert torch.equal(o1, o2)
    op = edge_spmv_plain(fmt.pad_gather_source(s).cpu(), fmt.src_idx.cpu(),
                         fmt.dst_local.cpu(), fmt.block_tile.cpu(),
                         None if w is None else w.cpu(), tile=tile,
                         num_tiles=fmt.num_tiles)[0, :g.n]
    assert torch.equal(o1.cpu(), op)


# Every slot layout the kernels must take (test_torch_edge_layouts.KINDS:
# shuffled, patched through a cuda engine's patch_edges, an idle and an
# empty tile, a hub row over three or more blocks) at the autotuner's three
# tiles. power_step at the tolerances above; edge_spmv bitwise: both it and
# its plain version on CPU copies fold each row in slot order.
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_power_step_kernel_matches_plain_at_every_slot_layout(card, kind,
                                                              tile, dtype,
                                                              rtol, atol):
    g, fmt = edge_tile_layout(kind, tile, card)
    rng = np.random.default_rng(5)
    s_pre = fmt.pad_gather_source(torch.as_tensor(
        rng.uniform(size=g.n), dtype=dtype, device=card))
    mu, c, s_old = (fmt.pad_node_vector(torch.as_tensor(
        rng.uniform(size=g.n), dtype=dtype, device=card)) for _ in range(3))
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_old)
    s1, gap1 = power_step_call(*args, n=g.n, tile=tile)
    s2, gap2 = power_step_call(*args, n=g.n, tile=tile)
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    host = [a.cpu() for a in (s_pre, fmt.src_idx, fmt.dst_local,
                              fmt.block_tile, mu, c, s_old)]
    sp, gapp = power_step_plain(*host, tile=tile)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert abs(float(gap1) - float(gapp)) <= 1e-3 * float(gapp)


def _plans(fmt):
    """The format with no plan (every tile through the ring), with its own
    plan (the ring's stage) and with every sorted tile with a real slot on
    the row path (stage 0)."""
    bare = dataclasses.replace(fmt, row_start=None, tile_row_slots=None)
    return {"ring": bare, "plan": fmt.with_row_plan(),
            "rows": fmt.with_row_plan(0)}


def _step_args(fmt, s_pre, mu, c, s_old):
    return ((s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
             fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_old),
            dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order,
                 row_start=fmt.row_start, tile_row_slots=fmt.tile_row_slots))


# The row path against the ring and the plain version on every slot layout
# (KINDS, with "long rows": several rows past the ring's stage in one tile,
# one past 64 stages), at the autotuner's tiles, f32 and f64: with mu = 1
# and c = 0 the step's s' is the push itself (fma(1, t, 0) = t), bitwise
# the plain version's left fold in slot order on every plan; with random
# mu and c, every plan gives the same s' and gap to the last bit, and the
# plain version within the tolerances above (its epilogue is not fused).
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_power_step_row_path_and_ring_equal_plain_at_every_slot_layout(
        card, kind, tile, dtype, rtol, atol):
    g, fmt = edge_tile_layout(kind, tile, card)
    plans = _plans(fmt)
    if kind in ("hub", "long rows", "idle tile", "empty tile"):
        assert (plans["rows"].tile_row_slots > 0).any()
    if kind == "long rows":
        assert (plans["plan"].tile_row_slots > 0).any()
    rng = np.random.default_rng(17)
    s_pre = fmt.pad_gather_source(torch.as_tensor(
        rng.uniform(size=g.n), dtype=dtype, device=card))
    mu, c, s_old = (fmt.pad_node_vector(torch.as_tensor(
        rng.uniform(size=g.n), dtype=dtype, device=card)) for _ in range(3))
    ones, zeros = torch.ones_like(mu), torch.zeros_like(c)
    push = edge_spmv_plain(s_pre.cpu(), fmt.src_idx.cpu(),
                           fmt.dst_local.cpu(), fmt.block_tile.cpu(),
                           tile=tile, num_tiles=fmt.num_tiles)
    sp, gapp = power_step_plain(s_pre.cpu(), fmt.src_idx.cpu(),
                                fmt.dst_local.cpu(), fmt.block_tile.cpu(),
                                mu.cpu(), c.cpu(), s_old.cpu(), tile=tile)
    got = {}
    for name, f in plans.items():
        args, kw = _step_args(f, s_pre, ones, zeros, s_old)
        t1, _ = power_step_call(*args, **kw)
        assert torch.equal(t1.cpu(), push), name
        args, kw = _step_args(f, s_pre, mu, c, s_old)
        got[name] = power_step_call(*args, **kw)
        again = power_step_call(*args, **kw)
        assert torch.equal(got[name][0], again[0])
        assert torch.equal(got[name][1], again[1])
    for name in ("plan", "rows"):
        assert torch.equal(got[name][0], got["ring"][0]), name
        assert torch.equal(got[name][1], got["ring"][1]), name
    s1, gap1 = got["rows"]
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert abs(float(gap1) - float(gapp)) <= 1e-3 * float(gapp)


# The lane form with each lane's plan: three lanes over one size (long
# rows, the same with other followers, a sparse graph with no long row), at
# each plan, f32 and f64: each lane bitwise the single-lane launch on its
# own tensors and plan, and the ring's; with mu = 1, c = 0 bitwise the
# plain push.
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_power_step_lanes_row_path_equals_solo_launches_on_card(card, tile,
                                                               dtype):
    graphs = [long_rows_graph(), long_rows_graph(seed=20),
              tg.erdos_renyi(140_000, 150_000, seed=3)]
    fmts = [build_edge_tiles(g, tile=tile) for g in graphs]
    nb = max(f.num_blocks for f in fmts)
    fmts = [pad_edge_tile_blocks(f, nb) for f in fmts]
    n = graphs[0].n
    rng = np.random.default_rng(18)
    for stage in (None, 0):
        fmt = DeviceEdgeTiles.stack(fmts, card).with_row_plan(stage)
        assert (fmt.tile_row_slots[:2] > 0).any(1).all()
        vec = lambda: torch.stack([fmt.pad_node_vector(torch.as_tensor(
            rng.uniform(size=n), dtype=dtype, device=card))
            for _ in fmts])
        s_pre = torch.stack([fmt.pad_gather_source(torch.as_tensor(
            rng.uniform(size=n), dtype=dtype, device=card)) for _ in fmts])
        mu, c, s_old = vec(), vec(), vec()
        args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
                fmt.tile_first_block, fmt.tile_num_blocks)
        kw = dict(n=n, tile=tile, tile_order=fmt.tile_order,
                  row_start=fmt.row_start, tile_row_slots=fmt.tile_row_slots)
        s1, gap1 = power_step_lanes_call(*args, mu, c, s_old, **kw)
        t1, _ = power_step_lanes_call(*args, torch.ones_like(mu),
                                      torch.zeros_like(c), s_old, **kw)
        for lane in range(len(fmts)):
            one = [a[lane] for a in args]
            solo = dict(n=n, tile=tile, tile_order=fmt.tile_order[lane],
                        row_start=fmt.row_start[lane],
                        tile_row_slots=fmt.tile_row_slots[lane])
            ring = dict(n=n, tile=tile, tile_order=fmt.tile_order[lane])
            for kwl in (solo, ring):
                s2, gap2 = power_step_call(*one, mu[lane], c[lane],
                                           s_old[lane], **kwl)
                assert torch.equal(s1[lane], s2) and torch.equal(gap1[lane],
                                                                 gap2)
            push = edge_spmv_plain(*(a.cpu() for a in one[:4]), tile=tile,
                                   num_tiles=fmt.num_tiles)
            assert torch.equal(t1[lane].cpu(), push)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_spmv_kernel_equals_plain_at_every_slot_layout(card, kind, tile,
                                                            weighted, dtype):
    g, fmt = edge_tile_layout(kind, tile, card)
    s = torch.as_tensor(np.random.default_rng(6).uniform(size=g.n),
                        dtype=dtype, device=card)
    w = slot_weights(fmt, dtype, 7) if weighted else None
    o1, o2 = edge_spmv(s, fmt, w), edge_spmv(s, fmt, w)
    assert torch.equal(o1, o2)
    op = edge_spmv_plain(fmt.pad_gather_source(s).cpu(), fmt.src_idx.cpu(),
                         fmt.dst_local.cpu(), fmt.block_tile.cpu(),
                         None if w is None else w.cpu(), tile=tile,
                         num_tiles=fmt.num_tiles)[0, :g.n]
    assert torch.equal(o1.cpu(), op)


# Every ring the wrappers pick (edge_spmv.stage_blocks: 1, 2 or 4 blocks a
# stage, 2 to 4 stages), f64 up to tile 1024, on a hub graph whose long
# rows span many stages, its slots sorted (a fresh build) or shuffled within
# each tile (every stage unsorted): edge_spmv bitwise its plain version,
# power_step within the tolerances above, both bitwise run to run.
@pytest.mark.parametrize("tile,e1,dtype,weighted,ring", [
    (512, 8, torch.float32, False, (2, 2)),
    (256, 8, torch.float32, False, (1, 2)),
    (256, 8, torch.float64, False, (1, 2)),
    (1024, 8, torch.float64, False, (4, 2)),
    (128, 1, torch.float32, False, (4, 2)),
    (256, 1, torch.float32, True, (4, 4)),
    (1024, 4, torch.float32, True, (4, 4)),
    (256, 5, torch.float64, False, (1, 3)),
    (512, 10, torch.float32, False, (1, 3)),
    (512, 5, torch.float32, False, (2, 3)),
    (1024, 5, torch.float32, False, (4, 3)),
    (128, 16, torch.float64, True, (1, 2)),
    (1024, 16, torch.float64, False, (2, 2))])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_edge_tile_kernels_at_every_ring_on_card(card, tile, e1, dtype,
                                                 weighted, ring, order):
    g, _ = edge_tile_layout("hub", 128)
    fmt_h = build_edge_tiles(g, tile=tile, e1=e1, e2=128)
    elt = torch.tensor([], dtype=dtype).element_size()
    assert stage_blocks(tile, fmt_h.eblk, elt, weighted) == ring
    if order == "shuffled":
        rng = np.random.default_rng(14)
        src = fmt_h.src_idx.reshape(fmt_h.num_blocks, -1).copy()
        dstl = fmt_h.dst_local.reshape(fmt_h.num_blocks, -1).copy()
        for a, c in zip(fmt_h.tile_first_block, fmt_h.tile_num_blocks):
            perm = rng.permutation(c * fmt_h.eblk)
            src[a:a + c] = src[a:a + c].reshape(-1)[perm].reshape(c, -1)
            dstl[a:a + c] = dstl[a:a + c].reshape(-1)[perm].reshape(c, -1)
        fmt_h = dataclasses.replace(
            fmt_h, src_idx=src.reshape(fmt_h.src_idx.shape),
            dst_local=dstl.reshape(fmt_h.src_idx.shape))
    fmt = DeviceEdgeTiles.from_format(fmt_h, card)
    rng = np.random.default_rng(15)
    s = torch.as_tensor(rng.uniform(size=g.n), dtype=dtype, device=card)
    w = _slot_weights(fmt_h, dtype, 16).to(card) if weighted else None
    o1, o2 = edge_spmv(s, fmt, w), edge_spmv(s, fmt, w)
    assert torch.equal(o1, o2)
    op = edge_spmv_plain(fmt.pad_gather_source(s).cpu(), fmt.src_idx.cpu(),
                         fmt.dst_local.cpu(), fmt.block_tile.cpu(),
                         None if w is None else w.cpu(), tile=tile,
                         num_tiles=fmt.num_tiles)[0, :g.n]
    assert torch.equal(o1.cpu(), op)
    mu, c, s_old = (fmt.pad_node_vector(torch.as_tensor(
        rng.uniform(size=g.n), dtype=dtype, device=card)) for _ in range(3))
    args = (fmt.pad_gather_source(s), fmt.src_idx, fmt.dst_local,
            fmt.block_tile, fmt.tile_first_block, fmt.tile_num_blocks, mu, c,
            s_old)
    s1, gap1 = power_step_call(*args, n=g.n, tile=tile)
    s2, gap2 = power_step_call(*args, n=g.n, tile=tile)
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    sp, gapp = power_step_plain(*(a.cpu() for a in args[:4]),
                                *(a.cpu() for a in args[6:]), tile=tile)
    rtol, atol = (1e-6, 1e-7) if dtype == torch.float32 else (1e-14, 1e-16)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert abs(float(gap1) - float(gapp)) <= 1e-3 * float(gapp)


# The launch order moves no bit: the tiles in id order give what the
# format's heavy-first tile_order gives. The gap's ticket counter is kept per
# stream, so steps launched on two streams at once each find their own last
# CTA and both equal the one-stream step to the last bit.
def test_edge_tile_kernels_take_any_tile_order_and_two_streams(card):
    g, fmt = edge_tile_layout("hub", 256, card)
    rng = np.random.default_rng(8)
    s_pre = fmt.pad_gather_source(torch.as_tensor(
        rng.uniform(size=g.n), dtype=torch.float32, device=card))
    mu, c, s_old = (fmt.pad_node_vector(torch.as_tensor(
        rng.uniform(size=g.n), dtype=torch.float32, device=card))
        for _ in range(3))
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks)
    ident = torch.arange(fmt.num_tiles, dtype=torch.int32, device=card)
    assert not torch.equal(ident, fmt.tile_order)
    kw = dict(n=g.n, tile=256)
    assert torch.equal(edge_spmv_call(*args, **kw, tile_order=ident),
                       edge_spmv_call(*args, **kw, tile_order=fmt.tile_order))
    s0, gap0 = power_step_call(*args, mu, c, s_old, **kw,
                               tile_order=fmt.tile_order)
    s1, gap1 = power_step_call(*args, mu, c, s_old, **kw, tile_order=ident)
    assert torch.equal(s0, s1) and torch.equal(gap0, gap1)
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for stream in streams:
            with torch.cuda.stream(stream):
                outs.append(power_step_call(*args, mu, c, s_old, **kw,
                                            tile_order=fmt.tile_order))
    torch.cuda.synchronize()
    for s, gap in outs:
        assert torch.equal(s, s0) and torch.equal(gap, gap0)


@pytest.mark.parametrize("td", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-6),
                                             (torch.float64, 1e-12, 1e-14)])
def test_bsr_spmv_kernel_matches_plain_on_card(card, dtype, rtol, atol, td):
    g = tg.clustered_blocks(3000, 30000, block=128, p_in=0.9, seed=3)
    fmt = DeviceBsr.from_format(
        build_bsr(g, td=td, dtype=np.float32 if dtype == torch.float32
                  else np.float64), card)
    s = torch.as_tensor(np.random.default_rng(1).uniform(size=g.n),
                        dtype=dtype, device=card)
    before = bsr_spmv_call.launches
    o1, o2 = bsr_spmv(s, fmt), bsr_spmv(s, fmt)
    assert bsr_spmv_call.launches == before + 2
    s_pad = torch.nn.functional.pad(s, (0, fmt.n_src_pad - g.n))[None]
    op = bsr_spmv_plain(s_pad, fmt.tiles, fmt.src_tile, fmt.dst_tile,
                        num_dst_tiles=fmt.num_dst_tiles)[0, :g.n]
    assert torch.equal(o1, o2)
    torch.testing.assert_close(o1, op, rtol=rtol, atol=atol)


def _bsr_case(card, dtype, td):
    """A clustered graph's operators and BSR format (one-byte tiles) on the
    card, the same format with its tiles in ``dtype``, and a random s."""
    g = tg.clustered_blocks(3000, 30000, block=128, p_in=0.9, seed=3)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=4), dtype=dtype,
                             device=card)
    fmt_h = build_bsr(g, td=td, dtype=np.float32 if dtype == torch.float32
                      else np.float64)
    fmt = DeviceBsr.from_format(fmt_h, card)
    wide = DeviceBsr(**{**vars(fmt), "tiles": torch.as_tensor(
        fmt_h.tiles, device=card)})
    s = torch.as_tensor(np.random.default_rng(1).uniform(size=g.n),
                        dtype=dtype, device=card)
    return ops, fmt, wide, s


# The fused step against the composition it replaces, on the card: s_new
# bitwise (the push is the same kernel, and the epilogue rounds mu * t and
# + c as PyTorch does), the gap within GAP_RTOL (summed in another order).
GAP_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.mark.parametrize("td", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_step_kernel_matches_unfused_composition_on_card(card, dtype,
                                                             td):
    ops, fmt, wide, s = _bsr_case(card, dtype, td)
    assert fmt.tiles.dtype == torch.uint8 and wide.tiles.dtype == dtype
    before = bsr_step_call.launches
    s1, gap1 = bsr_step(s, ops.inv_w, ops.mu, ops.c, fmt)
    s2, gap2 = bsr_step(s, ops.inv_w, ops.mu, ops.c, fmt)
    s3, gap3 = bsr_step(s, ops.inv_w, ops.mu, ops.c, wide)
    torch.cuda.synchronize()
    assert bsr_step_call.launches == before + 3
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    assert torch.equal(s1, s3) and torch.equal(gap1, gap3)
    s_ref = ops.mu * bsr_spmv(s * ops.inv_w, fmt) + ops.c
    gap_ref = float(torch.sum(torch.abs(s_ref - s)))
    assert torch.equal(s1, s_ref)
    assert abs(float(gap1) - gap_ref) <= GAP_RTOL[dtype] * gap_ref


@pytest.mark.parametrize("td", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bsr_spmv_one_byte_and_wide_tiles_agree_bitwise_on_card(card, dtype,
                                                                td):
    _, fmt, wide, s = _bsr_case(card, dtype, td)
    assert torch.equal(bsr_spmv(s, fmt), bsr_spmv(s, wide))


def test_kernel_wrappers_reject_bad_inputs_on_card(card):
    s = torch.zeros(1, 257, device=card)
    idx = torch.zeros(1, 8, 128, dtype=torch.int64, device=card)  # not i32
    tbl = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="src_idx"):
        power_step_call(s, idx, idx, tbl, tbl, tbl, s[:, :256], s[:, :256],
                        s[:, :256], n=200, tile=256)
    with pytest.raises(ValueError, match="tiles"):
        bsr_spmv_call(torch.zeros(1, 128, device=card),
                      torch.zeros(1, 128, 128, dtype=torch.float64,
                                  device=card), tbl, tbl, tbl, tbl,
                      num_dst_tiles=1)
    idx32 = torch.zeros(1, 8, 128, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="src_idx"):
        edge_spmv_call(s, idx, idx32, tbl, tbl, tbl, n=200, tile=256)
    with pytest.raises(ValueError, match="weights"):      # wrong dtype
        edge_spmv_call(s, idx32, idx32, tbl, tbl, tbl,
                       torch.zeros(1, 8, 128, dtype=torch.float64,
                                   device=card), n=200, tile=256)
    with pytest.raises(ValueError, match="s_pre"):        # not contiguous
        edge_spmv_call(torch.zeros(257, 2, device=card).t()[:1], idx32,
                       idx32, tbl, tbl, tbl, n=200, tile=256)
    with pytest.raises(ValueError, match="weights"):      # wrong layout
        edge_spmv_call(s, idx32, idx32, tbl, tbl, tbl,
                       torch.zeros(1, 1024, device=card), n=200, tile=256)


@pytest.mark.parametrize("regime", ["edge_tile", "bsr"])
def test_cuda_backend_solves_on_card(card, regime):
    g = tg.powerlaw_configuration(3000, 20000, seed=3)
    act = tc.heterogeneous(g.n, seed=4)
    ref = tc.make_engine("reference", graph=g, activity=act,
                         dtype=torch.float64, device=card).run(tol=1e-12)
    eng = tc.make_engine("cuda", graph=g, activity=act, device=card,
                         regime=regime)
    counter = power_step_call if regime == "edge_tile" else bsr_step_call
    before = counter.launches
    res1 = eng.run(tol=1e-8)
    assert counter.launches - before == res1.iterations
    res2 = eng.run(tol=1e-8)
    assert res1.converged and res1.iterations == res2.iterations
    assert torch.equal(res1.psi, res2.psi)            # deterministic solve
    err = (res1.psi.double() - ref.psi).abs().max()
    assert float(err) <= 1e-6


def test_power_step_check_span_on_card(card, monkeypatch):
    """A live tracer records one ``power_step.check`` a launch inside its
    ``engine.issue``; with none live and no profiler a launch makes no
    span, and the solve is bit for bit the same."""
    from repro_torch.obs import trace
    g = tg.powerlaw_configuration(3000, 20000, seed=3)
    eng = tc.make_engine("cuda", graph=g, activity=tc.heterogeneous(
        g.n, seed=4), device=card, dtype=torch.float64)
    made = []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    monkeypatch.setattr(trace, "Span", Counted)
    quiet = eng.run(tol=1e-10)
    assert "power_step.check" not in made and "engine.issue" not in made
    tracer = trace.Tracer()
    prev = trace.set_tracer(tracer)
    try:
        traced = eng.run(tol=1e-10)
    finally:
        trace.set_tracer(prev)
    checks = [r for r in tracer.spans if r["name"] == "power_step.check"]
    issues = {r["id"] for r in tracer.spans if r["name"] == "engine.issue"}
    assert len(checks) == len(issues) == traced.iterations
    assert {r["parent"] for r in checks} == issues
    assert torch.equal(traced.psi, quiet.psi) and traced.gap == quiet.gap


@pytest.mark.parametrize("microbench", [False, True])
def test_auto_backend_solves_on_card(card, microbench):
    g = tg.powerlaw_configuration(3000, 20000, seed=3)
    act = tc.heterogeneous(g.n, seed=4)
    ref = tc.make_engine("reference", graph=g, activity=act,
                         dtype=torch.float64, device=card).run(tol=1e-12)
    before = edge_spmv_call.launches
    eng = tc.make_engine("auto", graph=g, activity=act, device=card,
                         microbench=microbench,
                         plan_cache=autotune.PlanCache())
    assert eng.plan.source == ("microbench" if microbench else "model")
    launched = edge_spmv_call.launches - before
    per_candidate = autotune._MB_WARMUP + autotune._MB_RUNS * \
        autotune._MB_LAUNCHES
    assert launched == (per_candidate * len(autotune.EDGE_TILE_CANDIDATES)
                        if microbench else 0)
    res = eng.run(tol=1e-8)
    assert res.converged and res.gap == 0.0
    assert float((res.psi.double() - ref.psi).abs().max()) <= 1e-6


def test_accelerated_cuda_backend_on_card(card):
    g = tg.powerlaw_configuration(3000, 20000, seed=4)
    act = tc.heterogeneous(g.n, seed=5)
    kw = dict(graph=g, activity=act, dtype=torch.float64, device=card)
    plain = tc.make_engine("cuda", **kw).run(tol=1e-9)
    acc = tc.make_engine("cuda", accelerate=True, **kw).run(tol=1e-9)
    assert acc.converged and acc.matvecs < plain.matvecs
    assert float((acc.psi - plain.psi).abs().max()) <= 1e-9


# --------------------------------------------------------------------- #
# Lane-batched power_step / edge_spmv (the fleet's kernel regime)
# --------------------------------------------------------------------- #
LANE_N_PAD = 4096


def _lane_formats(tile):
    """Host formats of one bucket (n_pad 4096, (tile, 8, 128)), built as
    the fleet builds them (on ``Graph(n_pad, ...)``, so the sentinel is
    n_pad) and padded to one block count: three graphs of different block
    counts and an all-padding lane (no edges, one block a tile)."""
    graphs = [tg.powerlaw_configuration(3000, 30000, seed=31),
              tg.erdos_renyi(4096, 40000, seed=32),
              tg.powerlaw_configuration(1500, 4000, seed=33)]
    empty = np.empty(0, np.int32)
    fmts = [build_edge_tiles(tg.Graph(LANE_N_PAD, *g.edges_by_dst),
                             tile=tile) for g in graphs]
    fmts.append(build_edge_tiles(tg.Graph(LANE_N_PAD, empty, empty),
                                 tile=tile))
    counts = [f.num_blocks for f in fmts]
    assert len(set(counts)) >= 3                  # lanes pad by unlike counts
    nb = -(-max(counts) // 4) * 4
    return [pad_edge_tile_blocks(f, nb) for f in fmts]


def _lane_vectors(fmt, dtype, seed):
    """s_pre [L, 1, n_gather] (zero from n_pad on), mu, c, s_old [L, 1,
    n_pad]; the last lane (all padding) all zero."""
    rng = np.random.default_rng(seed)
    lanes = fmt.src_idx.shape[0]

    def vec(width):
        v = rng.uniform(size=(lanes, 1, width))
        v[-1] = 0.0
        v[:, :, LANE_N_PAD:] = 0.0
        return torch.as_tensor(v, dtype=dtype, device=fmt.device)
    return vec(fmt.n_gather), vec(fmt.n_pad), vec(fmt.n_pad), vec(fmt.n_pad)


# Each lane of one lane-batched launch equals a single-lane launch on that
# lane's own tensors to the last bit (s_new, gap; t), the all-padding lane
# gives zeros and gap 0, two launches agree bitwise, and the lanes agree with
# the plain version lane by lane (power_step at the tolerances above,
# edge_spmv bitwise).
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_power_step_lanes_kernel_on_card(card, tile, dtype, rtol, atol):
    fmt = DeviceEdgeTiles.stack(_lane_formats(tile), card)
    s_pre, mu, c, s_old = _lane_vectors(fmt, dtype, tile)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_old)
    kw = dict(n=fmt.n, tile=tile, tile_order=fmt.tile_order)
    before = (power_step_lanes_call.launches, power_step_call.launches)
    s1, gap1 = power_step_lanes_call(*args, **kw)
    s2, gap2 = power_step_lanes_call(*args, **kw)
    assert (power_step_lanes_call.launches, power_step_call.launches) == (
        before[0] + 2, before[1])
    assert s1.shape == mu.shape and gap1.shape == (mu.shape[0],)
    assert torch.equal(s1, s2) and torch.equal(gap1, gap2)
    for lane in range(mu.shape[0]):
        one = power_step_call(*(a[lane] for a in args), n=fmt.n, tile=tile,
                              tile_order=fmt.tile_order[lane])
        assert torch.equal(s1[lane], one[0]) and torch.equal(gap1[lane],
                                                             one[1])
    assert not s1[-1].any() and float(gap1[-1]) == 0.0
    sp, gapp = power_step_lanes_plain(*(a.cpu() for a in args[:4]),
                                      *(a.cpu() for a in args[6:]),
                                      tile=tile)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert torch.all((gap1.cpu() - gapp).abs() <= 1e-3 * gapp)


@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_edge_spmv_lanes_kernel_on_card(card, tile, weighted, dtype):
    fmts = _lane_formats(tile)
    fmt = DeviceEdgeTiles.stack(fmts, card)
    s_pre = _lane_vectors(fmt, dtype, tile + 1)[0]
    w = (torch.stack([_slot_weights(f, dtype, 9 + i)
                      for i, f in enumerate(fmts)]).to(card)
         if weighted else None)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, w)
    kw = dict(n=fmt.n, tile=tile, tile_order=fmt.tile_order)
    before = (edge_spmv_lanes_call.launches, edge_spmv_call.launches)
    o1 = edge_spmv_lanes_call(*args, **kw)
    o2 = edge_spmv_lanes_call(*args, **kw)
    assert (edge_spmv_lanes_call.launches, edge_spmv_call.launches) == (
        before[0] + 2, before[1])
    assert torch.equal(o1, o2)
    for lane in range(s_pre.shape[0]):
        one = edge_spmv_call(*(None if a is None else a[lane] for a in args),
                             n=fmt.n, tile=tile,
                             tile_order=fmt.tile_order[lane])
        assert torch.equal(o1[lane], one)
    assert not o1[-1].any()
    op = edge_spmv_lanes_plain(*(a.cpu() for a in args[:4]),
                               None if w is None else w.cpu(), tile=tile,
                               num_tiles=fmt.num_tiles)
    assert torch.equal(o1.cpu(), op)


def _patched_lane(fmt_h, seed):
    """``fmt_h`` as the solo engine patches a format in place: new edges
    (random sources, random rows of the tile) written into the sentinel
    slots right after each tile's sorted edges, so those stages are
    unsorted; the block layout is unchanged."""
    rng = np.random.default_rng(seed)
    src = fmt_h.src_idx.reshape(fmt_h.num_blocks, -1).copy()
    dstl = fmt_h.dst_local.reshape(fmt_h.num_blocks, -1).copy()
    for a, c in zip(fmt_h.tile_first_block, fmt_h.tile_num_blocks):
        flat_s, flat_d = src[a:a + c].reshape(-1), dstl[a:a + c].reshape(-1)
        free = np.flatnonzero(flat_s == fmt_h.n)
        put = free[:min(len(free), 48)]
        flat_s[put] = rng.integers(0, 1500, len(put))
        flat_d[put] = rng.integers(0, fmt_h.tile, len(put))
        src[a:a + c], dstl[a:a + c] = (flat_s.reshape(c, -1),
                                       flat_d.reshape(c, -1))
    return dataclasses.replace(
        fmt_h, src_idx=src.reshape(fmt_h.src_idx.shape),
        dst_local=dstl.reshape(fmt_h.src_idx.shape))


# A lane whose stages are unsorted (a patched format written with
# write_lane) beside sorted lanes and the all-padding lane: every lane is
# bitwise its single-lane launch, edge_spmv_lanes bitwise its plain
# version, power_step_lanes within the tolerances above.
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_lane_kernels_with_a_patched_lane_on_card(card, tile, dtype, rtol,
                                                  atol):
    fmts = _lane_formats(tile)
    fmt = DeviceEdgeTiles.stack(fmts, card)
    fmt.write_lane(1, _patched_lane(fmts[1], 17))
    s_pre, mu, c, s_old = _lane_vectors(fmt, dtype, tile + 2)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s_old)
    kw = dict(n=fmt.n, tile=tile, tile_order=fmt.tile_order)
    s1, gap1 = power_step_lanes_call(*args, **kw)
    t1 = edge_spmv_lanes_call(*args[:6], **kw)
    for lane in range(mu.shape[0]):
        one = dict(n=fmt.n, tile=tile, tile_order=fmt.tile_order[lane])
        s_one, gap_one = power_step_call(*(a[lane] for a in args), **one)
        assert torch.equal(s1[lane], s_one) and torch.equal(gap1[lane],
                                                            gap_one)
        assert torch.equal(t1[lane], edge_spmv_call(
            *(a[lane] for a in args[:6]), **one))
    host = [a.cpu() for a in args]
    sp, gapp = power_step_lanes_plain(*host[:4], *host[6:], tile=tile)
    torch.testing.assert_close(s1.cpu(), sp, rtol=rtol, atol=atol)
    assert torch.all((gap1.cpu() - gapp).abs() <= 1e-3 * gapp)
    assert torch.equal(t1.cpu(), edge_spmv_lanes_plain(
        *host[:4], tile=tile, num_tiles=fmt.num_tiles))


# The fleet's cuda regime on the card: each lane's iterations, gap, s and
# ψ equal the solo cuda engine's at the bucket's tile (bitwise: the same
# kernels, the same slot order, the same inputs; both ψ epilogues push
# through edge_spmv and multiply by 1/n rounded once), one power_step_lanes
# launch a step.
def test_fleet_cuda_regime_matches_solo_engine_on_card(card):
    from repro_torch.serving import BucketPolicy, TenantFleet
    graphs = [tg.powerlaw_configuration(3000, 30000, seed=41),
              tg.erdos_renyi(2500, 15000, seed=42),
              tg.powerlaw_configuration(3500, 20000, seed=43)]
    acts = [tc.heterogeneous(g.n, seed=50 + i) for i, g in enumerate(graphs)]
    fleet = TenantFleet(backend="cuda", tol=1e-8, device=card,
                        policy=BucketPolicy((4096,), edge_quantum=32768),
                        tile=256, e1=8, e2=128)
    for i, (g, a) in enumerate(zip(graphs, acts)):
        fleet.admit(f"t{i}", g, a)
    before = power_step_lanes_call.launches
    assert fleet.solve() == 3
    steps = max(fleet.stats(f"t{i}")["iterations"] for i in range(3))
    assert power_step_lanes_call.launches - before == steps
    for i, (g, a) in enumerate(zip(graphs, acts)):
        eng = tc.make_engine("cuda", graph=g.dedup(), activity=a,
                             device=card, tile=256)
        res = eng.run(tol=1e-8)
        st = fleet.stats(f"t{i}")
        assert st["iterations"] == res.iterations and st["gap"] == res.gap
        assert np.array_equal(fleet.series(f"t{i}"), res.s.cpu().numpy())
        assert np.array_equal(fleet.psi(f"t{i}"), res.psi.cpu().numpy())


# The solo engine's edge_tile ψ epilogue is the fleet's: a one-tenant fleet
# lane and a solo cuda engine at the lane's plan give the same bits, at
# float32 and float64, and the epilogue launches edge_spmv once a solve.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solo_cuda_psi_equals_one_tenant_fleet_lane_on_card(card, dtype):
    from repro_torch.serving import TenantFleet
    g = tg.powerlaw_configuration(3000, 20000, seed=4)
    act = tc.heterogeneous(g.n, seed=5)
    fleet = TenantFleet(backend="cuda", tol=1e-8, device=card, dtype=dtype)
    fleet.admit("t", g, act)
    fleet.solve()
    plan = fleet._buckets[fleet.spec_of("t")].plan
    eng = tc.make_engine("cuda", graph=g, activity=act, device=card,
                         dtype=dtype, tile=plan.tile, e1=plan.e1, e2=plan.e2)
    before = edge_spmv_call.launches
    res = eng.run(tol=1e-8)
    assert edge_spmv_call.launches - before == 1
    assert res.iterations == fleet.stats("t")["iterations"]
    assert np.array_equal(res.psi.cpu().numpy(), fleet.psi("t"))


# --------------------------------------------------------------------- #
# seg_mm (GNN aggregation) and the GraphSAGE step
# --------------------------------------------------------------------- #
def _seg_mm_format(kind):
    """Host edge-tile formats at the trainer's (tile, e1, e2): ``plain``,
    ``padded`` (+3 padding blocks on the last tile), ``shuffled`` (slots in
    random order within each tile's range: the kernel may not assume them
    sorted), ``idle tile`` (a tile whose one block is all padding) and
    ``empty tile`` (a tile with no blocks at all)."""
    from repro_torch.kernels.formats import block_ranges
    from repro_torch.models.gnn.common import DEFAULT_TILES
    tile, e1, e2 = DEFAULT_TILES
    if kind == "idle tile":          # nodes [512, 1024) receive no edge
        g = tg.erdos_renyi(2000, 20000, seed=8)
        keep = (g.dst < 512) | (g.dst >= 1024)
        g = tg.Graph(g.n, g.src[keep], g.dst[keep])
    else:
        g = tg.powerlaw_configuration(5000, 40000, seed=3)
    fmt = build_edge_tiles(g, tile=tile, e1=e1, e2=e2)
    if kind == "padded":
        fmt = pad_edge_tile_blocks(fmt, fmt.num_blocks + 3)
    src = fmt.src_idx.reshape(fmt.num_blocks, -1).copy()
    dstl = fmt.dst_local.reshape(fmt.num_blocks, -1).copy()
    block_tile = fmt.block_tile
    if kind == "shuffled":
        rng = np.random.default_rng(9)
        first, count = block_ranges(block_tile, fmt.num_tiles)
        for f, c in zip(first, count):
            span = slice(f, f + c)
            perm = rng.permutation(c * src.shape[1])
            src[span] = src[span].reshape(-1)[perm].reshape(c, -1)
            dstl[span] = dstl[span].reshape(-1)[perm].reshape(c, -1)
    if kind == "empty tile":         # drop tile 1's blocks
        keep = block_tile != 1
        src, dstl, block_tile = src[keep], dstl[keep], block_tile[keep]
    first, count = block_ranges(block_tile, fmt.num_tiles)
    return g.n, tile, src, dstl, block_tile, first, count


def _seg_mm_args(kind, d, dtype, device):
    n, tile, src, dstl, block_tile, first, count = _seg_mm_format(kind)
    x = np.random.default_rng(d).normal(size=(n + 1, d))
    x[n] = 0.0                                  # the sentinel source
    msgs = torch.as_tensor(x[src], dtype=dtype, device=device)
    i32 = [torch.as_tensor(a, dtype=torch.int32, device=device)
           for a in (dstl, block_tile, first, count)]
    return (msgs, *i32), tile, n


# Both sum every slot in slot order (padding rows included), so they agree
# to the last bit.
@pytest.mark.parametrize("kind", ["plain", "padded", "shuffled", "idle tile",
                                  "empty tile"])
@pytest.mark.parametrize("d", [8, 128, 602])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_mm_kernel_matches_plain_on_card(card, kind, d, dtype):
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    args, tile, n = _seg_mm_args(kind, d, dtype, card)
    before = seg_mm_call.launches
    o1 = seg_mm_call(*args, tile=tile)
    o2 = seg_mm_call(*args, tile=tile)
    torch.cuda.synchronize()
    assert seg_mm_call.launches == before + 2
    assert torch.equal(o1, o2)
    host = [a.cpu() for a in args]
    op = seg_mm_plain(host[0], host[1], host[2], tile=tile,
                      num_tiles=host[3].shape[0])
    assert torch.equal(o1.cpu(), op)
    if kind == "empty tile":
        assert bool((o1[tile:2 * tile] == 0).all())


# With the tile span the kernel skips each tile's trailing padding; a sum
# starts from +0.0, so skipping zero rows changes no bit.
@pytest.mark.parametrize("kind", ["plain", "padded", "shuffled", "idle tile",
                                  "empty tile"])
@pytest.mark.parametrize("d", [8, 128, 602])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_mm_kernel_with_tile_span_matches_plain_on_card(card, kind, d,
                                                            dtype):
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    n, tile, src, _, block_tile, _, count = _seg_mm_format(kind)
    span = torch.as_tensor(tile_spans(src, n, block_tile, count.shape[0]),
                           device=card)
    args, tile, n = _seg_mm_args(kind, d, dtype, card)
    o1 = seg_mm_call(*args, tile=tile, tile_span=span)
    o2 = seg_mm_call(*args, tile=tile, tile_span=span)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    host = [a.cpu() for a in args]
    op = seg_mm_plain(host[0], host[1], host[2], tile=tile,
                      num_tiles=host[3].shape[0])
    assert torch.equal(o1.cpu(), op)


def test_seg_mm_backward_on_card(card):
    from repro_torch.kernels.seg_mm import SegMM
    args, tile, _ = _seg_mm_args("padded", 128, torch.float32, card)
    msgs = args[0].clone().requires_grad_()
    out = SegMM.apply(msgs, *args[1:], tile)
    w = torch.randn(out.shape, generator=torch.Generator(card).manual_seed(0),
                    device=card)
    (out * w).sum().backward()
    rows = (args[2].long()[:, None] * tile + args[1].long()).reshape(-1)
    assert torch.equal(msgs.grad.reshape(-1, 128).cpu(),
                       w.cpu().index_select(0, rows.cpu()))


def test_sage_reduced_train_step_on_card_matches_cpu(card):
    from repro_torch.configs import get_arch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.models.gnn import sage
    from repro_torch.train.optim import (adamw, cosine_schedule, tree_leaves,
                                         tree_map)
    cfg = get_arch("graphsage-reddit").config(reduced=True)
    out = {}
    for dev in ("cpu", card):
        batch = train.reduced_batch(cfg, dev)
        params = sage.init_params(cfg, 0, device=dev)
        opt = adamw(cosine_schedule(3e-3, 5, 2))
        state = opt.init(params)
        loss = sage.loss_fn(params, batch, cfg)
        loss.backward()
        grads = [p.grad.clone() for p in tree_leaves(params)]
        opt.apply(tree_map(lambda p: p.grad, params), state, params)
        out[str(dev)] = (loss.item(), grads,
                         [p.detach().clone() for p in tree_leaves(params)])
    loss_c, grads_c, params_c = out["cpu"]
    loss_g, grads_g, params_g = out[str(card)]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(grads_g, grads_c):
        assert float((a.cpu() - b).norm() / b.norm()) <= 1e-4
    for a, b in zip(params_g, params_c):
        assert float((a.cpu() - b).norm() / b.norm()) <= 1e-3
    # forward + the remat's recompute: one seg_mm launch each, per layer
    batch = train.reduced_batch(cfg, card)
    params = sage.init_params(cfg, 0, device=card)
    before = seg_mm_call.launches
    sage.loss_fn(params, batch, cfg).backward()
    assert seg_mm_call.launches - before == 2 * cfg.n_layers


# The other GNN families' aggregation widths: PNA's d = 75, NequIP's
# (2l+1)·32 for l = 1, 2 (96, 160) and EquiformerV2's 49·128 = 6,272; held
# bitwise like the GraphSAGE widths (6,272 on two layouts: its message rows
# are ~2 GB at f64).
@pytest.mark.parametrize("kind", ["plain", "padded", "shuffled", "idle tile",
                                  "empty tile"])
@pytest.mark.parametrize("d", [75, 96, 160])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_mm_kernel_matches_plain_at_family_widths_on_card(card, kind, d,
                                                              dtype):
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    n, tile, src, _, block_tile, _, count = _seg_mm_format(kind)
    span = torch.as_tensor(tile_spans(src, n, block_tile, count.shape[0]),
                           device=card)
    args, tile, n = _seg_mm_args(kind, d, dtype, card)
    o1 = seg_mm_call(*args, tile=tile, tile_span=span)
    o2 = seg_mm_call(*args, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    host = [a.cpu() for a in args]
    assert torch.equal(o1.cpu(), seg_mm_plain(
        host[0], host[1], host[2], tile=tile, num_tiles=host[3].shape[0]))


@pytest.mark.parametrize("kind", ["plain", "shuffled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seg_mm_kernel_matches_plain_at_equiformer_width_on_card(card, kind,
                                                                 dtype):
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    args, tile, _ = _seg_mm_args(kind, 6272, dtype, card)
    out = seg_mm_call(*args, tile=tile).cpu()
    host = [a.cpu() for a in args]
    del args
    assert torch.equal(out, seg_mm_plain(host[0], host[1], host[2], tile=tile,
                                         num_tiles=host[3].shape[0]))


def _family_batch(arch, cfg, dev):
    from repro_torch.launch import train
    if arch == "pna":
        return train.reduced_batch(cfg, dev)
    return train.molecule_batch(6, 10, 16, cfg.d_feat, dev, n_pad=64,
                                e_pad=200, seed=4)


@pytest.mark.parametrize("arch", ["pna", "nequip", "equiformer-v2"])
def test_family_reduced_train_step_on_card_matches_cpu(card, arch):
    """One step of the reduced config on the card (seg_mm) against the CPU
    (its plain version): loss rel 1e-5, gradients rel L2 1e-4, each leaf
    against the larger of its own norm and 1e-3 of the whole gradient's (a
    leaf whose true gradient is 0, EquiformerV2's last attention bias,
    holds f32 rounding noise alone), and the parameters after an AdamW step
    rel L2 1e-3 — except on the leaves under that floor, whose rounding
    Adam's g/√v can turn into a full step of either sign; and seg_mm
    launches."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.launch.specs import _GNN_MODS
    from repro_torch.train.optim import (adamw, cosine_schedule, tree_leaves,
                                         tree_map)
    mod = _GNN_MODS[arch]
    cfg = get_arch(arch).config(reduced=True)
    out = {}
    for dev in ("cpu", card):
        batch = _family_batch(arch, cfg, dev)
        params = mod.init_params(cfg, 0, device=dev)
        opt = adamw(cosine_schedule(3e-3, 5, 2))
        state = opt.init(params)
        before = seg_mm_call.launches
        loss = mod.loss_fn(params, batch, cfg)
        loss.backward()
        launched = seg_mm_call.launches - before
        grads = [p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p) for p in tree_leaves(params)]
        opt.apply(tree_map(lambda p: p.grad if p.grad is not None
                           else torch.zeros_like(p), params), state, params)
        out[str(dev)] = (loss.item(), grads,
                         [p.detach().clone() for p in tree_leaves(params)],
                         launched)
    loss_c, grads_c, params_c, launched_c = out["cpu"]
    loss_g, grads_g, params_g, launched_g = out[str(card)]
    assert launched_c == 0 and launched_g > 0
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    total = float(torch.sqrt(sum((w.double() ** 2).sum() for w in grads_c)))
    noise = [0 < float(b.norm()) < 1e-3 * total for b in grads_c]
    for a, b in zip(grads_g, grads_c):
        assert float((a.cpu() - b).norm()) <= 1e-4 * max(float(b.norm()),
                                                         1e-3 * total)
    for a, b, skip in zip(params_g, params_c, noise):
        assert skip or float((a.cpu() - b).norm()) <= 1e-3 * float(b.norm())


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4),
                                         (torch.float64, 1e-10)])
def test_family_rotation_invariance_on_card(card, arch, dtype, limit):
    """The JAX test's rotation (tests/test_models_gnn.py) on the reduced
    config, on the card."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.specs import _GNN_MODS
    from repro_torch.models.gnn import so3
    from repro_torch.models.gnn.common import batch_from_graph
    mod = _GNN_MODS[arch]
    cfg = dataclasses.replace(get_arch(arch).config(reduced=True),
                              dtype=dtype)
    rng = np.random.default_rng(2)
    g = tg.erdos_renyi(40, 160, seed=3)
    x = rng.normal(size=(g.n, cfg.d_feat))
    pos = rng.normal(size=(g.n, 3)) * 2
    d1 = so3.wigner_real(1, torch.tensor([1.1], dtype=torch.float64),
                         torch.tensor([0.4], dtype=torch.float64))[0].numpy()
    m = np.array([[0., -1, 0], [0, 0, 1], [1, 0, 0]])
    rot = np.linalg.inv(m) @ d1 @ m
    params = mod.init_params(cfg, 4, device=card)
    with torch.no_grad():
        o1, o2 = (mod.apply(params, batch_from_graph(
            g, x, labels=np.zeros(1), pos=p, device=card), cfg)
            for p in (pos, pos @ rot.T))
    assert bool(torch.isfinite(o1).all())
    scale = max(1e-3, float(o1.abs().max()))
    assert float((o1 - o2).abs().max()) / scale < limit


# --------------------------------------------------------------------- #
# The paper's comparison path and the push backend's device rounds. None
# of these runs a hand-written kernel: they are PyTorch segment sums in a
# fixed order, which must agree with the CPU and repeat bit for bit.
# --------------------------------------------------------------------- #
def _paper_graph():
    g = tg.powerlaw_configuration(3000, 20000, seed=4)
    return g, tc.heterogeneous(g.n, seed=7)


def test_power_nf_on_card_matches_cpu(card):
    g, act = _paper_graph()
    origins = np.sort(np.random.default_rng(1).choice(g.n, 300,
                                                      replace=False))
    out = {}
    for dev in ("cpu", card):
        ops = tc.build_operators(g, act, dtype=torch.float64, device=dev)
        out[str(dev)] = tc.power_nf(ops, tol=1e-9, chunk=128,
                                    origins=origins)
    cpu, gpu = out["cpu"], out[str(card)]
    assert (gpu.matvecs, gpu.max_iterations) == (cpu.matvecs,
                                                 cpu.max_iterations)
    assert np.abs(gpu.psi - cpu.psi).max() <= 1e-12 * np.abs(cpu.psi).max()
    ops = tc.build_operators(g, act, dtype=torch.float64, device=card)
    again = tc.power_nf(ops, tol=1e-9, chunk=128, origins=origins)
    assert np.array_equal(again.psi, gpu.psi)         # run to run bitwise


def test_pagerank_on_card_matches_cpu(card):
    g, _ = _paper_graph()
    res = {str(dev): tc.pagerank(tc.build_pagerank_ops(
        g, dtype=torch.float64, device=dev), alpha=0.85, tol=1e-10)
        for dev in ("cpu", card)}
    cpu, gpu = res["cpu"], res[str(card)]
    assert gpu.iterations == cpu.iterations
    assert float((gpu.pi.cpu() - cpu.pi).abs().max()) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_push_frontier_rounds_repeat_bitwise_on_card(card, dtype):
    from repro_torch.localpush import cold_state, push
    g, act = _paper_graph()
    host = tc.HostOperators.from_graph(g, act)
    fops = push.build_frontier_ops(host, dtype=dtype, device=card)
    assert fops.leaders.device.type == "cuda"
    loop = push.make_frontier_loop(fops, frontier_size=128)
    st = cold_state(host)
    args = [torch.as_tensor(v, dtype=dtype, device=card)
            for v in (st.x, st.r, st.p)]
    a = loop(*args, 1e-4, 400)
    b = loop(*args, 1e-4, 400)
    assert a[3:] == b[3:] and a[3] > 0
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    # the push engine certifies the f64 host ψ after its device rounds
    eng = tc.make_engine("push", graph=g, activity=act, frontier="jit",
                         device=card)
    eng.run(tol=1e-8)
    psi_true, _ = tc.exact_psi(g, act)
    assert eng.last_run_stats["rounds"] > 0
    assert np.abs(eng.last_psi_host - psi_true).max() <= \
        eng.psi_error_bound()


# --------------------------------------------------------------------- #
# Streaming ingestion and the read funnel on the card
# --------------------------------------------------------------------- #
def _flash_ingest(device):
    """A cold f64 ``cuda`` service on ``device`` fed a short flash crowd
    (posts, reposts, follows, unfollows) through a StreamIngestor."""
    from repro_torch.stream import (FreshnessPolicy, StreamIngestor,
                                    flash_crowd_stream)
    n = 3000
    g = tg.powerlaw_configuration(n, 20000, seed=25)
    truth = tc.heterogeneous(n, seed=26)
    horizon = 3000 / float(truth.total.sum())
    log = flash_crowd_stream(g, truth, horizon, new_followers=48, churn=0.5,
                             seed=27)
    cold = tc.Activity(np.full(n, tc.RATE_FLOOR), np.full(n, tc.RATE_FLOOR))
    svc = tc.PsiService(g, cold, tol=1e-10, backend="cuda",
                        dtype=torch.float64, device=device)
    iters = []
    run = svc.engine.run

    def counted(**kw):
        res = run(**kw)
        iters.append(res.iterations)
        return res

    svc.engine.run = counted
    ing = StreamIngestor(svc, half_life=horizon / 2,
                         policy=FreshnessPolicy(coalesce=32,
                                                resolve_every=500))
    rep = ing.ingest(log)
    return svc, ing, rep, iters


def test_stream_ingest_on_card_matches_plain_on_cpu(card):
    """The same flash-crowd ingest on the card (``power_step``) and with
    the plain versions on the CPU: the same resolves, churn and per-resolve
    iterations, s and ψ within ``power_step``'s f64 tolerance."""
    before = power_step_call.launches
    gpu, ing_g, rep_g, it_g = _flash_ingest(card)
    assert power_step_call.launches - before == sum(it_g) > 0
    cpu, ing_c, rep_c, it_c = _flash_ingest("cpu")
    assert rep_g.resolves == rep_c.resolves >= 2
    assert it_g == it_c and ing_g.churn_history == ing_c.churn_history
    assert gpu.graph.m == cpu.graph.m != 20000
    torch.testing.assert_close(gpu.last_result.s.cpu(), cpu.last_result.s,
                               rtol=1e-14, atol=1e-16)
    torch.testing.assert_close(gpu.last_result.psi.cpu(),
                               cpu.last_result.psi, rtol=1e-14, atol=1e-16)


def overflow_follows(svc, rng):
    """``(src, dst)`` new follow edges into the edge-tile engine's fullest
    tile that still has a free sentinel slot: one edge more than the tile
    has free slots, so inserting them all must rebuild the format."""
    eng = svc.engine
    free = eng._tile_capacity - eng._tile_used
    tile = int(np.argmin(np.where(free > 0, free, np.iinfo(np.int64).max)))
    need = int(free[tile]) + 1
    lo = tile * eng.tile
    hi = min(lo + eng.tile, svc.graph.n)
    src, dst = np.empty(0, np.int32), np.empty(0, np.int32)
    while src.size < need:
        s = rng.integers(0, svc.graph.n, 4 * need).astype(np.int32)
        d = rng.integers(lo, hi, 4 * need).astype(np.int32)
        s, d = eng.host.filter_new_edges(np.concatenate([src, s]),
                                         np.concatenate([dst, d]))
        src, dst = s[:need], d[:need]
    return src, dst


def test_stream_edge_flush_overflows_a_tile_on_card(card):
    """Follows that overflow a tile's sentinel slots in one window rebuild
    the edge-tile format; ψ after the resolve is the f64 reference's."""
    from repro_torch.stream import Follow, FreshnessPolicy, StreamIngestor
    g = tg.powerlaw_configuration(3000, 20000, seed=5)
    act = tc.heterogeneous(g.n, seed=6)
    svc = tc.PsiService(g, act, tol=1e-10, backend="cuda",
                        dtype=torch.float64, device=card)
    svc.scores()
    src, dst = overflow_follows(svc, np.random.default_rng(7))
    ing = StreamIngestor(svc, policy=FreshnessPolicy(
        coalesce=len(src), resolve_every=None))
    builds = svc.engine.format_builds
    before = power_step_call.launches
    for k, (s, d) in enumerate(zip(src, dst)):
        ing.submit(Follow(float(k), int(s), int(d)))
    assert svc.engine.format_builds == builds + 1         # one flush, rebuilt
    assert svc.graph.m == g.m + len(src)
    ing.resolve()
    assert power_step_call.launches - before == svc.last_result.iterations
    ref = tc.make_engine("reference", graph=svc.graph, activity=act,
                         dtype=torch.float64, device=card).run(tol=1e-12)
    assert float((svc.last_result.psi - ref.psi).abs().max()) <= 1e-10


def test_read_funnel_adds_no_device_sync_on_card(card, monkeypatch):
    """The funnel's span, histogram and counters read host clocks only:
    cached reads make no CUDA stream wait, and ``engine.run`` waits on the
    stream only under a live tracer (``Span.sync``)."""
    from repro_torch import obs
    waits = []
    sync = torch.cuda.Stream.synchronize

    def counting(self):
        waits.append(self)
        return sync(self)

    monkeypatch.setattr(torch.cuda.Stream, "synchronize", counting)
    prev = obs.configure(registry=obs.MetricsRegistry(),
                         tracker=obs.ConvergenceTracker())
    try:
        g = tg.powerlaw_configuration(3000, 20000, seed=3)
        svc = tc.PsiService(g, tc.heterogeneous(g.n, seed=4),
                            backend="cuda", device=card)
        svc.top_k(5)                              # solve + build the ranking
        assert waits == []                        # null tracer: no span wait
        for _ in range(10):
            users = np.arange(8)
            svc.scores_batch(users)
            svc.rank_of(users)
            svc.top_k(5)
            svc.scores()
        assert waits == []
        reg = obs.metrics.get_registry()
        assert reg.value("psi_query_cache_total", result="hit") == 40
        obs.configure(tracer=obs.Tracer(None))
        svc.update_activity(np.asarray([1]), lam=np.asarray([2.0]))
        assert len(waits) == 1                    # engine.run's Span.sync
        svc.top_k(5)
        svc.scores_batch(np.arange(8))
        assert len(waits) == 1                    # reads: still none
    finally:
        obs.restore(prev)


# --------------------------------------------------------------------- #
# The driver path: the distributed and async backends on the card
# --------------------------------------------------------------------- #
@pytest.fixture
def driver_graph(card):
    g = tg.powerlaw_configuration(5000, 40000, seed=3)
    act = tc.heterogeneous(g.n, seed=4)
    ref = tc.make_engine("reference", graph=g, activity=act,
                         dtype=torch.float64, device=card).run(tol=1e-13)
    return g, act, ref.psi


@pytest.mark.parametrize("backend", ["distributed", "async"])
@pytest.mark.parametrize("dtype,tol,bound", [(torch.float32, 1e-8, 1e-6),
                                             (torch.float64, 1e-12, 1e-10)])
def test_driver_backends_match_f64_reference_on_card(driver_graph, backend,
                                                     dtype, tol, bound):
    """``make_engine("distributed" | "async")`` on the card (a world-1 NCCL
    mesh; 4 chunks on worker streams) lands on the f64 reference's ψ."""
    g, act, ref = driver_graph
    eng = tc.make_engine(backend, graph=g, activity=act, dtype=dtype,
                         device="cuda")
    res = eng.run(tol=tol)
    assert res.converged and res.psi.is_cuda
    assert float((res.psi.double() - ref).abs().max()) <= bound


def test_chunk_step_on_card_matches_its_cpu_copy(driver_graph):
    """One chunk step of every chunk on the card against the same step on
    CPU copies of its args (f64: the segment sums add in another order on
    the card, 1e-13 relative)."""
    from repro_torch.asyncexec import ChunkedOperators, make_chunk_step
    from repro_torch.core import HostOperators
    g, act, _ = driver_graph
    host = HostOperators.from_graph(g, act)
    on_card = ChunkedOperators(host, 4, dtype=torch.float64, device="cuda")
    on_cpu = ChunkedOperators(host, 4, dtype=torch.float64, device="cpu")
    step = make_chunk_step(on_card.q)
    board = on_card.board0 * 1.5
    for a_k, a_c in zip(on_card.args, on_cpu.args):
        s_k, gap_k = step(a_k, board)
        s_c, gap_c = step(a_c, board.cpu())
        torch.testing.assert_close(s_k.cpu(), s_c, rtol=1e-13, atol=0)
        assert float(gap_k) == pytest.approx(float(gap_c), rel=1e-12)


def test_async_tau2_on_worker_streams_reaches_sync_fixed_point(
        driver_graph):
    """τ = 2 with a straggler: 4 workers, each stepping on its own CUDA
    stream, publish fresh boards the scheduling thread reads; the run is
    sync-verified and lands on the reference fixed point."""
    from repro_torch.asyncexec import AsyncPsiDriver
    g, act, ref = driver_graph
    drv = AsyncPsiDriver(g, act, num_chunks=4, tau=2, dtype=torch.float64,
                         device="cuda",
                         delay_hook=lambda k, e: 0.003 if k == 1 else 0.0)
    rep = drv.run(tol=1e-12)
    assert rep.converged and rep.sync_sweeps >= 1
    assert 1 <= rep.max_staleness <= 3
    assert np.abs(rep.psi - ref.cpu().numpy()).max() <= 1e-10


def test_world1_nccl_group_opens_and_closes_twice():
    """A fresh process opens a world-1 mesh over NCCL, runs each
    collective, closes it (the group is destroyed), and does it again."""
    import os
    import subprocess
    import sys
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the card")
    code = (
        "import torch, torch.distributed as dist\n"
        "from repro_torch.launch.mesh import make_mesh\n"
        "for _ in range(2):\n"
        "    m = make_mesh((1, 1), device='cuda')\n"
        "    assert 'nccl' in str(dist.get_backend()), dist.get_backend()\n"
        "    x = torch.arange(4.0, device='cuda')\n"
        "    assert torch.equal(m.reduce_scatter_src(x), x)\n"
        "    assert torch.equal(m.all_gather_model(x), x)\n"
        "    assert float(m.all_reduce_src(x.sum().reshape(1))[0]) == 6.0\n"
        "    m.barrier()\n"
        "    m.close()\n"
        "    assert not dist.is_initialized()\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_distributed_engine_refuses_a_mesh_on_another_device(card):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), device="cpu")
    try:
        with pytest.raises(ValueError, match="mesh is on cpu"):
            tc.make_engine("distributed", mesh=mesh, device="cuda")
    finally:
        mesh.close()
