"""Checks that need a CUDA card: each kernel against its plain version, run
to run bitwise equal, and a whole solve on the card. They skip without a
card; on one, run them with::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only the port (the card's machine has no JAX).
"""
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
                                           edge_spmv_plain)
from repro_torch.kernels.formats import (build_bsr, build_edge_tiles,
                                         pad_edge_tile_blocks, tile_spans)
from repro_torch.kernels.ops import (DeviceBsr, DeviceEdgeTiles, bsr_spmv,
                                     bsr_step, edge_spmv)
from repro_torch.kernels.power_step import (power_step_call,
                                            power_step_lanes_call,
                                            power_step_lanes_plain,
                                            power_step_plain)
from test_torch_edge_layouts import KINDS, edge_tile_layout, slot_weights

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


# The fleet's cuda regime on the card: each lane's iterations, gap and s
# equal the solo cuda engine's at the bucket's tile (bitwise: the same
# kernel, the same slot order, the same inputs), one power_step_lanes launch
# a step. The engine's ψ epilogue pushes with torch.segment_reduce, whose
# sum on the card is not a slot-order fold, so the lane's ψ is held bitwise
# against the fleet's epilogue (the edge_spmv kernel, then · 1/n) on the
# engine's s, and within relative L1 1e-6 of the engine's own ψ.
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
        ops = eng.ops
        inv_n = torch.tensor(1.0, device=card) / g.n
        psi = (ops.lam * edge_spmv(res.s * ops.inv_w, eng.fmt) + ops.d) \
            * inv_n
        assert np.array_equal(fleet.psi(f"t{i}"), psi.cpu().numpy())
        rel = float((psi - res.psi).abs().sum() / res.psi.abs().sum())
        assert rel <= 1e-6


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
