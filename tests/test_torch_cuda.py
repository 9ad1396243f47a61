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
from repro_torch.kernels.bsr_spmv import bsr_spmv_call, bsr_spmv_plain
from repro_torch.kernels.edge_spmv import edge_spmv_call, edge_spmv_plain
from repro_torch.kernels.formats import (build_bsr, build_edge_tiles,
                                         pad_edge_tile_blocks)
from repro_torch.kernels.ops import (DeviceBsr, DeviceEdgeTiles, bsr_spmv,
                                     edge_spmv)
from repro_torch.kernels.power_step import power_step_call, power_step_plain

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
# the last bit; the tolerances are power_step's.
@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-6, 1e-7),
                                             (torch.float64, 1e-14, 1e-16)])
def test_edge_spmv_kernel_matches_plain_on_card(card, tile, weighted, dtype,
                                                rtol, atol):
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
    torch.testing.assert_close(o1.cpu(), op, rtol=rtol, atol=atol)


@pytest.mark.parametrize("td", [128, 256])
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
    counter = power_step_call if regime == "edge_tile" else bsr_spmv_call
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
    assert launched == (4 * len(autotune.EDGE_TILE_CANDIDATES)
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
