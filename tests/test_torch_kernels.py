"""Kernel modules of the port against the JAX package's Pallas kernels
(interpret mode) and the oracles. The kernels themselves run only on a card:
their checks against the plain versions are in ``test_torch_cuda.py``.

Tolerances are those of the JAX package's own kernel sweeps: ``s_new`` at
rtol 2e-5 / atol 2e-6 and the gap at relative 1e-3 for the fused step,
rtol/atol 2e-5 for the BSR product and the bare ``edge_spmv`` push — f32
sums taken in another order. At f64 the push is held at 1e-12. ``seg_mm``'s
plain version is held against the Pallas kernel at rtol 2e-5 / atol 2e-6
(f32, the one-hot matmul sums in another order).
"""
import stat

import numpy as np
import pytest
import torch

import repro.graphs as jg
import repro.kernels as jk
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.kernels import _build, ref
from repro_torch.kernels.bsr_spmv import bsr_spmv_call
from repro_torch.kernels.edge_spmv import edge_spmv_call
from repro_torch.kernels.formats import (build_bsr, build_edge_tiles,
                                         pad_edge_tile_blocks, tile_spans)
from repro_torch.kernels.ops import (DeviceBsr, DeviceEdgeTiles, bsr_spmv,
                                     bsr_step, edge_spmv, power_step, seg_mm)
from repro_torch.kernels.power_step import power_step_call
from repro_torch.kernels.seg_mm import SegMM, seg_mm_call, seg_mm_plain
from repro_torch.models.gnn.common import edge_agg

GRAPHS = [
    ("er-small", lambda m: m.erdos_renyi(100, 500, seed=1)),
    ("er-dense", lambda m: m.erdos_renyi(256, 8000, seed=2)),
    ("powerlaw", lambda m: m.powerlaw_configuration(700, 4200, seed=3)),
    ("tiny", lambda m: m.erdos_renyi(40, 80, seed=4)),
]
TILES = [(128, 8, 128), (256, 8, 128), (512, 16, 128)]


def _step_inputs(gname, gfn, tile, e1, e2, pad_blocks=0, seed=0):
    """The same numpy-seeded step inputs for both packages."""
    g_t, g_j = gfn(tg), gfn(jg)
    act = tc.heterogeneous(g_t.n, seed=seed + 7)
    ops = tc.build_operators(g_t, act, device="cpu")
    fmt_h = build_edge_tiles(g_t, tile=tile, e1=e1, e2=e2)
    fmt_hj = jk.build_edge_tiles(g_j, tile=tile, e1=e1, e2=e2)
    if pad_blocks:
        fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + pad_blocks)
        fmt_hj = jk.formats.pad_edge_tile_blocks(
            fmt_hj, fmt_hj.num_blocks + pad_blocks)
    s = np.random.default_rng(seed).uniform(size=g_t.n).astype(np.float32)
    return g_t, ops, fmt_h, fmt_hj, s


def _jax_step(fmt_hj, ops, s):
    import jax.numpy as jnp
    fmt = jk.DeviceEdgeTiles.from_format(fmt_hj)
    inv_w, mu, c = (jnp.asarray(x.numpy()) for x in (ops.inv_w, ops.mu,
                                                     ops.c))
    s_new, gap = jk.power_step(fmt.pad_node_vector(jnp.asarray(s)),
                               fmt.pad_gather_source(inv_w),
                               fmt.pad_node_vector(mu),
                               fmt.pad_node_vector(c), fmt, interpret=True)
    return np.asarray(s_new)[0], float(gap)


def _port_step(fmt_h, ops, s):
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cpu")
    s_new, gap = power_step(fmt.pad_node_vector(torch.as_tensor(s)),
                            fmt.pad_gather_source(ops.inv_w),
                            fmt.pad_node_vector(ops.mu),
                            fmt.pad_node_vector(ops.c), fmt)
    return s_new.numpy()[0], float(gap)


@pytest.mark.parametrize("gname,gfn", GRAPHS)
@pytest.mark.parametrize("tile,e1,e2", TILES[:2])
def test_power_step_plain_matches_pallas(gname, gfn, tile, e1, e2):
    g, ops, fmt_h, fmt_hj, s = _step_inputs(gname, gfn, tile, e1, e2)
    s_t, gap_t = _port_step(fmt_h, ops, s)
    s_j, gap_j = _jax_step(fmt_hj, ops, s)
    np.testing.assert_allclose(s_t, s_j, rtol=2e-5, atol=2e-6)
    assert abs(gap_t - gap_j) < 1e-3 * max(1.0, gap_j)


def test_power_step_plain_matches_pallas_on_padded_blocks():
    g, ops, fmt_h, fmt_hj, s = _step_inputs(*GRAPHS[2], 256, 8, 128,
                                            pad_blocks=6)
    s_t, gap_t = _port_step(fmt_h, ops, s)
    s_j, gap_j = _jax_step(fmt_hj, ops, s)
    np.testing.assert_allclose(s_t, s_j, rtol=2e-5, atol=2e-6)
    assert abs(gap_t - gap_j) < 1e-3 * max(1.0, gap_j)
    assert np.all(s_t[g.n:] == 0.0)


@pytest.mark.parametrize("gname,gfn", GRAPHS)
def test_power_step_matches_oracle_f64(gname, gfn):
    g = gfn(tg)
    ops = tc.build_operators(g, tc.heterogeneous(g.n, seed=3),
                             dtype=torch.float64, device="cpu")
    fmt = DeviceEdgeTiles.from_format(build_edge_tiles(g, tile=128), "cpu")
    s = torch.as_tensor(np.random.default_rng(2).uniform(size=g.n))
    s_new, gap = power_step(fmt.pad_node_vector(s),
                            fmt.pad_gather_source(ops.inv_w),
                            fmt.pad_node_vector(ops.mu),
                            fmt.pad_node_vector(ops.c), fmt)
    src, dst = (torch.as_tensor(x) for x in g.edges_by_dst)
    ref_s, ref_gap = ref.power_step_ref(s, ops.inv_w, ops.mu, ops.c, src,
                                        dst, g.n)
    np.testing.assert_allclose(s_new[0, :g.n].numpy(), ref_s.numpy(),
                               rtol=1e-12, atol=1e-15)
    assert abs(float(gap) - float(ref_gap)) <= 1e-12 * float(ref_gap)


def _slot_weights(fmt_h, seed, dtype=np.float32):
    """Per-edge weights in the padded slot layout (zero in sentinel slots),
    and the same weights in edge order, as the JAX weighted sweep builds
    them."""
    rng = np.random.default_rng(seed)
    slot = fmt_h.src_idx.reshape(-1) != fmt_h.n
    w_edge = rng.uniform(size=int(slot.sum())).astype(dtype)
    wpad = np.zeros(fmt_h.src_idx.size, dtype)
    wpad[slot] = w_edge
    return wpad.reshape(fmt_h.src_idx.shape), w_edge


@pytest.mark.parametrize("gname,gfn", GRAPHS)
@pytest.mark.parametrize("tile,e1,e2", TILES[:2])
@pytest.mark.parametrize("weighted", [False, True])
def test_edge_spmv_plain_matches_pallas(gname, gfn, tile, e1, e2, weighted):
    import jax.numpy as jnp
    from repro.kernels.ref import edge_spmv_ref as jax_edge_spmv_ref
    g_t, g_j = gfn(tg), gfn(jg)
    fmt_h = build_edge_tiles(g_t, tile=tile, e1=e1, e2=e2)
    s = np.random.default_rng(0).uniform(size=g_t.n).astype(np.float32)
    wpad, w_edge = _slot_weights(fmt_h, 2) if weighted else (None, None)
    out_t = edge_spmv(torch.as_tensor(s),
                      DeviceEdgeTiles.from_format(fmt_h, "cpu"),
                      None if wpad is None else torch.as_tensor(wpad))
    out_j = jk.edge_spmv(jnp.asarray(s), jk.DeviceEdgeTiles.from_format(
        jk.build_edge_tiles(g_j, tile=tile, e1=e1, e2=e2)),
        weights=None if wpad is None else jnp.asarray(wpad), interpret=True)
    src, dst = g_t.edges_by_dst
    ref_t = ref.edge_spmv_ref(torch.as_tensor(s), torch.as_tensor(src),
                              torch.as_tensor(dst), g_t.n,
                              None if w_edge is None
                              else torch.as_tensor(w_edge))
    ref_j = jax_edge_spmv_ref(jnp.asarray(s), jnp.asarray(src),
                              jnp.asarray(dst), g_j.n,
                              None if w_edge is None else jnp.asarray(w_edge))
    assert out_t.shape == (g_t.n,) and out_t.dtype == torch.float32
    for other in (np.asarray(out_j), ref_t.numpy(), np.asarray(ref_j)):
        np.testing.assert_allclose(out_t.numpy(), other, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("gname,gfn", GRAPHS)
@pytest.mark.parametrize("tile,e1,e2", TILES)
@pytest.mark.parametrize("weighted", [False, True])
def test_edge_spmv_plain_matches_oracle_f64(gname, gfn, tile, e1, e2,
                                            weighted):
    g = gfn(tg)
    fmt_h = build_edge_tiles(g, tile=tile, e1=e1, e2=e2)
    fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + 3)
    s = torch.as_tensor(np.random.default_rng(1).uniform(size=g.n))
    wpad, w_edge = (_slot_weights(fmt_h, 3, np.float64) if weighted
                    else (None, None))
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cpu")
    out = edge_spmv(s, fmt, None if wpad is None else torch.as_tensor(wpad))
    src, dst = (torch.as_tensor(x) for x in g.edges_by_dst)
    want = ref.edge_spmv_ref(s, src, dst, g.n, None if w_edge is None
                             else torch.as_tensor(w_edge))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    # the raw call's padded tail beyond n is zero
    raw = edge_spmv_call(fmt.pad_gather_source(s), fmt.src_idx,
                         fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                         fmt.tile_num_blocks, n=g.n, tile=tile)
    assert raw.shape == (1, fmt.n_pad) and bool((raw[0, g.n:] == 0).all())


@pytest.mark.parametrize("gname,gfn", GRAPHS[:3])
@pytest.mark.parametrize("ts,td", [(128, 128), (128, 256)])
def test_bsr_spmv_plain_matches_pallas(gname, gfn, ts, td):
    import jax.numpy as jnp
    g_t, g_j = gfn(tg), gfn(jg)
    s = np.random.default_rng(1).uniform(size=g_t.n).astype(np.float32)
    out_t = bsr_spmv(torch.as_tensor(s),
                     DeviceBsr.from_format(build_bsr(g_t, ts=ts, td=td),
                                           "cpu"))
    out_j = jk.bsr_spmv(jnp.asarray(s), jk.DeviceBsr.from_format(
        jk.build_bsr(g_j, ts=ts, td=td)), interpret=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("gname,gfn", GRAPHS[:3])
@pytest.mark.parametrize("td", [128, 256])
def test_bsr_step_plain_matches_pallas_bsr_step(gname, gfn, td):
    """The fused BSR step's plain version against the JAX package's
    ``pallas`` bsr step (``mu * bsr_spmv(s * inv_w) + c`` and the L1 gap,
    the Pallas kernel in interpret mode) on the same seeded inputs: s_new
    at rtol 2e-5 / atol 2e-6, the gap at relative 1e-3 (f32 sums in
    another order)."""
    import jax.numpy as jnp
    g_t, g_j = gfn(tg), gfn(jg)
    ops = tc.build_operators(g_t, tc.heterogeneous(g_t.n, seed=7),
                             device="cpu")
    s = np.random.default_rng(2).uniform(size=g_t.n).astype(np.float32)
    fmt = DeviceBsr.from_format(build_bsr(g_t, td=td), "cpu")
    assert fmt.tiles.dtype == torch.uint8
    s_new, gap = bsr_step(torch.as_tensor(s), ops.inv_w, ops.mu, ops.c, fmt)
    inv_w, mu, c = (jnp.asarray(x.numpy()) for x in (ops.inv_w, ops.mu,
                                                     ops.c))
    s_j = jnp.asarray(s)
    s_new_j = mu * jk.bsr_spmv(s_j * inv_w, jk.DeviceBsr.from_format(
        jk.build_bsr(g_j, td=td)), interpret=True) + c
    gap_j = float(jnp.sum(jnp.abs(s_new_j - s_j)))
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_new_j),
                               rtol=2e-5, atol=2e-6)
    assert abs(float(gap) - gap_j) <= 1e-3 * gap_j


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["counts", "weights", "counts past 255"])
def test_device_bsr_keeps_count_tiles_in_one_byte(kind, dtype):
    """Edge counts in [0, 255] are stored as uint8; non-integer edge values
    or a count past 255 keep the working dtype. The push gives the same
    bits in either storage (the plain version takes uint8 in T)."""
    g = tg.clustered_blocks(600, 5000, block=128, p_in=0.95, seed=2)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    if kind == "counts past 255":           # one edge 300 times over
        g = tg.Graph(g.n, np.concatenate([g.src, np.full(300, 3)]),
                     np.concatenate([g.dst, np.full(300, 5)]))
    vals = (np.random.default_rng(3).uniform(0.5, 2.0, g.m)
            if kind == "weights" else None)
    fmt_h = build_bsr(g, edge_values=vals, dtype=np_dtype)
    fmt = DeviceBsr.from_format(fmt_h, "cpu")
    want = torch.uint8 if kind == "counts" else dtype
    assert fmt.tiles.dtype == want
    np.testing.assert_array_equal(fmt.tiles.numpy(), fmt_h.tiles)
    s = torch.as_tensor(np.random.default_rng(4).uniform(size=g.n),
                        dtype=dtype)
    wide = DeviceBsr(**{**vars(fmt), "tiles": torch.as_tensor(fmt_h.tiles)})
    assert torch.equal(bsr_spmv(s, fmt), bsr_spmv(s, wide))


def test_bsr_spmv_matches_oracle_with_uncovered_dst_tiles():
    g = tg.erdos_renyi(500, 40, seed=5)        # most dst tiles hold no edge
    s = torch.as_tensor(np.random.default_rng(4).uniform(size=g.n))
    fmt = DeviceBsr.from_format(build_bsr(g, ts=64, td=64,
                                          dtype=np.float64), "cpu")
    out = bsr_spmv(s, fmt)
    src, dst = (torch.as_tensor(x) for x in g.edges_by_dst)
    np.testing.assert_allclose(out.numpy(),
                               ref.edge_spmv_ref(s, src, dst, g.n).numpy(),
                               rtol=1e-12, atol=1e-15)
    dense = torch.as_tensor(g.to_dense())
    np.testing.assert_allclose(ref.bsr_spmv_ref(s, dense).numpy(),
                               out.numpy(), rtol=1e-12, atol=1e-15)


def test_oracles_match_jax_oracles():
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    g = tg.powerlaw_configuration(300, 1800, seed=5)
    src, dst = g.edges_by_dst
    rng = np.random.default_rng(3)
    s = rng.uniform(size=g.n).astype(np.float32)
    x = rng.normal(size=(g.m, 8)).astype(np.float32)
    np.testing.assert_allclose(
        ref.edge_spmv_ref(torch.as_tensor(s), torch.as_tensor(src),
                          torch.as_tensor(dst), g.n).numpy(),
        np.asarray(jref.edge_spmv_ref(jnp.asarray(s), jnp.asarray(src),
                                      jnp.asarray(dst), g.n)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ref.seg_mm_ref(torch.as_tensor(x), torch.as_tensor(dst), g.n).numpy(),
        np.asarray(jref.seg_mm_ref(jnp.asarray(x), jnp.asarray(dst), g.n)),
        rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    """No silent fallback: only a CPU tensor takes the plain version."""
    meta = torch.empty(1, 257, device="meta")
    idx = torch.empty(1, 8, 128, dtype=torch.int32, device="meta")
    tiles_i = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        power_step_call(meta, idx, idx, tiles_i, tiles_i, tiles_i,
                        meta[:, :256], meta[:, :256], meta[:, :256],
                        n=200, tile=256)
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_spmv_call(meta, idx, idx, tiles_i, tiles_i, tiles_i, n=200,
                       tile=256)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bsr_spmv_call(torch.empty(1, 128, device="meta"),
                      torch.empty(1, 128, 128, device="meta"), tiles_i,
                      tiles_i, tiles_i, tiles_i, num_dst_tiles=1)


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home


def test_build_failure_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    home = _fake_nvcc(tmp_path, "echo 'error: bad kernel' >&2\nexit 2\n")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all(("power_step",))
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_writes_library_and_log_then_reuses(tmp_path, monkeypatch):
    # a stand-in compiler: writes the -o target and a ptxas-style report
    body = ('while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\necho "Used 18 registers" >&2\n'
            f'echo x >> {tmp_path}/calls\n')
    home = _fake_nvcc(tmp_path, body)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    libs = _build.build_all()
    assert sorted(libs) == sorted(_build.SOURCES)
    for path in libs.values():
        assert path.exists() and path.suffix == ".so"
        assert "registers" in path.with_suffix(".log").read_text()
    _build.build_all()                          # unchanged sources: no nvcc
    assert (tmp_path / "calls").read_text().count("x") == len(_build.SOURCES)
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not list((tmp_path / "build").glob("*.tmp"))


def _seg_mm_both(d, tile=128, e1=8, e2=128, pad_blocks=0):
    """seg_mm of the same gathered messages through the port (plain) and
    the JAX package (Pallas, interpret mode), and the oracle's sum."""
    from repro.kernels.ref import seg_mm_ref as jax_seg_mm_ref
    g_t = tg.powerlaw_configuration(300, 1800, seed=5)
    g_j = jg.powerlaw_configuration(300, 1800, seed=5)
    fmt_h = build_edge_tiles(g_t, tile=tile, e1=e1, e2=e2)
    fmt_hj = jk.build_edge_tiles(g_j, tile=tile, e1=e1, e2=e2)
    if pad_blocks:
        fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + pad_blocks)
        fmt_hj = jk.formats.pad_edge_tile_blocks(
            fmt_hj, fmt_hj.num_blocks + pad_blocks)
    x = np.random.default_rng(3).normal(size=(g_t.n, d)).astype(np.float32)
    xpad = np.concatenate([x, np.zeros((1, d), np.float32)])
    msgs = xpad[fmt_h.src_idx.reshape(fmt_h.num_blocks, -1)]
    out_t = seg_mm(torch.as_tensor(msgs),
                   DeviceEdgeTiles.from_format(fmt_h, "cpu"))
    out_j = jk.ops.seg_mm(jnp_asarray(msgs),
                          jk.DeviceEdgeTiles.from_format(fmt_hj),
                          interpret=True)
    src, dst = g_t.edges_by_dst
    want = np.asarray(jax_seg_mm_ref(jnp_asarray(x[src]), jnp_asarray(dst),
                                     g_t.n))
    return out_t, np.asarray(out_j), want


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


@pytest.mark.parametrize("d", [8, 16, 64])
def test_seg_mm_plain_matches_pallas(d):
    out_t, out_j, want = _seg_mm_both(d)
    assert out_t.shape == (300, d) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out_t.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("tile,e1,e2,pad_blocks", [(256, 2, 128, 0),
                                                   (512, 2, 128, 3),
                                                   (128, 8, 128, 5)])
def test_seg_mm_plain_matches_pallas_at_other_formats(tile, e1, e2,
                                                      pad_blocks):
    out_t, out_j, want = _seg_mm_both(16, tile, e1, e2, pad_blocks)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out_t.numpy(), want, rtol=2e-5, atol=2e-6)


def test_seg_mm_gradcheck_f64():
    g = tg.erdos_renyi(90, 300, seed=6)
    fmt = DeviceEdgeTiles.from_format(build_edge_tiles(g, tile=32, e1=1,
                                                       e2=32), "cpu")
    msgs = torch.tensor(np.random.default_rng(4).normal(
        size=(fmt.src_idx.shape[0], 32, 3)), requires_grad=True)
    args = (fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
            fmt.tile_num_blocks, fmt.tile)
    assert torch.autograd.gradcheck(lambda m: SegMM.apply(m, *args), (msgs,))


def test_seg_mm_plain_writes_zeros_for_tiles_without_blocks():
    """A tile whose range is empty or holds only padding blocks sums to 0,
    and the raw call returns every tile's rows."""
    g = tg.erdos_renyi(100, 400, seed=7)
    fmt_h = pad_edge_tile_blocks(build_edge_tiles(g, tile=64, e1=1, e2=64),
                                 build_edge_tiles(g, tile=64, e1=1,
                                                  e2=64).num_blocks + 2)
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cpu")
    msgs = torch.zeros(fmt_h.num_blocks, 64, 5, dtype=torch.float64)
    msgs[:-2] = torch.as_tensor(np.random.default_rng(5).normal(
        size=(fmt_h.num_blocks - 2, 64, 5)))
    msgs[torch.as_tensor(fmt_h.src_idx.reshape(fmt_h.num_blocks, 64)
                         == g.n)] = 0.0
    out = seg_mm_call(msgs, fmt.dst_local, fmt.block_tile,
                      fmt.tile_first_block, fmt.tile_num_blocks, tile=64)
    assert out.shape == (fmt.n_pad, 5)
    src, dst = (torch.as_tensor(x) for x in g.edges_by_dst)
    real = torch.as_tensor(fmt_h.src_idx.reshape(-1) != g.n)
    want = ref.seg_mm_ref(msgs.reshape(-1, 5)[real], dst, g.n)
    np.testing.assert_allclose(out[:g.n].numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert bool((out[g.n:] == 0).all())
    empty = seg_mm_plain(msgs[:0], fmt.dst_local[:0], fmt.block_tile[:0],
                         tile=64, num_tiles=2)
    assert empty.shape == (128, 5) and bool((empty == 0).all())


def test_tile_spans_end_at_each_tiles_last_real_slot():
    """tile_spans counts a tile's slots up to its last real one: the real
    edge count on a fresh build (pad blocks add nothing), the slot of the
    last real edge when slots are shuffled, 0 for a tile without one; the
    GNN's edge_agg counts the same spans for its format."""
    g = tg.erdos_renyi(2000, 9000, seed=1)
    keep = (g.dst < 512) | (g.dst >= 1024)          # tile 1 gets no edge
    g = tg.Graph(g.n, g.src[keep], g.dst[keep])
    fmt_h = pad_edge_tile_blocks(build_edge_tiles(g, tile=512, e1=2, e2=128),
                                 build_edge_tiles(g, tile=512, e1=2,
                                                  e2=128).num_blocks + 3)
    want = np.bincount(g.dst // 512, minlength=fmt_h.num_tiles)
    spans = tile_spans(fmt_h.src_idx, g.n, fmt_h.block_tile, fmt_h.num_tiles)
    np.testing.assert_array_equal(spans, want)
    assert spans[1] == 0
    agg = edge_agg(g.src, g.dst, g.n, tiles=(512, 2, 128), device="cpu")
    np.testing.assert_array_equal(agg.tile_span.numpy(), want)
    np.testing.assert_array_equal(
        agg.tile_span.numpy(),
        tile_spans(agg.fmt.src_idx.numpy(), g.n, agg.fmt.block_tile.numpy(),
                   agg.fmt.num_tiles))
    src = fmt_h.src_idx.reshape(fmt_h.num_blocks, -1).copy()
    first, count = fmt_h.tile_first_block, fmt_h.tile_num_blocks
    rng = np.random.default_rng(2)
    last = np.zeros(fmt_h.num_tiles, np.int64)
    for t, (a, c) in enumerate(zip(first, count)):
        flat = src[a:a + c].reshape(-1)
        flat[:] = flat[rng.permutation(flat.size)]
        real = np.flatnonzero(flat != g.n)
        last[t] = real[-1] + 1 if real.size else 0
    np.testing.assert_array_equal(
        tile_spans(src, g.n, fmt_h.block_tile, fmt_h.num_tiles), last)


def test_seg_mm_plain_ignores_the_tile_span():
    """The plain version adds every slot; the span only lets the kernel
    skip trailing padding, so the call's result does not depend on it."""
    g = tg.erdos_renyi(300, 1500, seed=9)
    fmt_h = pad_edge_tile_blocks(build_edge_tiles(g, tile=128, e1=2, e2=64),
                                 build_edge_tiles(g, tile=128, e1=2,
                                                  e2=64).num_blocks + 2)
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cpu")
    x = np.random.default_rng(6).normal(size=(g.n + 1, 7))
    x[g.n] = 0.0
    msgs = torch.as_tensor(x[fmt_h.src_idx.reshape(fmt_h.num_blocks, -1)])
    args = (msgs, fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
            fmt.tile_num_blocks)
    span = torch.as_tensor(tile_spans(fmt_h.src_idx, g.n, fmt_h.block_tile,
                                      fmt_h.num_tiles))
    assert torch.equal(seg_mm_call(*args, tile=128),
                       seg_mm_call(*args, tile=128, tile_span=span))
    assert torch.equal(seg_mm(msgs, fmt, tile_span=span),
                       seg_mm(msgs, fmt))
    assert torch.equal(seg_mm(msgs, fmt), seg_mm_call(*args, tile=128)[:g.n])


def test_seg_mm_refuses_devices_other_than_cuda_and_cpu():
    meta = torch.empty(1, 256, 8, device="meta")
    idx = torch.empty(1, 256, dtype=torch.int32, device="meta")
    tiles_i = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        seg_mm_call(meta, idx, tiles_i, tiles_i, tiles_i, tile=256)
