"""The port's graph generators, datasets and formats are bitwise those of the
JAX package for the same seeds."""
import dataclasses

import numpy as np
import pytest

import repro.graphs as jg
import repro.kernels.formats as jf
import repro_torch.graphs as tg
import repro_torch.kernels.formats as tf

GENERATORS = [
    ("erdos_renyi", lambda m, s: m.erdos_renyi(200, 900, seed=s)),
    ("powerlaw", lambda m, s: m.powerlaw_configuration(300, 1800, seed=s)),
    ("clustered", lambda m, s: m.clustered_blocks(300, 2000, block=64,
                                                  p_in=0.9, seed=s)),
    ("rmat", lambda m, s: m.rmat(8, 8, seed=s)),
    ("barabasi_albert", lambda m, s: m.barabasi_albert(150, 3, seed=s)),
]


def _same_graph(a, b):
    assert a.n == b.n and a.name == b.name
    assert a.src.dtype == b.src.dtype and a.dst.dtype == b.dst.dtype
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)


def _same_fields(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("gname,make", GENERATORS)
def test_generators_bitwise(gname, make, seed):
    _same_graph(make(tg, seed), make(jg, seed))


@pytest.mark.parametrize("name", ["dblp", "tiny"])
def test_load_dataset_bitwise(name):
    a, b = tg.load_dataset(name), jg.load_dataset(name)
    _same_graph(a, b)
    assert tg.DATASETS == jg.DATASETS


def test_graph_views_match():
    a = tg.powerlaw_configuration(300, 1800, seed=3)
    b = jg.powerlaw_configuration(300, 1800, seed=3)
    for attr in ("out_degree", "in_degree", "csr_indptr", "csc_indptr"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    for attr in ("edges_by_dst", "edges_by_src"):
        for x, y in zip(getattr(a, attr), getattr(b, attr)):
            np.testing.assert_array_equal(x, y)
    _same_graph(a.dedup(), b.dedup())


@pytest.mark.parametrize("tile,e1,e2", [(128, 8, 128), (256, 8, 128),
                                        (128, 1, 32)])
@pytest.mark.parametrize("seed", [3, 4])
def test_edge_tiles_bitwise(tile, e1, e2, seed):
    g_t = tg.powerlaw_configuration(700, 4200, seed=seed)
    g_j = jg.powerlaw_configuration(700, 4200, seed=seed)
    a = tf.build_edge_tiles(g_t, tile=tile, e1=e1, e2=e2)
    b = jf.build_edge_tiles(g_j, tile=tile, e1=e1, e2=e2)
    _same_fields(a, b)
    _same_fields(tf.pad_edge_tile_blocks(a, a.num_blocks + 5),
                 jf.pad_edge_tile_blocks(b, b.num_blocks + 5))


@pytest.mark.parametrize("ts,td", [(128, 128), (128, 256), (64, 32)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bsr_bitwise(ts, td, dtype):
    g_t = tg.clustered_blocks(600, 5000, block=128, p_in=0.9, seed=5)
    g_j = jg.clustered_blocks(600, 5000, block=128, p_in=0.9, seed=5)
    _same_fields(tf.build_bsr(g_t, ts=ts, td=td, dtype=dtype),
                 jf.build_bsr(g_j, ts=ts, td=td, dtype=dtype))


def test_block_ranges_follow_block_tile_not_last_flags():
    g = tg.erdos_renyi(300, 1500, seed=21)
    fmt = tf.build_edge_tiles(g, tile=128)
    padded = tf.pad_edge_tile_blocks(fmt, fmt.num_blocks + 4)
    first, count = padded.tile_first_block, padded.tile_num_blocks
    np.testing.assert_array_equal(
        first, np.searchsorted(padded.block_tile, np.arange(fmt.num_tiles)))
    assert count.sum() == padded.num_blocks
    assert count[-1] == fmt.tile_num_blocks[-1] + 4      # pad blocks
    for t in range(fmt.num_tiles):
        blocks = padded.block_tile[first[t]:first[t] + count[t]]
        assert np.all(blocks == t)
    bsr = tf.build_bsr(g, ts=64, td=64)
    np.testing.assert_array_equal(
        np.repeat(np.arange(bsr.num_dst_tiles), bsr.dst_num_blocks),
        bsr.dst_tile)
    with pytest.raises(ValueError):
        tf.block_ranges(np.asarray([0, 2, 1]), 3)
