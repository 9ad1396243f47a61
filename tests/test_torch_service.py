"""The port's serving surface against ``repro.core.PsiService``."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.convert import (bsr_from_numpy, edge_tiles_from_numpy,
                                 warm_start_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = [("reference", None), ("cuda", None), ("cuda", {"regime": "bsr"})]


def _services(backend, opts, n=300, m=1800, seed=3):
    g_t = tg.powerlaw_configuration(n, m, seed=seed)
    g_j = jg.powerlaw_configuration(n, m, seed=seed)
    svc_t = tc.PsiService(g_t, tc.heterogeneous(n, seed=4), backend=backend,
                          device="cpu", engine_opts=opts)
    svc_j = jc.PsiService(g_j, jc.heterogeneous(n, seed=4))
    return svc_t, svc_j


@pytest.mark.parametrize("backend,opts", BACKENDS)
def test_top_k_rank_and_scores_match_jax(backend, opts):
    svc_t, svc_j = _services(backend, opts)
    top_t, vals_t = svc_t.top_k(10)
    top_j, vals_j = svc_j.top_k(10)
    np.testing.assert_array_equal(top_t, top_j)
    np.testing.assert_allclose(vals_t, vals_j, rtol=1e-5)
    users = np.random.default_rng(0).integers(0, 300, 16)
    np.testing.assert_allclose(svc_t.scores_batch(users),
                               svc_j.scores_batch(users), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_array_equal(svc_t.rank_of(users), svc_j.rank_of(users))
    np.testing.assert_allclose(svc_t.scores(), np.asarray(svc_j.scores()),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("backend,opts", BACKENDS)
def test_mutations_track_jax(backend, opts):
    svc_t, svc_j = _services(backend, opts)
    cold = svc_t.last_iterations()
    rng = np.random.default_rng(1)
    users = rng.integers(0, 300, 3)
    lam = rng.uniform(0.5, 2.0, 3)
    src, dst = rng.integers(0, 300, 10), rng.integers(0, 300, 10)
    g = svc_t.graph
    for svc in (svc_t, svc_j):
        svc.update_activity(users, lam=lam)
    assert svc_t.last_iterations() < cold          # warm start pays off
    for svc in (svc_t, svc_j):
        svc.add_edges(src, dst)
        svc.remove_edges(g.src[:5], g.dst[:5])
    assert svc_t.graph.m == svc_j.graph.m
    np.testing.assert_array_equal(svc_t.top_k(10)[0], svc_j.top_k(10)[0])
    np.testing.assert_allclose(svc_t.scores(), np.asarray(svc_j.scores()),
                               rtol=1e-5, atol=1e-9)


def test_deferred_resolve_serves_stale_then_fresh():
    svc_t, _ = _services("cuda", None)
    before = svc_t.scores().copy()
    svc_t.update_activity(np.asarray([5]), lam=np.asarray([9.0]),
                          resolve=False)
    assert svc_t.stale
    np.testing.assert_array_equal(svc_t.scores(), before)
    svc_t.resolve()
    assert not svc_t.stale and not np.array_equal(svc_t.scores(), before)
    svc_t.update_activity(np.asarray([], np.int64))      # empty: a no-op
    assert not svc_t.stale
    with pytest.raises(ValueError):
        svc_t.update_activity(np.asarray([1]), lam=np.asarray([np.nan]))


@pytest.mark.parametrize("backend,opts", BACKENDS)
def test_jax_series_warm_starts_port(backend, opts):
    """A converged JAX series carried through ``convert`` restarts the port
    at its fixed point. At tol 1e-5 (above the ~1e-6 rounding floor of the
    f32 gap on this graph) that takes at most 2 iterations; at tol 1e-8 the
    port still has to settle from the JAX package's last-bit fixed point
    onto its own (gap exactly 0), a few iterations, against ~30 cold."""
    svc_t, svc_j = _services(backend, opts)
    res_j = svc_j.engine.run(tol=1e-8)
    s0 = warm_start_from_numpy(np.asarray(res_j.s), device="cpu")
    cold = svc_t.engine.run(tol=1e-5)
    warm = svc_t.engine.run(tol=1e-5, s0=s0)
    assert warm.converged and warm.iterations <= 2 < cold.iterations
    np.testing.assert_allclose(warm.psi.numpy(), np.asarray(res_j.psi),
                               rtol=1e-5, atol=1e-9)
    tight = svc_t.engine.run(tol=1e-8, s0=s0)
    assert tight.converged and tight.gap == 0.0 and tight.iterations <= 10


def test_jax_formats_convert_to_port_formats():
    from repro.kernels import (DeviceBsr, DeviceEdgeTiles, build_bsr,
                               build_edge_tiles)
    svc_t, _ = _services("cuda", None)
    g_j = jg.powerlaw_configuration(300, 1800, seed=3)
    jfmt = DeviceEdgeTiles.from_format(build_edge_tiles(g_j))
    fields = {f.name: np.asarray(getattr(jfmt, f.name))
              for f in dataclasses.fields(jfmt)}
    fmt = edge_tiles_from_numpy(fields, device="cpu")
    port = svc_t.engine.fmt
    for name in ("src_idx", "dst_local", "block_tile", "tile_first_block",
                 "tile_num_blocks"):
        assert torch.equal(getattr(fmt, name), getattr(port, name)), name
    assert (fmt.n_pad, fmt.n_gather) == (port.n_pad, port.n_gather)
    assert all(type(getattr(fmt, k)) is int for k in ("n", "tile", "e1",
                                                     "num_tiles"))
    jbsr = DeviceBsr.from_format(build_bsr(g_j))
    bfields = {f.name: np.asarray(getattr(jbsr, f.name))
               for f in dataclasses.fields(jbsr)}
    bsr = bsr_from_numpy(bfields, device="cpu")
    assert bsr.tiles.dtype == torch.float32
    assert int(bsr.dst_num_blocks.sum()) == bsr.tiles.shape[0]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    g = tg.powerlaw_configuration(300, 1800, seed=3)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.PsiService(g, tc.heterogeneous(g.n, seed=4), backend="cuda")


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "psi-score", *args], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)


def test_serve_cli_prints_the_jax_top_k():
    out = _serve("--requests", "3", "--device", "cpu", "--backend", "pallas")
    assert out.returncode == 0, out.stderr
    top = re.search(r"\[serve\] top-3: (\[[^\]]*\])", out.stdout).group(1)
    g = jg.powerlaw_configuration(10_000, 70_000, seed=5)
    svc = jc.PsiService(g, jc.heterogeneous(g.n, seed=6), tol=1e-8)
    assert top == str(svc.top_k(3)[0].tolist())
    assert "backend=cuda regime=edge_tile device=cpu" in out.stdout
    assert out.stdout.count("[serve] req ") == 3
    assert "delta update user" in out.stdout


def test_serve_cli_auto_prints_the_plan_and_the_jax_top_k():
    out = _serve("--requests", "2", "--device", "cpu", "--backend", "auto",
                 "--microbench")
    assert out.returncode == 0, out.stderr
    assert re.search(r"backend=auto regime=edge_tile plan=edge_tile\(tile="
                     r"\d+,e1=8,e2=128\) source=microbench device=cpu",
                     out.stdout), out.stdout
    top = re.search(r"\[serve\] top-3: (\[[^\]]*\])", out.stdout).group(1)
    g = jg.powerlaw_configuration(10_000, 70_000, seed=5)
    svc = jc.PsiService(g, jc.heterogeneous(g.n, seed=6), tol=1e-8)
    assert top == str(svc.top_k(3)[0].tolist())


def test_serve_cli_auto_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    out = _serve("--requests", "1", "--backend", "auto", "--microbench",
                 "--accelerate")
    assert out.returncode != 0 and "device='cpu'" in out.stderr


def test_serve_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    out = _serve("--requests", "1")
    assert out.returncode != 0 and "device='cpu'" in out.stderr
