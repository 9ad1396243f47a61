"""The port's checkpoints (``repro_torch.ckpt``) against the JAX package's
(``repro.ckpt``): the cases of ``tests/test_runtime.py`` (round trip and GC,
a torn write, a shape mismatch), a corrupt step falling back, and the same
files read by either package in both directions — a tree written by one
restores in the other bitwise, and a driver's checkpoint of the sharded
iterate (``[d, mo·q]`` in the src layout) restores in the other's driver.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.ckpt.checkpoint as jckpt
import repro.core as jc
import repro.graphs as jg
import repro_torch.core as tc
import repro_torch.graphs as tg
from repro_torch.ckpt import checkpoint
from repro_torch.core.distributed import DistributedPsi
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import PsiDriver


def _tree_t():
    return dict(a=torch.arange(6).reshape(2, 3),
                nested=dict(b=torch.ones(4, dtype=torch.float64) * 3),
                lst=[torch.zeros(2), np.int64(7)])


def _tree_j():
    return dict(a=jnp.arange(6).reshape(2, 3),
                nested=dict(b=jnp.ones((4,)) * 3),
                lst=[jnp.zeros((2,)), jnp.asarray(7)])


def test_checkpoint_roundtrip_and_gc():
    tree = _tree_t()
    with tempfile.TemporaryDirectory() as d:
        for step in (0, 10, 20, 30):
            checkpoint.save(d, step, tree, keep=2)
        assert checkpoint.all_steps(d) == [20, 30]
        assert checkpoint.complete_steps(d) == [20, 30]
        got = checkpoint.restore(d, 30, tree)
        np.testing.assert_array_equal(got["a"], tree["a"].numpy())
        np.testing.assert_array_equal(got["lst"][0], np.zeros((2,)))
        assert int(got["lst"][1]) == 7
        flat = checkpoint.load_arrays(d, 30)
        assert sorted(flat) == ["a", "lst/0", "lst/1", "nested/b"]


def test_checkpoint_torn_write_is_invisible():
    """A *.tmp directory (mid-write crash) is never listed."""
    tree = dict(x=torch.ones(3))
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 5, tree)
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        with open(os.path.join(d, "step_00000009.tmp", "host_0.npz"),
                  "wb") as f:
            f.write(b"garbage")
        assert checkpoint.latest_step(d) == 5


def test_checkpoint_shape_mismatch_raises():
    tree = dict(x=torch.ones(3))
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, tree)
        with pytest.raises(ValueError, match="shape mismatch"):
            checkpoint.restore(d, 1, dict(x=torch.ones(4)))
        # restore_latest demotes it with a warning instead of raising
        with pytest.warns(RuntimeWarning, match="failed to load"):
            assert checkpoint.restore_latest(d, dict(x=torch.ones(4))) \
                is None


def test_corrupt_manifest_falls_back_to_previous_step():
    tree = dict(x=torch.arange(3.0))
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, tree)
        checkpoint.save(d, 2, dict(x=torch.arange(3.0) + 1))
        with open(os.path.join(d, "step_00000002", "MANIFEST.json"),
                  "w") as f:
            f.write("{trunc")
        with pytest.warns(RuntimeWarning, match="corrupt"):
            assert checkpoint.latest_step(d) == 1
        with pytest.warns(RuntimeWarning, match="corrupt"):
            got = checkpoint.restore_latest(d, tree)
        np.testing.assert_array_equal(got["x"], np.arange(3.0))


def test_port_checkpoint_restores_in_jax():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 3, _tree_t())
        with open(os.path.join(d, "step_00000003", "MANIFEST.json")) as f:
            manifest = json.load(f)
        assert manifest["keys"] == ["a", "lst/0", "lst/1", "nested/b"]
        assert jckpt.latest_step(d) == 3
        got = jckpt.restore(d, 3, _tree_j())
        np.testing.assert_array_equal(np.asarray(got["a"]),
                                      np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(np.asarray(got["nested"]["b"]),
                                      np.full(4, 3.0))
        assert int(got["lst"][1]) == 7


def test_jax_checkpoint_restores_in_port():
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 4, _tree_j())
        assert checkpoint.latest_step(d) == 4
        got = checkpoint.restore(d, 4, _tree_t())
        expect = {k: np.asarray(v) for k, v in
                  jckpt.load_arrays(d, 4).items()}
        assert checkpoint.load_arrays(d, 4).keys() == expect.keys()
        np.testing.assert_array_equal(got["a"], expect["a"])
        np.testing.assert_array_equal(got["nested"]["b"], expect["nested/b"])
        np.testing.assert_array_equal(got["lst"][0], expect["lst/0"])


def _drivers(d):
    """The port's and JAX's sync drivers on one graph at f32, (1, 1)."""
    import jax
    from repro.core.distributed import DistributedPsi as JDist
    from repro.runtime import PsiDriver as JDriver
    g_t, g_j = (tg.erdos_renyi(300, 2000, seed=5),
                jg.erdos_renyi(300, 2000, seed=5))
    mesh = make_mesh((1, 1), device="cpu")
    ours = PsiDriver(DistributedPsi.from_graph(
        g_t, tc.heterogeneous(300, seed=6), mesh), ckpt_dir=d,
        chunk_iters=8)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1])
    theirs = JDriver(JDist.from_graph(g_j, jc.heterogeneous(300, seed=6),
                                      jmesh), ckpt_dir=d, chunk_iters=8)
    return ours, theirs, jc.exact_psi(g_j, jc.heterogeneous(300, seed=6))[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_driver_checkpoint_interchanges(writer):
    """A driver that fails at its first chunk restores from the other
    package's last checkpoint and reaches the fixed point from there (ψ
    within 1e-6 of ``exact_psi``)."""
    with tempfile.TemporaryDirectory() as d:
        ours, theirs, psi_true = _drivers(d)
        first, second = (ours, theirs) if writer == "port" else (theirs,
                                                                  ours)
        done = first.run(tol=1e-3)
        step = checkpoint.latest_step(d)
        assert step == done.iterations
        s_file = checkpoint.load_arrays(d, step)["s"]
        assert s_file.shape == (1, ours.dist.part.mo * ours.dist.part.q)
        rep = second.run(tol=1e-7, fail_hook=lambda c: c == 0)
        assert rep.restarts == 1
        cold = PsiDriver(ours.dist, chunk_iters=8).run(tol=1e-7)
        # the restore resumed at the writer's count, not from zero: fewer
        # chunks of its own than a cold run
        assert rep.chunks - rep.restarts < cold.chunks
        assert np.abs(np.asarray(rep.psi) - psi_true).max() <= 1e-6
