"""The port's row-sharded embedding lookup and the MIND loss on 8 gloo ranks
of a ``(2, 4)`` mesh, against the unsharded port and the JAX package.

Eight spawned ranks (``file://`` rendezvous in a temporary directory, no
port) each hold a quarter of a table's rows and their data row's ids:

* ``sharded_lookup`` of the JAX package's ``test_sharded_embedding_lookup_
  and_grads`` (a 64 × 8 float32 table, ids [8, 3]): the forward and the
  table gradient of ``sum(out²)``, summed over each column, bitwise the
  unsharded gather's and bitwise JAX's ``sharded_lookup`` (a subprocess
  with 8 forced host devices and an Auto-axes ``(2, 4)`` mesh). A backward
  that summed the cotangent over the model group would give 4× the
  gradient (and ``ModelSum``'s own gradient is checked to be the
  identity).
* ``mind.loss_and_grads`` of the reduced config at float64 on sharded
  parameters and a 4-user share of the batch each: the loss and every
  gradient within 1e-12 of world 1's (no mesh).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models.recsys import mind

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHAPE = (2, 4)
USERS = 8

_JAX_SCRIPT = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.models.recsys.embedding import sharded_lookup
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
tbl = jnp.asarray(np.random.default_rng(0).normal(size=(64, 8))
                  .astype(np.float32))
tbl_s = jax.device_put(tbl, NamedSharding(mesh, P("model", None)))
ids = jnp.asarray(np.random.default_rng(1).integers(0, 64, (8, 3)))
out = sharded_lookup(tbl_s, ids, mesh, batch_axes=("data",))
g = jax.grad(lambda t: jnp.sum(
    sharded_lookup(t, ids, mesh, batch_axes=("data",)) ** 2))(tbl_s)
np.savez(sys.argv[1], out=np.asarray(out), grad=np.asarray(g))
"""

_RANK_SCRIPT = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
import torch.multiprocessing as mp


def batch(cfg):
    from repro_torch.launch import train
    hb = train.recsys_host_batch(cfg, USERS, np.random.default_rng(0),
                                 tags=4)
    hb["profile_ids"][::5] = cfg.n_profile          # sentinels
    return hb


def rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/pg",
                            rank=rank, world_size=world)
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.recsys import mind
    from repro_torch.models.recsys.embedding import ModelSum, sharded_lookup
    mesh = make_mesh(SHAPE, device="cpu")
    res, arrays = dict(row=mesh.row, col=mesh.col), {}
    # the JAX test's lookup: a quarter of the rows, a data row's ids
    tbl = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    ids = np.random.default_rng(1).integers(0, 64, (8, 3))
    rows, per = 64 // mesh.mo, 8 // mesh.d
    shard = torch.tensor(tbl[mesh.col * rows:(mesh.col + 1) * rows],
                         requires_grad=True)
    out = sharded_lookup(shard, torch.as_tensor(
        ids[mesh.row * per:(mesh.row + 1) * per]), mesh)
    (g,) = torch.autograd.grad((out ** 2).sum(), [shard])
    arrays["out"] = out.detach().numpy()
    arrays["grad"] = mesh.all_reduce_src(g).numpy()
    x = torch.ones(5, requires_grad=True)
    (gx,) = torch.autograd.grad(ModelSum.apply(x, mesh).sum(), [x])
    arrays["model_sum"] = ModelSum.apply(x, mesh).detach().numpy()
    arrays["model_sum_grad"] = gx.numpy()
    # the reduced MIND loss at float64 on sharded parameters
    cfg = dataclasses.replace(get_arch("mind").config(reduced=True),
                              dtype=torch.float64)
    params = mind.shard_params(mind.init_params(cfg, 0, device="cpu"),
                               mesh)
    hb = train.slice_users(batch(cfg), mesh.row * USERS // mesh.d,
                           (mesh.row + 1) * USERS // mesh.d)
    loss, grads = mind.loss_and_grads(
        params, train.recsys_device_batch(hb, cfg, "cpu"), cfg, mesh)
    res["loss"] = float(loss)
    for k, v in grads.items():
        arrays["mind/" + k] = v.numpy()
    mesh.close()
    np.savez(tmp + "/rank%d.npz" % rank, **arrays)
    with open(tmp + "/rank%d.json" % rank, "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8, sys.argv[1]), nprocs=8, join=True)
"""


def _header():
    return f"SHAPE = {SHAPE!r}\nUSERS = {USERS!r}\n"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the JAX subprocess beside the 8 gloo ranks (each rank single
    threaded); → (JAX arrays, per-rank (results, arrays))."""
    tmp = str(tmp_path_factory.mktemp("recsys8"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1")
    jpath, rpath = (os.path.join(tmp, f) for f in ("jax_lookup.py",
                                                   "torch_ranks.py"))
    with open(jpath, "w") as fh:
        fh.write(textwrap.dedent(_JAX_SCRIPT))
    with open(rpath, "w") as fh:
        fh.write(textwrap.dedent(_RANK_SCRIPT).replace(
            "\n\ndef batch", "\n" + _header() + "\n\ndef batch", 1))
    jproc = subprocess.Popen([sys.executable, jpath,
                              os.path.join(tmp, "jax.npz")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        rproc = subprocess.run([sys.executable, rpath, tmp], env=env,
                               capture_output=True, text=True, timeout=600)
        _, jerr = jproc.communicate(timeout=600)
    finally:
        jproc.kill()
    assert jproc.returncode == 0, jerr[-4000:]
    assert rproc.returncode == 0, rproc.stderr[-4000:]
    per_rank = []
    for r in range(8):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            res = json.load(fh)
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            per_rank.append((res, {k: z[k] for k in z.files}))
    with np.load(os.path.join(tmp, "jax.npz")) as z:
        jarr = {k: z[k] for k in z.files}
    return jarr, per_rank


def _assemble(per_rank, key):
    """The full array of a row-sharded leaf from the ranks of data row 0,
    after checking that row 1 holds the same shards."""
    by = {(res["row"], res["col"]): arr[key] for res, arr in per_rank}
    for c in range(SHAPE[1]):
        assert np.array_equal(by[(0, c)], by[(1, c)]), key
    return np.concatenate([by[(0, c)] for c in range(SHAPE[1])])


def test_gloo8_sharded_lookup_bitwise_equal_to_gather_and_jax(ranks):
    jarr, per_rank = ranks
    tbl = torch.tensor(np.random.default_rng(0).normal(size=(64, 8))
                       .astype(np.float32), requires_grad=True)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (8, 3)))
    want = tbl[ids]
    (want_g,) = torch.autograd.grad((want ** 2).sum(), [tbl])
    rows = {}
    for res, arr in per_rank:
        r = res["row"]
        if r in rows:
            assert np.array_equal(rows[r], arr["out"])      # the model group
        rows[r] = arr["out"]
    out = np.concatenate([rows[0], rows[1]])
    assert np.array_equal(out, want.detach().numpy())
    assert np.array_equal(out, jarr["out"])
    grad = _assemble(per_rank, "grad")
    assert np.array_equal(grad, want_g.numpy())
    assert np.array_equal(grad, jarr["grad"])


def test_gloo8_model_sum_backward_is_the_identity(ranks):
    """The forward sums over the 4 model ranks; the backward leaves the
    cotangent as it is (``torch.distributed.nn.functional.all_reduce``
    would return 4)."""
    for _, arr in ranks[1]:
        assert np.array_equal(arr["model_sum"], np.full(5, 4.0, np.float32))
        assert np.array_equal(arr["model_sum_grad"], np.ones(5, np.float32))


def test_gloo8_mind_loss_and_grads_equal_world1(ranks):
    import dataclasses
    _, per_rank = ranks
    cfg = dataclasses.replace(get_arch("mind").config(reduced=True),
                              dtype=torch.float64)
    hb = train.recsys_host_batch(cfg, USERS, np.random.default_rng(0),
                                 tags=4)
    hb["profile_ids"][::5] = cfg.n_profile
    loss, grads = mind.loss_and_grads(
        mind.init_params(cfg, 0, device="cpu"),
        train.recsys_device_batch(hb, cfg, "cpu"), cfg)
    for res, arr in per_rank:
        assert abs(res["loss"] - float(loss)) <= 1e-12 * abs(float(loss))
        for k in ("bilinear", "profile_proj", "b_init"):
            want = grads[k].numpy()
            assert np.linalg.norm(arr["mind/" + k] - want) <= \
                1e-12 * max(np.linalg.norm(want), 1e-300), k
    assert not grads["b_init"].any()
    for k in ("item_emb", "profile_emb"):
        got, want = _assemble(per_rank, "mind/" + k), grads[k].numpy()
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want), k
