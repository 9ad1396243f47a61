"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: rank 0 of a
fake process group, every tensor a FakeTensor.

* The mesh's collective counters on a toy step (each collective's calls and
  result bytes, the backward's included).
* One reduced cell of each family on a fake ``(2, 4)`` mesh, traced ``ok``:
  the LM's FLOPs equal its hand-counted matmul FLOPs (the remat's
  recompute included) and ψ's its segment sums' source elements (one
  ``segment_reduce`` of the block's edge slots an iteration); the GNN's
  (its batch split over the src group) and MIND's equal what
  ``FlopCounterMode`` counts, with the segment-sum formulas, when the same
  step runs on real CPU tensors; every family's collectives equal those
  its step issues by construction (counted by hand below).
* The tracer's one counting mode against ``FlopCounterMode`` (given the
  same segment-sum formulas) and ``MemTracker`` on a reduced cell of each
  family, a ``seg_mm`` call counted alike on FakeTensors and real CPU
  tensors, and the CLI's ``--jobs`` worker pool against a serial run.
* ``build_cell`` for every (arch, shape) of the registry on a fake
  ``(16, 16)`` mesh (42 cells, 3 skipped), and the record of a named
  subset of them written by the CLI with the JAX record's keys (the full
  run, 78 records and 6 skips, takes many minutes: ``chip_smoke.py`` path
  ``dryrun`` runs it).
* The multi-rank MIND trainer on 8 gloo ranks of a ``(2, 4)`` mesh: two
  clipped ``adamw`` steps equal world 1's (losses, clip norm, parameters
  assembled from the row shards).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.registry import ArchEntry, ShapeCfg
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import COLLECTIVES, make_mesh
from repro_torch.models.transformer import parallel
from repro_torch.train import optim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@dataclasses.dataclass(frozen=True)
class _Reduced(ArchEntry):
    """A registry entry whose config is the reduced one."""

    def config(self, reduced: bool = False):
        return super().config(reduced=True)


def _reduced(arch: str, shape: ShapeCfg) -> tuple:
    e = get_arch(arch)
    return _Reduced(e.arch_id, e.family, e.module, (shape,)), shape


@pytest.fixture
def fake24():
    """Rank 0 of a fake ``(2, 4)`` mesh (8 ranks)."""
    dryrun.start_fake_world(8)
    mesh = make_mesh((2, 4), device="cpu")
    yield mesh
    mesh.close()
    torch.distributed.destroy_process_group()


def _counts(mesh):
    return {k: v["count"] for k, v in mesh.counts.items() if v["count"]}


def test_collective_counters_on_a_toy_step(fake24):
    mesh = fake24
    mesh.reset_counts()
    x = torch.ones(3, 4)
    assert mesh.all_reduce_model(x).shape == (3, 4)
    assert mesh.all_gather_src_dim(torch.ones(2, 5, dtype=torch.float64),
                                   1).shape == (2, 10)
    assert mesh.reduce_scatter_src_dim(torch.ones(4, 6), 0).shape == (2, 6)
    assert mesh.all_gather_span(torch.ones(3), 2, 0).shape == (6,)
    assert mesh.counts["all-reduce"] == dict(count=1, bytes=48)
    assert mesh.counts["all-gather"] == dict(count=2, bytes=160 + 24)
    assert mesh.counts["reduce-scatter"] == dict(count=1, bytes=48)
    # a TP matmul with an FSDP weight: gather + sum forward; the input's
    # cotangent sum and the weight's reduce-scatter backward
    mesh.reset_counts()
    w = torch.ones(2, 3, requires_grad=True)       # rows split over 2
    h = torch.ones(5, 4, requires_grad=True)
    y = parallel.from_tp(parallel.to_tp(h, mesh)
                         @ parallel.fsdp_gather(w, mesh, 0), mesh)
    assert _counts(mesh) == {"all-gather": 1, "all-reduce": 1}
    y.sum().backward()
    assert _counts(mesh) == {"all-gather": 1, "all-reduce": 2,
                             "reduce-scatter": 1}
    assert w.grad.shape == (2, 3) and h.grad.shape == (5, 4)


def _lm_flops(cfg, rows, seq, mo):
    """Hand-counted matmul FLOPs of one train step of a dense LM on one
    rank: each layer's forward, its recompute (the remat; the non-reentrant
    checkpoint stops once the tensors the backward saves are back, so the
    FFN's output matmul is not rerun) and its backward twice over; the
    head's forward once and backward twice."""
    t, d, hd = rows * seq, cfg.d_model, cfg.head_dim
    q_loc = cfg.q_dim // mo
    kv_loc = max(1, cfg.n_kv_heads // mo) * hd
    f_loc = cfg.d_ff // mo
    heads = cfg.n_heads // mo
    layer = (2 * t * d * q_loc + 2 * 2 * t * d * kv_loc       # q, k, v
             + 2 * 2 * rows * heads * seq * seq * hd           # qk, pv
             + 2 * t * q_loc * d                               # wo
             + 3 * 2 * t * d * f_loc)                          # w1 w3 w2
    head = 2 * t * d * (cfg.vocab // mo)
    w2 = 2 * t * f_loc * d
    return cfg.n_layers * (4 * layer - w2) + 3 * head


def test_reduced_lm_cell_flops_and_collectives(fake24):
    entry, shape = _reduced("tinyllama-1.1b", ShapeCfg(
        "train_small", "train", dict(seq_len=16, global_batch=8)))
    cell = specs.build_lm_cell(entry, shape, fake24)
    rec = dryrun.trace_cell(cell, fake24, "cpu")
    cfg = cell.cfg
    assert cfg.n_kv_heads < fake24.mo and cfg.fsdp and cfg.accum_steps == 1
    assert rec["cost"]["flops"] == _lm_flops(cfg, 4, 16, 4)
    # per layer: 7 FSDP and 2 KV-span gathers and 2 TP sums forward, again
    # in the remat but for the FFN's sum (the recompute stops before it),
    # 2 TP sums of cotangents and 9 reduce-scatters backward; the embedding
    # and the head a gather, a sum and a scatter each;
    # the loss 5 sums (max, exp-sum, gold, label count, the share), the
    # replicated leaves (norm1, norm2, final_norm) 3, the clip's norm 1
    L = cfg.n_layers
    got = {k: v["count"] for k, v in rec["collectives"].items()}
    assert got == {"all-reduce": L * 5 + 2 + 5 + 3 + 1,
                   "all-gather": L * 18 + 2, "reduce-scatter": L * 9 + 2,
                   "all-to-all": 0, "collective-permute": 0}
    assert all(v["in_while"] == 0 for v in rec["collectives"].values())
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"])


def _real_flops(cell, mesh):
    """FLOPs (with the segment-sum formulas) and collective counts of the
    step run on real CPU tensors."""
    args = cell.make_args(torch.device("cpu"))
    mesh.reset_counts()
    with FlopCounterMode(display=False,
                         custom_mapping=dryrun.SEGMENT_SUM_FLOPS) as fc:
        cell.step(*args)
    return fc.get_total_flops(), _counts(mesh)


def test_reduced_gnn_cell_matches_a_real_run(fake24):
    entry, shape = _reduced("graphsage-reddit",
                            get_arch("graphsage-reddit").shape(
                                "full_graph_sm"))
    cell = specs.build_gnn_cell(entry, shape, fake24)
    rec = dryrun.trace_cell(cell, fake24, "cpu")
    flops, coll = _real_flops(cell, fake24)
    assert rec["cost"]["flops"] == flops > 0
    # nodes and edges split over the 2 data ranks
    assert rec["args"][-1] == [[4096 // 2], "int64"]     # in-degree rows
    assert "[r*n/d, (r+1)*n/d)" in cell.layout["nodes"]
    assert "[r*e/d, (r+1)*e/d)" in cell.layout["edges"]
    n_leaves = len(optim.tree_leaves(cell.make_args("cpu")[0]))
    # a layer gathers the senders' rows and reduce-scatters the neighbour
    # sums (forward, and again in its recompute); the second layer's
    # backward all-gathers the sums' cotangent and reduce-scatters the
    # gathered rows' (the first layer's input is the features: no
    # gradient); the loss sums its numerator and count, and each gradient
    # leaf is summed over the src group
    want = {"all-reduce": n_leaves + 2, "all-gather": 2 + 2 + 1,
            "reduce-scatter": 2 + 2 + 1}
    assert coll == want
    assert {k: v["count"] for k, v in rec["collectives"].items()
            if v["count"]} == want


def test_reduced_recsys_cell_matches_a_real_run(fake24):
    entry, shape = _reduced("mind", ShapeCfg("train_small", "train",
                                             dict(batch=8)))
    cell = specs.build_recsys_cell(entry, shape, fake24)
    rec = dryrun.trace_cell(cell, fake24, "cpu")
    flops, coll = _real_flops(cell, fake24)
    assert rec["cost"]["flops"] == flops > 0
    # the four lookups' model-group sums (history, profile bags, positive,
    # negatives), the loss and the five gradients over the src group, the
    # clip's norm of the table shards over the model group
    assert coll == {"all-reduce": 4 + 1 + 5 + 1}
    assert rec["collectives"]["all-reduce"]["count"] == 11


def test_reduced_psi_cell_collectives(fake24):
    entry, shape = _reduced("psi-score", ShapeCfg(
        "dblp", "psi_iterate", dict(dataset="dblp")))
    for iters in (1, 2):
        cell = specs.build_psi_cell(entry, shape, fake24, probe_iters=iters)
        rec = dryrun.trace_cell(cell, fake24, "cpu")
        # one segment_reduce of the block's e_max edge slots an iteration
        # (the src_local argument), nothing else counted
        (e_max,), dtype = rec["args"][1]
        assert dtype == "int64"
        assert rec["cost"]["flops"] == iters * e_max > 0
        got = {k: v["count"] for k, v in rec["collectives"].items() if v}
        assert got["reduce-scatter"] == got["all-gather"] == iters
        assert got["all-reduce"] == iters      # the gap


_FAMILY_CELLS = {
    "lm": ("tinyllama-1.1b", ShapeCfg("train_small", "train",
                                      dict(seq_len=16, global_batch=8))),
    "gnn": ("graphsage-reddit", get_arch("graphsage-reddit").shape(
        "full_graph_sm")),
    "recsys": ("mind", ShapeCfg("train_small", "train", dict(batch=8))),
    "psi": ("psi-score", ShapeCfg("dblp", "psi_iterate",
                                  dict(dataset="dblp"))),
}


@pytest.mark.parametrize("family", list(_FAMILY_CELLS))
def test_counter_equals_the_library_trackers(fake24, family):
    """The tracer's one counting mode against ``FlopCounterMode`` and
    ``MemTracker`` run together on the same fake step: the same FLOPs and
    the same peak of live bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    arch, shape = _FAMILY_CELLS[family]
    cell = specs.build_cell(*_reduced(arch, shape), fake24)
    rec = dryrun.trace_cell(cell, fake24, "cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = cell.make_args(torch.device("cpu"))
        mt = MemTracker()
        mt.track_external(*dryrun._leaves(args))
        with mt, FlopCounterMode(
                display=False, custom_mapping=dryrun.SEGMENT_SUM_FLOPS) as fc:
            cell.step(*args)
        peak = sum(v["Total"] for v in
                   mt.get_tracker_snapshot("peak").values())
    assert rec["cost"]["flops"] == fc.get_total_flops()
    assert rec["memory"]["peak_bytes"] == peak > 0
    assert rec["cost"]["flops_scope"] == dryrun.FLOPS_SCOPE


def test_seg_mm_counts_alike_on_fake_and_real_tensors():
    """A ``seg_mm`` call (its operator: one dispatch with its inputs and its
    output) counts the same FLOPs (one per message element) and bytes on
    FakeTensors, where it launches nothing, and on real CPU tensors, where
    its plain version runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    from repro_torch.models.gnn.common import edge_agg
    rng = np.random.default_rng(3)
    n, e, d = 700, 3000, 24
    dst = np.sort(rng.integers(0, n, e))
    agg = edge_agg(rng.integers(0, n, e), dst, n, device="cpu")
    msgs = torch.randn(agg.num_slots, d, dtype=torch.float64)

    def count(m, a):
        with dryrun._Counter([]) as c:
            out = ops.seg_mm(m.reshape(a.fmt.src_idx.shape[0], -1, d),
                             a.fmt, tile_span=a.tile_span)
        return c.flops, c.bytes, tuple(out.shape)

    real = count(msgs, agg)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = count(mode.from_tensor(msgs), dataclasses.replace(
            agg, fmt=dataclasses.replace(agg.fmt, **{
                f.name: mode.from_tensor(getattr(agg.fmt, f.name))
                for f in dataclasses.fields(agg.fmt)
                if isinstance(getattr(agg.fmt, f.name), torch.Tensor)}),
            tile_span=mode.from_tensor(agg.tile_span)))
    assert real == fake
    assert real[0] == agg.num_slots * d
    assert real[2] == (n, d)


def test_counter_bytes_of_a_matmul(fake24):
    """A step of one product ``einsum("ij,jk->ik", x, w)``: its FLOPs, and
    its bytes the two inputs read and the output written once (the device
    queries einsum makes, which a FakeTensor answers through the
    dispatcher, move nothing: counted, they made it 4.7 times as many)."""
    m, k, n = 64, 32, 16

    def make_args(dev):
        return (torch.ones(m, k, device=dev), torch.ones(k, n, device=dev))

    cell = specs.Cell("toy", "matmul", None, {}, {},
                      lambda x, w: torch.einsum("ij,jk->ik", x, w),
                      make_args)
    rec = dryrun.trace_cell(cell, fake24, "cpu")
    assert rec["cost"]["flops"] == 2 * m * k * n
    assert rec["cost"]["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    assert rec["memory"]["peak_bytes"] == 4 * (m * k + k * n + m * n)


def test_cli_jobs_writes_the_serial_records(tmp_path):
    """``--jobs 2`` (traces in worker processes, LM probes and ψ's whole
    cell and probes as separate tasks, both meshes) writes the records a
    serial run writes, but for the seconds."""
    cells = ["--arch", "psi-score,mind,tinyllama-1.1b", "--shape",
             "twitter_scale,serve_p99,decode_32k", "--mesh", "both",
             "--device", "cpu"]
    dryrun.main(cells + ["--out", str(tmp_path / "serial")])
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *cells, "--jobs", "2", "--out",
                          str(tmp_path / "pool")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "trace_s"}
        return [strip(v) for v in x] if isinstance(x, list) else x

    names = sorted(p.name for p in (tmp_path / "serial").iterdir())
    assert len(names) == 6
    assert names == sorted(p.name for p in (tmp_path / "pool").iterdir())
    for name in names:
        a, b = (json.loads((tmp_path / d / name).read_text())
                for d in ("serial", "pool"))
        assert a["ok"] and strip(a) == strip(b), name


def test_build_cell_for_every_registry_cell_and_a_cli_subset(tmp_path):
    dryrun.start_fake_world(256)
    try:
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(device="cpu")
        n = skipped = 0
        for entry, shape in dryrun.iter_cells(sorted(ARCHS)):
            n += 1
            if shape.skip:
                skipped += 1
                continue
            cell = specs.build_cell(entry, shape, mesh)
            assert cell.step is not None and cell.meta["kind"]
            if entry.family in ("lm", "psi"):
                assert [p.meta.get("layers", p.meta.get("iters"))
                        for p in cell.probes] == [1, 2]
        assert (n, skipped) == (42, 3)
        mesh.close()
    finally:
        torch.distributed.destroy_process_group()
    for arch, shape in (("psi-score", "twitter_scale"),
                        ("mind", "serve_p99"),
                        ("tinyllama-1.1b", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                     "--device", "cpu", "--out", str(tmp_path)])
    keys = {"arch", "shape", "mesh", "meta", "ok", "trace_s", "cost",
            "memory", "collectives"}
    for mesh_name in dryrun.MESHES:
        for arch, shape in (("psi-score", "twitter_scale"),
                            ("mind", "serve_p99")):
            with open(tmp_path / f"{arch}__{shape}__{mesh_name}.json") as f:
                rec = json.load(f)
            assert rec["ok"] and keys <= set(rec), rec.get("error")
            assert set(rec["collectives"]) == set(COLLECTIVES)
            assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                          "temp_bytes", "peak_bytes"}
        with open(tmp_path / f"psi-score__twitter_scale__{mesh_name}"
                  ".json") as f:
            assert [p["layers"] for p in json.load(f)["probes"]] == [1, 2]
        with open(tmp_path / f"tinyllama-1.1b__long_500k__{mesh_name}"
                  ".json") as f:
            skip = json.load(f)
        assert skip["ok"] and skip["skipped"]


CLIP = 1e-3          # below the reduced step's gradient norm (~0.019)

_RANK_SCRIPT = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
import torch.multiprocessing as mp
CLIP = %r


def rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + tmp + "/pg",
                            rank=rank, world_size=world)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import COLLECTIVES, make_mesh
    from repro_torch.models import recsys
    from repro_torch.train import optim
    mesh = make_mesh((2, 4), device="cpu")
    run = train.train_recsys("mind", 2, "cpu", mesh=mesh, log=lambda s: 0)
    # two steps clipped to CLIP on the same fixed batch
    cfg = run["cfg"]
    params = recsys.shard_params(recsys.init_params(cfg, 0, device="cpu"),
                                 mesh)
    layout = train.recsys_layout(cfg, mesh)
    _, grads = recsys.loss_and_grads(params, run["batch"], cfg, mesh)
    norm = optim.global_norm(grads, layout)
    opt = optim.adamw(optim.cosine_schedule(1e-2, 2, 2), clip_norm=CLIP)
    state = opt.init(params, layout)
    losses = []
    for _ in range(2):
        params, state, loss = train.recsys_step(params, state, run["batch"],
                                                cfg, opt, mesh)
        losses.append(float(loss))
    arrays = {k: v.detach().numpy() for k, v in params.items()}
    np.savez(tmp + "/rank%%d.npz" %% rank, **arrays)
    with open(tmp + "/rank%%d.json" %% rank, "w") as fh:
        json.dump(dict(row=mesh.row, col=mesh.col, losses=losses,
                       cli_losses=run["losses"], norm=float(norm)), fh)
    mesh.close()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8, sys.argv[1]), nprocs=8, join=True)
""" % CLIP


def test_train_cli_mesh_flag_runs_the_sharded_trainer_at_world1():
    """``train --arch mind --mesh 1,1`` (no torchrun: a world-1 group)
    gives world 1's losses."""
    from repro_torch.launch import train
    want = train.train_recsys("mind", 2, "cpu", log=lambda s: 0)["losses"]
    before = torch.distributed.is_initialized()
    run = train.main(["--arch", "mind", "--steps", "2", "--device", "cpu",
                      "--mesh", "1,1"])
    assert run["losses"] == want
    # the CLI closed its mesh: a group it started is gone again
    assert torch.distributed.is_initialized() == before


def test_gloo8_recsys_trainer_clipped_step_equals_world1(tmp_path):
    from repro_torch.launch import train
    from repro_torch.models import recsys
    path = tmp_path / "ranks.py"
    path.write_text(textwrap.dedent(_RANK_SCRIPT))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(path), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = train.train_recsys("mind", 2, "cpu", log=lambda s: 0)
    cfg = ref["cfg"]
    params = recsys.init_params(cfg, 0, device="cpu")
    _, grads = recsys.loss_and_grads(params, ref["batch"], cfg)
    norm = float(optim.global_norm(grads))
    assert norm > 10 * CLIP                      # the clip binds
    opt = optim.adamw(optim.cosine_schedule(1e-2, 2, 2), clip_norm=CLIP)
    state = opt.init(params)
    losses = []
    for _ in range(2):
        params, state, loss = train.recsys_step(params, state, ref["batch"],
                                                cfg, opt)
        losses.append(float(loss))
    per = []
    for r in range(8):
        with open(tmp_path / f"rank{r}.json") as fh:
            res = json.load(fh)
        with np.load(tmp_path / f"rank{r}.npz") as z:
            per.append((res, {k: z[k] for k in z.files}))
        np.testing.assert_allclose(res["cli_losses"], ref["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
        assert abs(res["norm"] - norm) <= 1e-5 * norm
    for k, want in params.items():
        if k in ("item_emb", "profile_emb"):
            got = np.concatenate([a[k] for res, a in per if res["row"] == 0])
        else:
            got = per[0][1][k]
        np.testing.assert_allclose(got, want.detach().numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
