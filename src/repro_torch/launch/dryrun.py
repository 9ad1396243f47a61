"""Dry run of the production meshes: one traced step of every (arch × shape)
cell as rank 0 of a 16 × 16 or 2 × 16 × 16 mesh, with no allocation and no
card, and what it holds, computes and communicates.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh both --out artifacts/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
        --jobs 8

The port of the JAX package's ``launch/dryrun.py``. Rank 0 joins a process
group of 256 or 512 ranks on ``torch.distributed``'s ``fake`` backend
(collectives return at once and move nothing) and builds the production
mesh (:func:`~repro_torch.launch.mesh.make_production_mesh`); every tensor
is a FakeTensor (``FakeTensorMode``: shapes and dtypes, no storage) on the
``--device``'s type, and the cell's step (:mod:`repro_torch.launch.specs`)
runs once under one counting dispatch mode:

* :data:`FLOP_FORMULAS` → ``cost.flops``: ``torch.utils.flop_counter``'s
  formulas (what ``FlopCounterMode`` counts: matmuls, convolutions,
  attention) and the segment sums, one FLOP per floating-point source
  element of ``segment_reduce``, ``index_add``, ``scatter_add`` and
  ``scatter_reduce`` and per message element ``seg_mm`` reads (the
  record's ``cost.flops_scope`` says so);
* every op's input and output bytes (views excluded) →
  ``cost.bytes_accessed``;
* every storage's bytes from the op that makes it until it is freed, as
  ``torch.distributed._tools.mem_tracker.MemTracker`` counts them →
  ``memory.{argument, output, temp, peak}_bytes`` (the arguments tracked
  from the start, ``temp`` the peak's rest);

and the mesh's collective counters → ``collectives.<type>.{top, in_while,
count}``, ``top`` the result bytes (eager PyTorch has no while bodies:
``in_while`` is 0; the L / L+1 probes give per-layer deltas).

An LM cell is traced as its two probes, 1 and 2 layers (a train cell's:
one microbatch, as the JAX probes), and its record extrapolates them to
the config's depth, ``v(L) = v(1) + (L − 1)(v(2) − v(1))``, and a train
cell's to its ``accum`` microbatches: cost and collectives × ``accum``
(the optimizer's once-a-step share counted ``accum`` times), memory plus
the float32 gradient accumulator the step keeps (the record's ``depth``
says so). The layers and microbatches are identical, and tracing all of
them one op at a time would take many minutes (a fake op costs about
0.1 ms on a CPU core; Nemotron's ``train_4k`` is 96 layers × 16
microbatches). The other cells are traced whole (ψ's probes, 1 and 2
iterations, beside).

``--jobs N`` (with ``--device cpu``) makes the traces in N worker
processes, the longest first (each LM probe and each of ψ's traces a task
of its own), and assembles the same records here.

``--device cuda`` (the default) then makes rank 0's arguments real on the
card, still on the fake backend, and runs one step: ``memory.
measured_peak_bytes`` (``torch.cuda.max_memory_allocated`` above what was
allocated before) beside the estimate, and ``device_ms`` (CUDA events) —
rank 0's compute only, no communication (the record's ``measured`` says
so). A shard that does not fit the card is recorded ``ok: false`` with the
error. ``--device cpu`` traces only.

Each (arch × shape × mesh) writes ``<arch>__<shape>__<mesh>.json`` under
``--out`` with the JAX record's keys (``trace_s`` where JAX has
``lower_s``/``compile_s``); a skipped cell writes a skip record; the run
exits 1 on any failure.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..configs.registry import ARCHS, get_arch
from .mesh import make_production_mesh
from .specs import Cell, build_cell

__all__ = ["MESHES", "FLOPS_SCOPE", "SEGMENT_SUM_FLOPS", "FLOP_FORMULAS",
           "start_fake_world",
           "trace_cell",
           "trace_keys", "trace_task", "trace_in_pool", "run_real",
           "run_cell", "iter_cells", "main"]

# record name -> multi_pod
MESHES = {"pod16x16": False, "pod2x16x16": True}
# what a record's cost.flops counts (its cost.flops_scope)
FLOPS_SCOPE = ("torch.utils.flop_counter's formulas (matmuls, convolutions, "
               "attention) and the segment sums: one per floating-point "
               "source element of segment_reduce, index_add, scatter_add and "
               "scatter_reduce (a scatter whose index is 1 long along its "
               "dimension, as a gather's backward, sums nothing: 0), one per "
               "message element of seg_mm; elementwise ops, other "
               "reductions and gathers count 0")


def _per_source_element(pos: int, name: str, scatter: bool = False):
    """A FLOP formula for a segment sum: one per element of its source
    (argument ``pos``, or keyword ``name``) when that is floating point
    (an integer count is no FLOP); for a ``scatter`` 0 when its index is 1
    long along the scattered dimension (each target receives one source at
    most: a gather's backward). It reads the tensors themselves
    (``_get_raw``: ``FlopCounterMode`` passes them as they are)."""
    def formula(*args, out_val=None, **kwargs):
        src = kwargs[name] if name in kwargs else args[pos]
        if not src.is_floating_point():
            return 0
        if scatter:
            dim = args[1] if len(args) > 1 else kwargs["dim"]
            index = args[2] if len(args) > 2 else kwargs["index"]
            if index.dim() and index.shape[dim] <= 1:
                return 0
        return src.numel()
    formula._get_raw = True
    return formula


_aten = torch.ops.aten
# the segment sums' formulas, keyed by operator (FlopCounterMode takes them
# as its custom_mapping), and the counting mode's whole map
SEGMENT_SUM_FLOPS = {
    **{op: _per_source_element(3, "source")
       for op in (_aten.index_add, _aten.index_add_)},
    **{op: _per_source_element(3, "src", scatter=True)
       for op in (_aten.scatter_add, _aten.scatter_add_,
                  _aten.scatter_reduce, _aten.scatter_reduce_)},
    _aten.segment_reduce: _per_source_element(0, "data"),
    torch.ops.repro_torch.seg_mm: _per_source_element(0, "messages"),
}
FLOP_FORMULAS = {**flop_registry, **SEGMENT_SUM_FLOPS}


def start_fake_world(world: int) -> None:
    """Join a process group of ``world`` ranks as rank 0 on the ``fake``
    backend (replacing any group this process had)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# queries of a tensor's metadata, which move no data (a FakeTensor answers
# every device query of the C++ ops through the dispatcher: half the ops
# of an attention block; a name this torch lacks is left out)
_METADATA = frozenset(
    getattr(ns, name).default for ns, names in (
        (torch.ops.prim, ("device", "layout")),
        (torch.ops.aten, ("size", "sym_size", "stride", "sym_stride",
                          "numel", "sym_numel", "dim", "storage_offset",
                          "sym_storage_offset", "is_contiguous",
                          "sym_is_contiguous",
                          "is_non_overlapping_and_dense")))
    for name in names if hasattr(ns, name))


class _Counter(TorchDispatchMode):
    """One pass over every op of a traced step, counting three things:

    * FLOPs by :data:`FLOP_FORMULAS` (matmuls, convolutions, attention:
      what ``FlopCounterMode`` counts; the segment sums);
    * the bytes of every op's tensor inputs and outputs (view ops, which
      move nothing, excluded);
    * the bytes live on the device: each distinct storage from the op that
      makes it (or from the start, for ``tracked``) until it is freed, a
      CUDA one rounded up to the caching allocator's 512 bytes, as
      ``torch.distributed._tools.mem_tracker`` counts them, and their peak.

    One mode for the three: each mode costs a Python dispatch of every op,
    and the attention loops of a 32k prefill issue hundreds of thousands.
    Metadata queries (``_METADATA``) count nothing."""

    def __init__(self, tracked):
        super().__init__()
        self.flops = self.bytes = self.live = 0
        self._seen = WeakIdKeyDictionary()
        for t in tracked:
            self._track(t)
        self.peak = self.live

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // 512) * 512
        self._seen[st] = fin = weakref.finalize(st, self._free, n)
        fin.atexit = False
        self.live += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _METADATA:
            return out
        formula = FLOP_FORMULAS.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            for x in _leaves((args, kwargs, out)):
                self.bytes += x.numel() * x.element_size()
        for x in _leaves(out):
            self._track(x)
        self.peak = max(self.peak, self.live)
        return out


def _leaves(tree) -> list[torch.Tensor]:
    """The distinct tensors of a tree of dicts (sorted keys), lists, tuples
    and dataclasses (a GraphBatch, a cache), in order. Iterative: a
    recursive closure would sit in a reference cycle with the tensors it
    saw, and keep them alive (and counted) until the next garbage
    collection."""
    out, seen, stack = [], set(), [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack += [getattr(x, f.name)
                      for f in reversed(dataclasses.fields(x))]
        elif isinstance(x, dict):
            stack += [x[k] for k in sorted(x, key=str, reverse=True)]
        elif isinstance(x, (list, tuple)):
            stack += reversed(x)
    return out


def _storage_bytes(tensors, exclude=()) -> int:
    """Bytes of the distinct storages of ``tensors`` not in ``exclude``."""
    seen = {_key(t) for t in exclude}
    total = 0
    for t in tensors:
        k = _key(t)
        if k not in seen:
            seen.add(k)
            total += t.untyped_storage().nbytes()
    return total


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _args_record(args) -> list:
    """Each argument leaf's (shape, dtype) in tree order."""
    return [[list(t.shape), str(t.dtype).removeprefix("torch.")]
            for t in _leaves(args)]


def trace_cell(cell: Cell, mesh, device: str) -> dict:
    """One traced step of ``cell`` on FakeTensors of ``device``'s type:
    → {trace_s, cost, memory, collectives, args}."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = cell.make_args(torch.device(device))
        inputs = _leaves(args)
        mesh.reset_counts()
        count = _Counter(inputs)
        with count:
            out = cell.step(*args)
        outputs = _leaves(out)
        arg_b = _storage_bytes(inputs)
        out_b = _storage_bytes(outputs, exclude=inputs)
    return dict(
        trace_s=round(time.perf_counter() - t0, 3),
        cost=dict(flops=float(count.flops),
                  bytes_accessed=float(count.bytes),
                  flops_scope=FLOPS_SCOPE),
        memory=dict(argument_bytes=arg_b, output_bytes=out_b,
                    temp_bytes=max(0, count.peak - arg_b - out_b),
                    peak_bytes=count.peak),
        collectives={c: dict(top=v["bytes"], in_while=0, count=v["count"])
                     for c, v in mesh.counts.items()},
        args=_args_record(args))


def _extrapolate(p1: dict, p2: dict, depth: int) -> dict:
    """``v(1) + (depth − 1)(v(2) − v(1))`` over every number of a trace."""
    if isinstance(p1, dict):
        return {k: _extrapolate(p1[k], p2[k], depth) for k in p1}
    if isinstance(p1, (int, float)) and not isinstance(p1, bool):
        v = p1 + (depth - 1) * (p2 - p1)
        return type(p1)(v) if isinstance(p1, int) else float(v)
    return p1


def _scale_microbatches(rec: dict, accum: int, cell: Cell, mesh) -> None:
    """A one-microbatch record as the step of ``accum``: cost and
    collectives × accum, memory plus the float32 accumulator."""
    from ..models.transformer import shard_numel
    rec["cost"].update(flops=rec["cost"]["flops"] * accum,
                       bytes_accessed=rec["cost"]["bytes_accessed"] * accum)
    for c in rec["collectives"].values():
        c["top"] *= accum
        c["count"] *= accum
    acc = 4 * shard_numel(cell.cfg, mesh)
    rec["memory"]["temp_bytes"] += acc
    rec["memory"]["peak_bytes"] += acc
    rec["depth"] += (f"; one microbatch traced, cost and collectives x "
                     f"{accum} (the optimizer's share counted {accum} "
                     f"times), memory + the float32 accumulator "
                     f"({acc} bytes)")


def run_real(cell: Cell, device: str = "cuda") -> dict:
    """Rank 0's arguments made on the card and one step run: → {"peak"
    (bytes above what was allocated before), "device_ms"}."""
    dev = torch.device(device)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    args = cell.make_args(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = cell.step(*args)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    del args, out
    torch.cuda.empty_cache()
    return dict(peak=int(peak), device_ms=start.elapsed_time(end))


def _is_lm(cell: Cell) -> bool:
    return bool(cell.probes) and "layers" in cell.meta


def trace_keys(cell: Cell) -> list:
    """The traces a record of ``cell`` is made of: each probe's index and,
    but for an LM cell (its record is the probes' extrapolation), None for
    the cell itself."""
    return list(range(len(cell.probes or []))) + ([] if _is_lm(cell)
                                                  else [None])


def run_cell(cell: Cell, mesh, mesh_name: str, *, device: str = "cuda",
             with_probes: bool = True, real: bool | None = None,
             traces: dict | None = None) -> dict:
    """The record of ``cell`` on ``mesh`` (traced; on a card also run for
    real unless ``real`` is False). ``traces``: the :func:`trace_keys`
    traces made elsewhere (:func:`trace_task`), else they are made here."""
    rec = dict(arch=cell.arch, shape=cell.shape, mesh=mesh_name,
               meta=dict(cell.meta), layout=dict(cell.layout), ok=False)
    real = device.startswith("cuda") if real is None else real
    try:
        if traces is None:
            traces = {k: trace_cell(cell if k is None else cell.probes[k],
                                    mesh, device) for k in trace_keys(cell)}
        for t in traces.values():
            if "error" in t:
                rec.update(error=t["error"], traceback=t["traceback"])
                return rec
        probes = [(pc, traces[i]) for i, pc in enumerate(cell.probes or [])]
        if _is_lm(cell):
            (_, t1), (_, t2) = probes
            depth = cell.meta["layers"]
            rec.update(_extrapolate(t1, t2, depth))
            rec["trace_s"] = round(t1["trace_s"] + t2["trace_s"], 3)
            rec["args"] = trace_cell_args(cell, device)
            rec["depth"] = (f"extrapolated to {depth} layers from the 1- "
                            "and 2-layer traces: v(1) + (L - 1)(v(2) - v(1))")
            accum = cell.meta.get("accum", 1)
            if accum > 1:
                _scale_microbatches(rec, accum, cell, mesh)
        else:
            rec.update(traces[None])
        if with_probes and probes:
            rec["probes"] = [dict(layers=pc.meta.get("layers",
                                                     pc.meta.get("iters")),
                                  ok=True, cost=t["cost"],
                                  collectives=t["collectives"],
                                  memory=t["memory"])
                             for pc, t in probes]
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        return rec
    if real:
        rec["measured"] = ("rank 0's step on the card with the collectives "
                           "on the fake backend: compute only, no "
                           "communication")
        try:
            got = run_real(cell, device)
            rec["memory"]["measured_peak_bytes"] = got["peak"]
            rec["device_ms"] = got["device_ms"]
        except Exception as e:
            rec["ok"] = False
            rec["error"] = f"real run: {type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-3000:]
            torch.cuda.empty_cache()
    return rec


# a worker's production mesh: {"name", "mesh"}
_WORKER: dict = {}


def _worker_init() -> None:
    torch.set_num_threads(1)


def trace_task(task: tuple) -> tuple:
    """One trace in a worker process: ``task`` is (mesh name, arch, shape,
    key of :func:`trace_keys`, device); → (task, the trace or {"error",
    "traceback"})."""
    mesh_name, arch, shape, key, device = task
    try:
        if _WORKER.get("name") != mesh_name:
            if "mesh" in _WORKER:
                _WORKER.pop("mesh").close()
            start_fake_world(512 if MESHES[mesh_name] else 256)
            _WORKER.update(name=mesh_name, mesh=make_production_mesh(
                MESHES[mesh_name], device=torch.device(device)))
        mesh = _WORKER["mesh"]
        entry = get_arch(arch)
        cell = build_cell(entry, entry.shape(shape), mesh)
        return task, trace_cell(cell if key is None else cell.probes[key],
                                mesh, device)
    except Exception as e:
        return task, dict(error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-3000:])


def _task_weight(cell: Cell, key) -> int:
    """A rough cost of a trace, to start the longest first: an LM probe's
    attention blocks (its layers × q blocks × k blocks), about a 32k
    prefill layer's for any other cell."""
    if not _is_lm(cell):
        return 2048
    pc = cell.probes[key]
    seq = cell.batch.get("tokens", ((0, 0),))[0][-1]
    return pc.meta["layers"] * (1 + (seq // pc.cfg.q_block)
                                * (seq // pc.cfg.k_block))


def trace_in_pool(cells: list, jobs: int, device: str) -> dict:
    """Every trace of ``cells`` ((mesh name, cell) pairs) in ``jobs``
    worker processes, the longest first; → {(mesh name, arch, shape):
    {key: trace}}."""
    import multiprocessing
    tasks = sorted(((_task_weight(cell, key), (name, cell.arch, cell.shape,
                                                key, device))
                    for name, cell in cells for key in trace_keys(cell)),
                   key=lambda wt: -wt[0])
    out: dict = {}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(jobs, initializer=_worker_init) as pool:
        for task, trace in pool.imap_unordered(trace_task,
                                               [t for _, t in tasks]):
            out.setdefault(task[:3], {})[task[3]] = trace
    return out


def trace_cell_args(cell: Cell, device: str) -> list:
    """The arguments' (shape, dtype) of ``cell`` without tracing a step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return _args_record(cell.make_args(torch.device(device)))


def iter_cells(arch_ids, shapes=None):
    """(entry, shape) of every cell of ``arch_ids`` (of ``shapes`` only,
    when given)."""
    for arch_id in arch_ids:
        entry = get_arch(arch_id)
        for shape in entry.shapes:
            if shapes and shape.name not in shapes:
                continue
            yield entry, shape


@contextlib.contextmanager
def production_mesh(multi_pod: bool, device: str):
    """Rank 0 of the production mesh on a fake process group."""
    start_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod, device=torch.device(device))
    try:
        yield mesh
    finally:
        mesh.close()
        dist.destroy_process_group()


def dry_run(arch_ids, shapes, mesh_names, out_dir: str, *,
            device: str, with_probes: bool = True, real=None, jobs: int = 1,
            log=print) -> dict:
    """Write a record a (cell × mesh) under ``out_dir``; → counts
    {ok, failed, skipped}. ``jobs`` > 1 makes the traces in that many
    worker processes (:func:`trace_in_pool`) before the records are
    assembled here."""
    os.makedirs(out_dir, exist_ok=True)
    counts = dict(ok=0, failed=0, skipped=0)
    cells = list(iter_cells(arch_ids, shapes))
    traced = {}
    if jobs > 1:
        built = []
        for mesh_name in mesh_names:
            with production_mesh(MESHES[mesh_name], device) as mesh:
                for entry, shape in cells:
                    if not shape.skip:
                        try:
                            built.append((mesh_name,
                                          build_cell(entry, shape, mesh)))
                        except Exception:
                            pass               # recorded as a build error
        traced = trace_in_pool(built, jobs, device)
    for mesh_name in mesh_names:
        with production_mesh(MESHES[mesh_name], device) as mesh:
            for entry, shape in cells:
                tag = f"{entry.arch_id}__{shape.name}__{mesh_name}"
                if shape.skip:
                    rec = dict(arch=entry.arch_id, shape=shape.name,
                               mesh=mesh_name, skipped=shape.skip, ok=True)
                    counts["skipped"] += 1
                else:
                    t0 = time.perf_counter()
                    try:
                        cell = build_cell(entry, shape, mesh)
                        rec = run_cell(
                            cell, mesh, mesh_name, device=device,
                            with_probes=with_probes, real=real,
                            traces=traced.get((mesh_name, entry.arch_id,
                                               shape.name)))
                    except Exception as e:
                        rec = dict(arch=entry.arch_id, shape=shape.name,
                                   mesh=mesh_name, ok=False,
                                   error=f"build: {type(e).__name__}: {e}",
                                   traceback=traceback.format_exc()[-3000:])
                    counts["ok" if rec["ok"] else "failed"] += 1
                    log(f"[dryrun] {tag}: "
                        + (f"ok, flops {rec['cost']['flops']:.3e}, peak "
                           f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB"
                           if rec["ok"] else f"FAIL {rec['error']}")
                        + (f" (traced in {rec['trace_s']:.1f} s)" if
                           rec.get("trace_s") is not None else "")
                        + f" ({time.perf_counter() - t0:.1f} s here)")
                with open(os.path.join(out_dir, tag + ".json"), "w") as fh:
                    json.dump(rec, fh, indent=1)
    return counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="an arch id, or several joined by commas")
    ap.add_argument("--shape", default=None,
                    help="a shape name, or several joined by commas")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: traced, then rank 0 run on the "
                         "card) or cpu (traced only)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace in this many worker processes (with "
                         "--device cpu)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; --device cpu traces "
                           "without one")
    if args.jobs > 1 and not args.device.startswith("cpu"):
        ap.error("--jobs traces in worker processes: give --device cpu")
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape) or --all")
    arch_ids = args.arch.split(",") if args.arch else sorted(ARCHS)
    meshes = dict(single=["pod16x16"], multi=["pod2x16x16"],
                  both=list(MESHES))[args.mesh]
    t0 = time.perf_counter()
    shapes = args.shape.split(",") if args.shape else None
    counts = dry_run(arch_ids, shapes, meshes, args.out,
                     device=args.device, with_probes=not args.no_probes,
                     jobs=args.jobs)
    print(f"[dryrun] done: {counts['ok']} ok, {counts['failed']} failed, "
          f"{counts['skipped']} skipped ({time.perf_counter() - t0:.1f} s)")
    if counts["failed"]:
        raise SystemExit(1)
    return counts


if __name__ == "__main__":
    main()
