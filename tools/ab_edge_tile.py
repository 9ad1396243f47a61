"""Time the edge-tile kernels and the cold resolve of two checkouts in turns.

Usage (on a machine with a CUDA card, from any directory)::

    python3 tools/ab_edge_tile.py parent=PATH change=PATH \
        [--order ABBA] [--out FILE]

Each ``NAME=PATH`` is the root of a checkout of this repository (for
example one unpacked from ``git archive``). For each letter of ``--order``
(A the first checkout, B the second; default ``ABBA``) the script starts a
worker process whose ``PYTHONPATH`` is that checkout's ``src`` only, so it
imports that checkout's ``repro_torch`` and builds that checkout's kernels
into that checkout's ``build/``. A worker measures at float32:

* on the twitter stand-in, ``power_step`` at tile 256 (the ``cuda``
  backend's shape) and ``edge_spmv`` at tile 512 (the cost model's pick);
* on the benchmark cell's graph (``gpubench/gen/kronecker.py``'s draw of
  ``gpubench/configs/psi-g500-s22.json``, seed 1), ``power_step`` at float64
  and tile 512, e1 8, e2 128 (the cell's shape), each call as its engine
  makes it (with the step kernel.s plan where the checkout can make one),
  50 back-to-back calls a reading;
* the lane-batched ``power_step_lanes`` and ``edge_spmv_lanes`` at two fleet
  buckets, each of four seeds of one Table II stand-in admitted to a
  ``TenantFleet(backend="auto")`` and solved once: facebook (the bucket of
  n <= 65,536, m <= 1,048,576, tile 512) and dblp (n <= 16,384, m <= 65,536,
  the bucket of the ``stream`` and ``chaos`` fleets, where most lane
  launches are), from the bucket's solved state;
* each warm, 200 back-to-back calls a reading, three readings each, by two
  yardsticks: CUDA events around the calls (``events_ms``: the larger of
  the device time and the host's time to issue a call) and the summed
  kernel durations that ``torch.profiler`` records (``device_ms``);
* the cold resolve of a ``cuda`` engine at tile 256 and tol 1e-8 (host
  clock around ``run`` and a read of the result), five times, and one more
  under the profiler for the card's busy share of its wall time.

The script prints each worker's readings as one JSON line, then for each
checkout and measure the minimum, median and maximum over all its workers,
and the second checkout's minimum over the first's. Last come the chain
bounds: a dependent f32 and f64 add's latency in cycles, measured by a
one-warp chain kernel that the script builds with ``nvcc`` (into the
git-ignored ``build/ab_edge_tile/``), and for each shape its longest
in-degree times that latency at the card's top SM clock: the least time a
fold in slot order allows, whatever the bytes (the cell's shape at f64, the
others at f32). For the cell's shape it also prints a model of the ring
from the format alone: the slots on the ring's serial fold path (the sum,
over every stage of every tile, of the longest run of one row in the
stage) as a share of the real slots, that path in dependent f64 adds over
the card's resident CTAs, and the share of real slots whose tile the
second checkout's plan sends to the row path; and the device time of the
step's gathers alone (a helper kernel that sums s_pre[src] over every real
slot in slot order at full occupancy, built with the chain kernel): the
least time its random reads take on this card. ``--out`` also writes
everything as JSON. The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BUCKETS = ("facebook", "dblp")
MEASURES = ("power_step_t256_events_ms", "power_step_t256_device_ms",
            "edge_spmv_t512_events_ms", "edge_spmv_t512_device_ms",
            "power_step_g500_events_ms", "power_step_g500_device_ms",
            *(f"{k}_{b}_{y}_ms" for b in BUCKETS
              for k in ("power_step_lanes", "edge_spmv_lanes")
              for y in ("events", "device")),
            "cold_resolve_ms", "cold_resolve_busy")


def _events_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(fn):
    """(device µs, wall µs) of one call of ``fn`` under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type != DeviceType.CPU)
    return dev, wall


def _device_ms(fn, iters):
    for _ in range(3):
        fn()

    def calls():
        for _ in range(iters):
            fn()
    return _device_us(calls)[0] / iters / 1e3


def _lane_calls(name: str) -> dict:
    """The lane kernels of the fleet bucket that four seeds of stand-in
    ``name`` fill, as the fleet calls them, from the solved state."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import heterogeneous
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels.edge_spmv import edge_spmv_lanes_call
    from repro_torch.kernels.power_step import power_step_lanes_call
    from repro_torch.serving import TenantFleet
    fleet = TenantFleet(backend="auto", tol=1e-8, device="cuda")
    for k, seed in enumerate((1, 2, 3, 4)):
        g = load_dataset(name, seed=seed)
        fleet.admit(f"{name}-{seed}", g, heterogeneous(g.n, seed=200 + k))
    fleet.solve()
    (bucket,) = [b for b in fleet._buckets.values() if b.regime == "cuda"]
    fmt, inv_w_g, mu, c = bucket.args
    s = bucket.s
    s_pre = F.pad(s, (0, fmt.n_gather - fmt.n_pad)) * inv_w_g
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s)
    kw = _step_kw(fmt, n=fmt.n, tile=fmt.tile)
    push_kw = dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
    deg = max(int(np.bincount(fleet._rec(t).host.dst_by_dst).max())
              for t in bucket.order)
    return {"shape": dict(lanes=fmt.src_idx.shape[0], tile=fmt.tile,
                          blocks=fmt.src_idx.shape[1], n=fmt.n,
                          max_in_degree=deg),
            "power_step_lanes": lambda: power_step_lanes_call(*args, **kw),
            "edge_spmv_lanes": lambda: edge_spmv_lanes_call(*args[:6],
                                                            **push_kw)}


def _planned(fmt):
    """``fmt`` with the step kernel's plan where the checkout's format can
    make one, as its ``cuda`` engine and fleet build it."""
    return fmt.with_row_plan() if hasattr(fmt, "with_row_plan") else fmt


def _step_kw(fmt, **kw) -> dict:
    """``power_step_call``'s keywords as the checkout's engine passes them:
    the launch order and the plan where its format holds them."""
    for name in ("tile_order", "row_start", "tile_row_slots"):
        if getattr(fmt, name, None) is not None:
            kw[name] = getattr(fmt, name)
    return kw


def _ring_model(fmt_h, sblk: int, resident: int) -> dict:
    """The ring's serial fold path on a host format (every tile sorted, as
    a fresh build lays it): in each stage of ``sblk`` blocks the threads
    wait for the stage's longest run of one row."""
    import numpy as np
    tile, eblk = fmt_h.tile, fmt_h.eblk
    src = fmt_h.src_idx.reshape(-1)
    real = src != fmt_h.n
    first, count = fmt_h.tile_first_block, fmt_h.tile_num_blocks
    stages = -(-count // sblk)
    stage0 = np.concatenate([[0], np.cumsum(stages)[:-1]])
    block = np.arange(fmt_h.num_blocks)
    t = fmt_h.block_tile
    stage_of_block = stage0[t] + (block - first[t]) // sblk
    stage = np.repeat(stage_of_block, eblk)[real]
    row = fmt_h.dst_local.reshape(-1)[real].astype(np.int64)
    runs = np.bincount(stage * tile + row, minlength=int(stages.sum()) * tile)
    serial = int(runs.reshape(-1, tile).max(1).sum())
    return {"real_slots": int(real.sum()), "stages": int(stages.sum()),
            "serial_slots": serial,
            "serial_share": serial / max(int(real.sum()), 1),
            "resident_ctas": resident}


def _g500_calls() -> dict:
    """``power_step`` on the benchmark cell's graph at its shape, and the
    format's model numbers."""
    import json as _json

    import numpy as np
    import torch

    from gpubench.gen import kronecker
    from repro_torch.graphs.structure import Graph
    from repro_torch.kernels.edge_spmv import stage_blocks
    from repro_torch.kernels.formats import build_edge_tiles
    from repro_torch.kernels.ops import DeviceEdgeTiles
    from repro_torch.kernels.power_step import power_step_call
    with open(os.path.join("gpubench", "configs", "psi-g500-s22.json")) as f:
        cfg = _json.load(f)
    drawn = kronecker.generate(cfg["inputs"], 1, torch.device("cuda"))
    g = Graph(drawn["n"], drawn["src"].cpu().numpy(),
              drawn["dst"].cpu().numpy(), name="g500")
    del drawn
    fmt_h = build_edge_tiles(g, tile=512, e1=8, e2=128)
    fmt = _planned(DeviceEdgeTiles.from_format(fmt_h, "cuda"))
    rng = np.random.default_rng(0)

    def vec(size):
        return torch.as_tensor(rng.uniform(size=size), dtype=torch.float64,
                               device="cuda")
    s = vec(g.n)
    args = (fmt.pad_gather_source(vec(g.n) * s), fmt.src_idx, fmt.dst_local,
            fmt.block_tile, fmt.tile_first_block, fmt.tile_num_blocks,
            fmt.pad_node_vector(vec(g.n)), fmt.pad_node_vector(vec(g.n)),
            fmt.pad_node_vector(s))
    kw = _step_kw(fmt, n=fmt.n, tile=512)
    sblk, depth = stage_blocks(512, fmt_h.eblk, 8)
    model = _ring_model(fmt_h, sblk, 2 * 132)
    slots = getattr(fmt, "tile_row_slots", None)
    model.update(max_in_degree=int(g.in_degree.max()), sblk=sblk,
                 depth=depth, row_path_share=(
                     None if slots is None
                     else int(slots.sum()) / model["real_slots"]))
    model["gather_ms"] = _gather_ms(args[0], fmt.src_idx, fmt.n)
    return {"model": model,
            "power_step_g500": lambda: power_step_call(*args, **kw)}


def worker() -> dict:
    """The readings of the checkout whose ``src`` is on ``PYTHONPATH``."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import (PsiService, build_operators,
                                  heterogeneous)
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels.edge_spmv import edge_spmv_call
    from repro_torch.kernels.formats import build_edge_tiles
    from repro_torch.kernels.ops import DeviceEdgeTiles
    from repro_torch.kernels.power_step import power_step_call
    g = load_dataset("twitter")
    act = heterogeneous(g.n, seed=6)
    out = {"package": repro_torch.__file__, **{k: [] for k in MEASURES},
           "twitter_max_in_degree": int(g.in_degree.max())}

    def fmt_at(tile):
        fmt = _planned(DeviceEdgeTiles.from_format(
            build_edge_tiles(g, tile=tile), "cuda"))
        return fmt, _step_kw(fmt, n=fmt.n, tile=tile)

    fmt, kw = fmt_at(256)
    ops = build_operators(g, act, dtype=torch.float32, device="cuda")
    s = torch.as_tensor(np.random.default_rng(0).uniform(size=g.n),
                        dtype=torch.float32, device="cuda")
    step_args = (fmt.pad_gather_source(s * ops.inv_w), fmt.src_idx,
                 fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                 fmt.tile_num_blocks, fmt.pad_node_vector(ops.mu),
                 fmt.pad_node_vector(ops.c), fmt.pad_node_vector(s))
    fmt5, _ = fmt_at(512)
    kw5 = dict(n=fmt5.n, tile=512, tile_order=fmt5.tile_order)
    push_args = (fmt5.pad_gather_source(s), fmt5.src_idx, fmt5.dst_local,
                 fmt5.block_tile, fmt5.tile_first_block,
                 fmt5.tile_num_blocks)

    def step():
        return power_step_call(*step_args, **kw)

    def push():
        return edge_spmv_call(*push_args, **kw5)

    for _ in range(3):
        out["power_step_t256_events_ms"].append(_events_ms(step, 200))
        out["power_step_t256_device_ms"].append(_device_ms(step, 200))
        out["edge_spmv_t512_events_ms"].append(_events_ms(push, 200))
        out["edge_spmv_t512_device_ms"].append(_device_ms(push, 200))
    g500 = _g500_calls()
    out["g500_model"] = g500.pop("model")
    for _ in range(3):
        out["power_step_g500_events_ms"].append(
            _events_ms(g500["power_step_g500"], 50))
        out["power_step_g500_device_ms"].append(
            _device_ms(g500["power_step_g500"], 50))
    del g500
    torch.cuda.empty_cache()
    for name in BUCKETS:
        lanes = _lane_calls(name)
        out[f"{name}_bucket"] = lanes.pop("shape")
        for _ in range(3):
            for kernel, fn in lanes.items():
                out[f"{kernel}_{name}_events_ms"].append(_events_ms(fn, 200))
                out[f"{kernel}_{name}_device_ms"].append(_device_ms(fn, 200))
    eng = PsiService(g, act, tol=1e-8, backend="cuda",
                     device="cuda").engine
    iters = []

    def resolve():
        res = eng.run(tol=1e-8)
        float(res.psi.sum())
        iters.append(res.iterations)

    resolve()                                    # warm-up
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resolve()
        out["cold_resolve_ms"].append((time.perf_counter() - t0) * 1e3)
    dev, wall = _device_us(resolve)
    out["cold_resolve_busy"].append(dev / wall)
    out["iterations"] = sorted(set(iters))
    return out


# a dependent add's latency: one warp, `iters` rounds of four adds; and the
# card's rate of random gathers: every thread sums x[idx[i]] over a stride
# of the indices, eight loads in flight a thread
_HELPER_CU = r"""
#include <cuda_runtime.h>
template <typename T>
__global__ void chain(T* x, int iters, long long* cycles) {
  T a = x[threadIdx.x], b = x[threadIdx.x + 32];
  const long long c0 = clock64();
  for (int i = 0; i < iters; ++i) { a += b; a += b; a += b; a += b; }
  const long long c1 = clock64();
  x[threadIdx.x] = a;
  if (threadIdx.x == 0) *cycles = c1 - c0;
}
extern "C" int chain_cycles(int f64, void* x, int iters, void* cycles) {
  if (f64) chain<double><<<1, 32>>>((double*)x, iters, (long long*)cycles);
  else chain<float><<<1, 32>>>((float*)x, iters, (long long*)cycles);
  return (int)cudaDeviceSynchronize();
}
__global__ void gathers(const double* x, const int* idx, long long m,
                        double* out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  double acc = 0.0;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 7 * step < m; i += 8 * step) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = x[__ldcs(idx + i + u * step)];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; i < m; i += step) acc += x[idx[i]];
  if (acc == -1.0) out[0] = acc;
}
extern "C" int gather_launch(const void* x, const void* idx, long long m,
                             void* out, void* stream) {
  gathers<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const int*)idx, m, (double*)out);
  return (int)cudaGetLastError();
}
"""


def _helper_lib():
    """The helper kernels above, built with ``nvcc`` into the git-ignored
    ``build/ab_edge_tile/`` of the tree that holds this script (again
    whenever the source above differs from the one the library was built
    from)."""
    import ctypes
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "ab_edge_tile")
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f) for f in ("helper.cu", "helper.so"))
    built_from = None
    if os.path.exists(src) and os.path.exists(lib):
        with open(src) as f:
            built_from = f.read()
    if built_from != _HELPER_CU:
        with open(src + ".tmp.cu", "w") as f:
            f.write(_HELPER_CU)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                        lib + ".tmp", src + ".tmp.cu"], check=True,
                       timeout=300)
        os.replace(lib + ".tmp", lib)
        os.replace(src + ".tmp.cu", src)
    return ctypes.CDLL(lib)


def _gather_ms(s_pre, src_idx, n) -> float:
    """Device ms of the step's gathers alone: s_pre[src] for every real slot
    of the format, in slot order, at the card's full occupancy (the helper
    kernel above; CUDA events over ten launches)."""
    import ctypes

    import torch
    fn = _helper_lib().gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    idx = src_idx.reshape(-1)
    idx = idx[idx < n].contiguous()
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        assert fn(s_pre.data_ptr(), idx.data_ptr(), idx.numel(),
                  out.data_ptr(), stream) == 0
    return _events_ms(launch, 10)


def _chain_cycles() -> dict:
    """Cycles a dependent add at f32 and f64 (the chain kernel above)."""
    import ctypes

    import torch
    fn = _helper_lib().chain_cycles
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    got = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        x = torch.ones(64, dtype=dtype, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        iters = 100_000
        assert fn(int(dtype == torch.float64), x.data_ptr(), iters,
                  cyc.data_ptr()) == 0
        got[name] = float(cyc.item()) / (4 * iters)
    return got


def _sm_clock_mhz() -> float:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0])


def _smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip() or f"nvidia-smi failed: {res.stderr.strip()}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, metavar="NAME=PATH")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    trees = [tuple(t.split("=", 1)) for t in args.trees]
    print(_smi(), flush=True)
    runs = []
    for letter in args.order:
        name, path = trees["AB".index(letter)]
        root = os.path.abspath(path)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(root, "src"), root]))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            print(f"worker {name} failed (exit {res.returncode})",
                  file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["tree"], got["seconds"] = name, time.perf_counter() - t0
        runs.append(got)
        print(json.dumps(got), flush=True)
    table = {}
    for name, _ in trees:
        mine = [r for r in runs if r["tree"] == name]
        table[name] = {k: {"min": min(v), "median": statistics.median(v),
                           "max": max(v)} for k in MEASURES
                       for v in [[x for r in mine for x in r[k]]]}
    (a, _), (b, _) = trees
    ratio = {k: table[b][k]["min"] / table[a][k]["min"] for k in MEASURES}
    for k in MEASURES:
        print(f"{k:28s} " + "  ".join(
            f"{n}: min {table[n][k]['min']:.5g} median "
            f"{table[n][k]['median']:.5g} max {table[n][k]['max']:.5g}"
            for n, _ in trees) + f"  {b}/{a} of the minima {ratio[k]:.4g}")
    cycles, mhz = _chain_cycles(), _sm_clock_mhz()
    last = [r for r in runs if r["tree"] == b][-1]      # the second tree's
    degrees = {"twitter": last["twitter_max_in_degree"],
               **{b: last[f"{b}_bucket"]["max_in_degree"] for b in BUCKETS}}
    chain = {shape: deg * cycles["f32"] / (mhz * 1e3)
             for shape, deg in degrees.items()}
    model = last["g500_model"]
    degrees["g500"] = model["max_in_degree"]
    chain["g500"] = model["max_in_degree"] * cycles["f64"] / (mhz * 1e3)
    model["serial_path_ms"] = (model["serial_slots"] * cycles["f64"]
                               / (mhz * 1e3) / model["resident_ctas"])
    print(f"dependent add: f32 {cycles['f32']:.3f} cycles, f64 "
          f"{cycles['f64']:.3f} cycles; SM clock {mhz:g} MHz; chain bound "
          f"(longest in-degree; g500 at f64, the others at f32): " + ", ".join(
              f"{k} {degrees[k]} in-edges {v:.5f} ms"
              for k, v in chain.items()))
    print(f"g500 ring model: {model['serial_slots']} of "
          f"{model['real_slots']} real slots on the serial fold path "
          f"({model['serial_share']:.4f}) over {model['stages']} stages of "
          f"{model['sblk']} blocks: {model['serial_path_ms']:.4f} ms of "
          f"dependent f64 adds over {model['resident_ctas']} resident CTAs; "
          f"row-path share ({b}): {model['row_path_share']}; the step's "
          f"{model['real_slots']} gathers alone: {model['gather_ms']:.4f} ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": _smi(), "order": args.order, "runs": runs,
                       "table": table, "ratio_of_minima": ratio,
                       "add_cycles": cycles, "sm_clock_mhz": mhz,
                       "max_in_degree": degrees, "chain_bound_ms": chain,
                       "g500_model": model},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        print(json.dumps(worker()))
        sys.exit(0)
    sys.exit(main())
