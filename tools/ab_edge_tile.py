"""Time the edge-tile kernels and the cold resolve of two checkouts in turns.

Usage (on a machine with a CUDA card, from any directory)::

    python3 tools/ab_edge_tile.py parent=PATH change=PATH \
        [--order ABBA] [--out FILE]

Each ``NAME=PATH`` is the root of a checkout of this repository (for
example one unpacked from ``git archive``). For each letter of ``--order``
(A the first checkout, B the second; default ``ABBA``) the script starts a
worker process whose ``PYTHONPATH`` is that checkout's ``src`` only, so it
imports that checkout's ``repro_torch`` and builds that checkout's kernels
into that checkout's ``build/``. A worker measures, on the twitter stand-in
at float32:

* ``power_step`` at tile 256 (the ``cuda`` backend's shape) and
  ``edge_spmv`` at tile 512 (the cost model's pick), warm, 200 back-to-back
  calls a reading, three readings each, by two yardsticks: CUDA events
  around the calls (``events_ms``: the larger of the device time and the
  host's time to issue a call) and the summed kernel durations that
  ``torch.profiler`` records (``device_ms``);
* the cold resolve of a ``cuda`` engine at tile 256 and tol 1e-8 (host
  clock around ``run`` and a read of the result), five times, and one more
  under the profiler for the card's busy share of its wall time.

The script prints each worker's readings as one JSON line, then for each
checkout and measure the minimum, median and maximum over all its workers,
and the second checkout's minimum over the first's. ``--out`` also writes
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

MEASURES = ("power_step_t256_events_ms", "power_step_t256_device_ms",
            "edge_spmv_t512_events_ms", "edge_spmv_t512_device_ms",
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
    out = {"package": repro_torch.__file__, **{k: [] for k in MEASURES}}

    def fmt_at(tile):
        fmt = DeviceEdgeTiles.from_format(build_edge_tiles(g, tile=tile),
                                          "cuda")
        # a checkout whose format holds the launch order passes it, as its
        # engine does
        kw = dict(n=fmt.n, tile=tile)
        if hasattr(fmt, "tile_order"):
            kw["tile_order"] = fmt.tile_order
        return fmt, kw

    fmt, kw = fmt_at(256)
    ops = build_operators(g, act, dtype=torch.float32, device="cuda")
    s = torch.as_tensor(np.random.default_rng(0).uniform(size=g.n),
                        dtype=torch.float32, device="cuda")
    step_args = (fmt.pad_gather_source(s * ops.inv_w), fmt.src_idx,
                 fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                 fmt.tile_num_blocks, fmt.pad_node_vector(ops.mu),
                 fmt.pad_node_vector(ops.c), fmt.pad_node_vector(s))
    fmt5, kw5 = fmt_at(512)
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
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": _smi(), "order": args.order, "runs": runs,
                       "table": table, "ratio_of_minima": ratio}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--worker"]:
        print(json.dumps(worker()))
        sys.exit(0)
    sys.exit(main())
