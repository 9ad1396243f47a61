#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, all
sources at once, into ``build/``), then runs these phases and fails (exit 1)
on the first check that does not hold:

1. device: CUDA present, the card's name and power limit, kernel build time;
2. every kernel on the card against its plain PyTorch version on the same
   inputs (``power_step``'s and ``edge_spmv``'s on CPU copies, which sum in
   the kernel's slot order), at float32 and float64, at the main path's
   shapes, at every shape the autotuner may pick or time (edge tiles 128,
   256, 512; BSR ``td`` 128 and 256), on ragged and padded cases, and twice
   on the same inputs (outputs must be bitwise equal);
3. the serving path in the ``edge_tile`` regime: ``PsiService`` on the
   twitter stand-in with ``backend="cuda"`` through a cold solve, ranked
   requests, an activity update, an edge insert into free sentinel slots
   and an edge removal, each fixed point held against the ``reference``
   backend at float64 on the card;
4. the same in the ``bsr`` regime on a clustered graph, with an edge insert
   into an existing dense tile;
5. ``backend="auto"`` on both graphs: a cold solve and a warm activity
   update, first with the cost model's plan (which must equal the plan
   computed on the host), then with ``microbench=True`` (every candidate's
   push kernel timed on the card; the candidate table is printed), each
   fixed point at gap 0 and held against the float64 reference;
6. ``accelerate=True`` on the ``cuda`` backend at float64 on the twitter
   stand-in: the same ψ as the reference in fewer mat-vecs than the plain
   loop;
7. times: CUDA events, warm, for each kernel, its plain version and one
   PyTorch sparse call for the same push, beside the kernel's bound.

Phases 3 to 6 are the main paths (the auto phase is two: model-only and
microbench): every launch counter is set to 0 just before each path and
read just after, and each kernel of a path must have launched there. The
last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# (rtol, atol) of each kernel's output against its plain version, and the
# relative tolerance of power_step's gap. power_step is held against its plain
# version on CPU copies of the inputs: the CPU's index_add_ adds in slot order,
# as the kernel does, so only the epilogue's FMA contraction (<= 1 ulp) and
# the gap's summation order differ. bsr_spmv is held against its plain
# version on the card, a batched matmul that sums in another order.
POWER_TOL = {"float32": (1e-6, 1e-7), "float64": (1e-14, 1e-16)}
GAP_RTOL = {"float32": 1e-4, "float64": 1e-10}
BSR_TOL = {"float32": (2e-5, 2e-6), "float64": (1e-12, 1e-14)}
# the model-only plan the cost model gives both graphs (computed on the
# host in the run as well; the two must agree)
AUTO_MODEL_LABEL = "edge_tile(tile=512,e1=8,e2=128)"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, after warm-up."""
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


# --------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------- #
def edge_tile_inputs(graph, dtype, *, tile=256, pad_blocks=0, seed=0):
    """Everything ``power_step_call`` takes for ``graph``, on the card, with
    a random series vector made from ``seed``."""
    import torch
    from repro_torch.core import build_operators, heterogeneous
    from repro_torch.kernels.formats import (build_edge_tiles,
                                             pad_edge_tile_blocks)
    from repro_torch.kernels.ops import DeviceEdgeTiles
    fmt_h = build_edge_tiles(graph, tile=tile)
    if pad_blocks:
        fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + pad_blocks)
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cuda")
    ops = build_operators(graph, heterogeneous(graph.n, seed=seed + 1),
                          dtype=dtype, device="cuda")
    rng = np.random.default_rng(seed)
    s = torch.as_tensor(rng.uniform(size=graph.n), dtype=dtype, device="cuda")
    s_pad = fmt.pad_node_vector(s)
    s_pre = fmt.pad_gather_source(s * ops.inv_w)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks,
            fmt.pad_node_vector(ops.mu), fmt.pad_node_vector(ops.c), s_pad)
    return fmt_h, fmt, args


def bsr_inputs(graph, dtype, *, td=128, seed=0):
    import torch
    from repro_torch.device import numpy_dtype
    from repro_torch.kernels.formats import build_bsr
    from repro_torch.kernels.ops import DeviceBsr
    fmt_h = build_bsr(graph, td=td, dtype=numpy_dtype(dtype))
    fmt = DeviceBsr.from_format(fmt_h, "cuda")
    rng = np.random.default_rng(seed)
    s_pad = torch.zeros(1, fmt.n_src_pad, dtype=dtype, device="cuda")
    s_pad[0, :graph.n] = torch.as_tensor(rng.uniform(size=graph.n),
                                         dtype=dtype)
    args = (s_pad, fmt.tiles, fmt.src_tile, fmt.dst_tile,
            fmt.dst_first_block, fmt.dst_num_blocks)
    return fmt_h, fmt, args


def push_csr(graph, dtype):
    """Aᵀ of the bare push as a CUDA CSR tensor (rows = dst, cols = src):
    the yardstick library call ``torch.sparse.mm(csr, s_pre)``."""
    import torch
    order = np.lexsort((graph.src, graph.dst))    # by dst, then src: CSR
    src = graph.src[order]                        # wants sorted columns
    crow = np.concatenate([[0], np.cumsum(graph.in_degree)]).astype(np.int64)
    return torch.sparse_csr_tensor(
        torch.as_tensor(crow), torch.as_tensor(src.astype(np.int64)),
        torch.ones(graph.m, dtype=dtype), size=(graph.n, graph.n),
        device="cuda", check_invariants=True)


# --------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------- #
def phase_device(report: dict) -> None:
    import torch
    from repro_torch.kernels import _build
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    report["smi"] = nvidia_smi_line()
    say(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {report['smi']}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    say(f"built {sorted(libs)} in {report['build_s']:.2f} s "
        f"(sm_90a, nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = (log.read_text().splitlines() if log.exists() else [])
        for line in lines:
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")


def _compare(name, out_k, out_p, rtol, atol) -> tuple[float, float]:
    """(max abs error, the worst element's error as a share of its own
    limit ``atol + rtol·|plain|``); fails if any share exceeds 1."""
    import torch
    err = (out_k - out_p).abs()
    share = float((err / (atol + rtol * out_p.abs())).max())
    check(share <= 1.0, f"{name}: an entry is {share:.3g}x its limit "
          f"(rtol {rtol} / atol {atol}; max abs err {float(err.max()):.3e})")
    check(bool(torch.isfinite(out_k).all()), f"{name}: non-finite output")
    return float(err.max()), share


def phase_kernels(report: dict) -> None:
    import torch
    from repro_torch.graphs import clustered_blocks, erdos_renyi, load_dataset
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call, bsr_spmv_plain
    from repro_torch.kernels.power_step import (power_step_call,
                                                power_step_plain)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain bmm in full f32
    twitter = load_dataset("twitter")
    cases = [("twitter", twitter, 256, 0), ("twitter+pad", twitter, 256, 7),
             ("twitter t128", twitter, 128, 0),
             ("twitter t128+pad", twitter, 128, 7),
             ("twitter t512", twitter, 512, 0),
             ("twitter t512+pad", twitter, 512, 7),
             ("ragged n=300", erdos_renyi(300, 1500, seed=21), 128, 0),
             ("n=n_pad=256", erdos_renyi(256, 2000, seed=22), 128, 0)]
    errs = report.setdefault("max_abs_err", {})
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        rtol, atol = POWER_TOL[dname]
        gtol = GAP_RTOL[dname]
        for cname, g, tile, pad in cases:
            fmt_h, fmt, args = edge_tile_inputs(g, dtype, tile=tile,
                                                pad_blocks=pad)
            kw = dict(n=fmt.n, tile=fmt.tile)
            s1, gap1 = power_step_call(*args, **kw)
            s2, gap2 = power_step_call(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(s1, s2) and torch.equal(gap1, gap2),
                  f"power_step {cname} {dname}: two runs differ")
            host = [a.cpu() for a in args]
            sp, gapp = power_step_plain(*host[:4], *host[6:], tile=fmt.tile)
            err, share = _compare(f"power_step {cname} {dname}", s1.cpu(), sp,
                                  rtol, atol)
            gap_rel = abs(float(gap1) - float(gapp)) / max(abs(float(gapp)),
                                                          1e-30)
            check(gap_rel <= gtol, f"power_step {cname} {dname}: gap rel "
                  f"err {gap_rel:.3e} > {gtol}")
            say(f"power_step {cname:16s} {dname}: {fmt_h.num_tiles} tiles, "
                f"{fmt_h.num_blocks} blocks (max {fmt_h.tile_num_blocks.max()}"
                f"/tile), max abs err {err:.3e} (rtol {rtol}, atol {atol}; "
                f"worst element at {share:.3g} of its limit), gap rel err "
                f"{gap_rel:.3e} (tol {gtol}), bitwise repeatable")
            if cname == "twitter" and dname == "float32":
                errs["power_step"] = err
                report["power_step_share"] = share
                say(f"  twitter format indices: "
                    f"{(fmt_h.src_idx.nbytes + fmt_h.dst_local.nbytes) / 1e6:.1f} MB")
    clustered = clustered_blocks(262_144, 4_194_304, block=128, p_in=1.0,
                                 seed=3)
    report["clustered"] = clustered
    report["twitter"] = twitter
    ragged = clustered_blocks(1000, 8000, block=128, p_in=0.9, seed=23)
    bcases = [("clustered", clustered, 128),
              ("clustered td256", clustered, 256),
              ("ragged n=1000", ragged, 128), ("ragged td256", ragged, 256)]
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        rtol, atol = BSR_TOL[dname]
        for cname, g, td in bcases:
            fmt_h, fmt, args = bsr_inputs(g, dtype, td=td)
            kw = dict(num_dst_tiles=fmt.num_dst_tiles)
            o1 = bsr_spmv_call(*args, **kw)
            o2 = bsr_spmv_call(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(o1, o2), f"bsr_spmv {cname} {dname}: two runs "
                  "differ")
            op = bsr_spmv_plain(*args[:4], **kw)
            err, share = _compare(f"bsr_spmv {cname} {dname}", o1, op, rtol,
                                  atol)
            say(f"bsr_spmv {cname:15s} {dname}: {fmt_h.num_blocks} tiles "
                f"({fmt_h.tiles.nbytes / 1e6:.1f} MB, occupancy "
                f"{fmt_h.occupancy:.3f}), max abs err {err:.3e} "
                f"(rtol {rtol}, atol {atol}; worst element at {share:.3g} of "
                f"its limit), bitwise repeatable")
            if cname == "clustered" and dname == "float32":
                errs["bsr_spmv"] = err
                report["bsr_spmv_share"] = share
            del fmt, args, o1, o2, op
        torch.cuda.empty_cache()
    edge_spmv_cases(report, twitter)


def _slot_weights(fmt_h, dtype, seed):
    """Random per-edge weights in the slot layout, 0 in sentinel slots."""
    import torch
    w = np.random.default_rng(seed).uniform(0.5, 2.0,
                                            size=fmt_h.src_idx.shape)
    w[fmt_h.src_idx == fmt_h.n] = 0.0
    return torch.as_tensor(w, dtype=dtype, device="cuda")


def edge_spmv_cases(report: dict, twitter) -> None:
    """edge_spmv on the twitter stand-in's format at every edge-tile shape
    the autotuner times, plain and with 7 pad blocks, weighted and not, at
    f32 and f64, against its plain version on CPU copies of the inputs."""
    import torch
    from repro_torch.kernels.edge_spmv import edge_spmv_call, edge_spmv_plain
    from repro_torch.kernels.formats import (build_edge_tiles,
                                             pad_edge_tile_blocks)
    from repro_torch.kernels.ops import DeviceEdgeTiles
    worst = (0.0, 0.0)
    for tile in (128, 256, 512):
        base = build_edge_tiles(twitter, tile=tile)
        for pad in (0, 7):
            fmt_h = (pad_edge_tile_blocks(base, base.num_blocks + pad)
                     if pad else base)
            fmt = DeviceEdgeTiles.from_format(fmt_h, "cuda")
            host_fmt = [t.cpu() for t in (fmt.src_idx, fmt.dst_local,
                                          fmt.block_tile)]
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).removeprefix("torch.")
                # both add in slot order and round the weight product
                # before the sum: they should agree to the last bit; held
                # at power_step's tolerances
                rtol, atol = POWER_TOL[dname]
                s = torch.as_tensor(
                    np.random.default_rng(tile + pad).uniform(size=fmt.n),
                    dtype=dtype, device="cuda")
                s_pre = fmt.pad_gather_source(s)
                for weighted in (False, True):
                    w = (_slot_weights(fmt_h, dtype, tile + pad + 1)
                         if weighted else None)
                    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
                            fmt.tile_first_block, fmt.tile_num_blocks, w)
                    kw = dict(n=fmt.n, tile=tile)
                    o1 = edge_spmv_call(*args, **kw)
                    o2 = edge_spmv_call(*args, **kw)
                    torch.cuda.synchronize()
                    name = (f"edge_spmv t{tile}{'+pad' if pad else ''} "
                            f"{'weighted' if weighted else 'plain'} {dname}")
                    check(torch.equal(o1, o2), f"{name}: two runs differ")
                    op = edge_spmv_plain(s_pre.cpu(), *host_fmt,
                                         None if w is None else w.cpu(),
                                         tile=tile, num_tiles=fmt.num_tiles)
                    err, share = _compare(name, o1.cpu(), op, rtol, atol)
                    worst = max(worst, (share, err))
                    say(f"{name:34s}: {fmt_h.num_blocks} blocks, max abs err "
                        f"{err:.3e} (rtol {rtol}, atol {atol}; worst element "
                        f"at {share:.3g} of its limit), bitwise repeatable")
                    if tile == 512 and not pad and not weighted \
                            and dname == "float32":
                        report["max_abs_err"]["edge_spmv"] = err
            del fmt, host_fmt
    report["edge_spmv_share"] = worst[0]
    say(f"edge_spmv: 24 cases, worst element at {worst[0]:.3g} of its limit "
        f"(max abs err {worst[1]:.3e})")


def _check_fixed_point(tag, svc, ref, counter, before, report,
                       exact_gap=False) -> None:
    import torch
    res, ref_res = svc.last_result, ref.last_result
    check(res is not None and ref_res is not None, f"{tag}: no solve")
    check(res.converged, f"{tag}: not converged after {res.iterations} "
          f"iterations (gap {res.gap:.3e}, tol {svc.tol})")
    check(not exact_gap or res.gap == 0.0,
          f"{tag}: gap {res.gap:.3e}, not exactly 0")
    check(ref_res.converged, f"{tag}: f64 reference did not converge")
    psi = res.psi.double()
    rel = float((psi - ref_res.psi).abs().sum() / ref_res.psi.abs().sum())
    check(bool(torch.isfinite(psi).all()) and psi.shape == ref_res.psi.shape,
          f"{tag}: ψ not finite or of the wrong shape")
    check(rel <= 1e-5, f"{tag}: ‖ψ−ψ_ref‖₁/‖ψ_ref‖₁ = {rel:.3e} > 1e-5")
    top, _ = svc.top_k(10)
    ref_top, _ = ref.top_k(10)
    check(np.array_equal(top, ref_top),
          f"{tag}: top-10 {top.tolist()} != reference {ref_top.tolist()}")
    launched = counter.launches - before
    check(launched == res.iterations, f"{tag}: {launched} kernel launches "
          f"for {res.iterations} iterations")
    say(f"{tag}: {res.iterations} iterations, gap {res.gap:.3e}, "
        f"{launched} launches, rel L1 vs f64 reference {rel:.3e}, "
        f"top-10 identical")
    report.setdefault("fixed_points", []).append((res.iterations, rel))


def _drive_service(tag, graph, act, counter, report, engine_opts,
                   edge_pairs) -> None:
    """Cold solve, requests, an activity update, edge insert and removal —
    each fixed point checked against the f64 reference on the card."""
    import torch
    from repro_torch.core import PsiService
    t0 = time.perf_counter()
    svc = PsiService(graph, act, tol=1e-8, backend="cuda", device="cuda",
                     engine_opts=engine_opts)
    ref = PsiService(graph, act, tol=1e-12, backend="reference",
                     dtype=torch.float64, device="cuda")
    say(f"{tag}: services prepared in {time.perf_counter() - t0:.2f} s "
        f"(n={graph.n}, m={graph.m})")
    before = counter.launches
    svc.scores()
    report[f"{tag}_cold_launches"] = counter.launches - before
    ref.scores()
    _check_fixed_point(f"{tag} cold", svc, ref, counter, before,
                       report)
    rng = np.random.default_rng(0)
    for r in range(3):
        users = rng.integers(0, graph.n, 8)
        ranks = svc.rank_of(users)
        scores = svc.scores_batch(users)
        ref_scores = ref.scores_batch(users)
        check(np.allclose(scores, ref_scores, rtol=1e-4, atol=1e-12),
              f"{tag} request {r}: scores_batch disagrees with reference")
        check(np.array_equal(ranks, svc.rank_of(users)), "rank_of unstable")
    u = int(rng.integers(0, graph.n))
    before = counter.launches
    for s in (svc, ref):
        s.update_activity(np.asarray([u]), lam=np.asarray([act.lam[u] * 20]))
    _check_fixed_point(f"{tag} update_activity", svc, ref, counter, before,
                       report)
    builds = svc.engine.format_builds
    src, dst = edge_pairs
    before = counter.launches
    for s in (svc, ref):
        s.add_edges(src, dst)
    check(svc.engine.format_builds == builds,
          f"{tag} add_edges: the format was rebuilt instead of patched")
    _check_fixed_point(f"{tag} add_edges (in place)", svc, ref, counter,
                       before, report)
    g = svc.graph
    pick = rng.choice(g.m, 32, replace=False)
    before = counter.launches
    for s in (svc, ref):
        s.remove_edges(g.src[pick], g.dst[pick])
    check(svc.graph.m == g.m - 32, f"{tag} remove_edges: edge count")
    _check_fixed_point(f"{tag} remove_edges", svc, ref, counter, before,
                       report)
    report[f"{tag}_service"] = svc


def phase_edge_tile(report: dict) -> None:
    from repro_torch.core import heterogeneous
    from repro_torch.kernels.power_step import power_step_call
    g = report["twitter"]
    rng = np.random.default_rng(1)
    # new edges land in tiles with free sentinel slots (a full tile would
    # take the format-rebuild path instead); 256 = the default tile
    used = np.bincount(g.dst // 256)
    roomy = np.flatnonzero((-used) % 1024 >= 64)
    dst = rng.choice(roomy, 64) * 256 + rng.integers(0, 256, 64)
    pairs = (rng.integers(0, g.n, 64), np.minimum(dst, g.n - 1))
    _drive_service("edge_tile", g, heterogeneous(g.n, seed=6),
                   power_step_call, report, None, pairs)


def phase_bsr(report: dict) -> None:
    from repro_torch.core import heterogeneous
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call
    g = report["clustered"]
    rng = np.random.default_rng(2)
    src = rng.integers(0, g.n, 64)
    dst = (src // 128) * 128 + rng.integers(0, 128, 64)  # same dense tile
    _drive_service("bsr", g, heterogeneous(g.n, seed=6), bsr_spmv_call,
                   report, {"regime": "bsr"}, (src, dst))


def phase_auto(report: dict, microbench: bool) -> None:
    """``PsiService(backend="auto")`` on both graphs: the plan, a cold
    solve and a warm activity update, each fixed point at gap 0 and held
    against the f64 reference. Model-only, the plan must be the one the
    cost model gives on the host; with ``microbench`` the candidate table
    (every candidate's push kernel timed on the card) is printed."""
    import torch
    from repro_torch.core import PsiService, heterogeneous
    from repro_torch.kernels import autotune
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call
    from repro_torch.kernels.power_step import power_step_call
    from repro_torch.obs import explain
    mode = "microbench" if microbench else "model"
    for gname in ("twitter", "clustered"):
        g = report[gname]
        act = heterogeneous(g.n, seed=6)
        tag = f"auto[{mode}] {gname}"
        # the cost model's pick, on the host: no device, no calibration
        host = autotune.plan_regime(g, cache=None, calibration=None)
        t0 = time.perf_counter()
        svc = PsiService(g, act, tol=1e-8, backend="auto", device="cuda",
                         engine_opts={"microbench": microbench})
        plan = svc.engine.plan
        say(f"{tag}: plan {plan.label()} (source {plan.source}, est "
            f"{plan.est_bytes / 1e6:.2f} MB a step) in "
            f"{time.perf_counter() - t0:.2f} s; host model plan "
            f"{host.label()}")
        if microbench:
            check(plan.source == "microbench",
                  f"{tag}: plan source {plan.source}")
            rec = explain.get_log().last(kind="regime_plan")
            rows = [(c.name, c.est, c.measured_us, c.chosen)
                    for c in rec.candidates]
            check(all(us > 0 for _, _, us, _ in rows),
                  f"{tag}: a candidate was not timed")
            pruned = ", ".join(p.name for p in rec.pruned) or "none"
            say(f"{tag}: candidate table (label, est_bytes, measured us, "
                f"chosen); pruned: {pruned}")
            for name, est, us, chosen in rows:
                say(f"  candidate {gname:9s} {name:32s} {est:14.0f} "
                    f"{us:10.2f}  {'chosen' if chosen else ''}")
        else:
            check(plan.source == "model" and plan.label() == host.label()
                  == AUTO_MODEL_LABEL,
                  f"{tag}: plan {plan.label()} ({plan.source}) != host "
                  f"model plan {host.label()} / {AUTO_MODEL_LABEL}")
        ref = PsiService(g, act, tol=1e-12, backend="reference",
                         dtype=torch.float64, device="cuda")
        counter = (power_step_call if svc.engine.regime == "edge_tile"
                   else bsr_spmv_call)
        before = counter.launches
        svc.scores()
        ref.scores()
        _check_fixed_point(f"{tag} cold", svc, ref, counter, before, report,
                           exact_gap=True)
        u = int(np.random.default_rng(3).integers(0, g.n))
        before = counter.launches
        for x in (svc, ref):
            x.update_activity(np.asarray([u]),
                              lam=np.asarray([act.lam[u] * 20]))
        _check_fixed_point(f"{tag} update_activity", svc, ref, counter,
                           before, report, exact_gap=True)
        report.setdefault("auto_plans", {})[f"{mode}/{gname}"] = plan.label()
        del svc, ref
        torch.cuda.empty_cache()


def phase_accelerate(report: dict) -> None:
    """``accelerate=True`` on the cuda backend at f64, tol 1e-9, against
    the plain loop and the f64 reference on the card.

    On the twitter stand-in (heterogeneous rates, seed 6) the plain loop
    contracts fast (r ≈ 0.47 a step) and the JAX package's Aitken loop gains
    nothing there: its second jump is reverted, which disables the rest, so
    both packages take 45 mat-vecs, as the plain loop does. The check there
    is the loop's own bound — a reverted jump wastes one mat-vec and the
    body's two-step cadence at most one more. On the graph of the JAX
    package's acceleration test (``powerlaw_configuration(3000, 20000,
    seed=4)``, heterogeneous seed 5; 29 against 42 mat-vecs on the CPU) the
    accelerated loop must take strictly fewer mat-vecs."""
    import torch
    from repro_torch.core import heterogeneous, make_engine
    from repro_torch.graphs import powerlaw_configuration
    from repro_torch.kernels.power_step import power_step_call
    cases = [("twitter", report["twitter"], 6, False),
             ("powerlaw3000", powerlaw_configuration(3000, 20000, seed=4), 5,
              True)]
    out = {}
    for gname, g, seed, must_gain in cases:
        kw = dict(graph=g, activity=heterogeneous(g.n, seed=seed),
                  dtype=torch.float64, device="cuda")
        ref = make_engine("reference", **kw).run(tol=1e-12)
        runs = {}
        for accelerate in (False, True):
            eng = make_engine("cuda", accelerate=accelerate, **kw)
            before = power_step_call.launches
            res = eng.run(tol=1e-9)
            launched = power_step_call.launches - before
            tag = (f"cuda f64 {'accelerated' if accelerate else 'plain'} "
                   f"{gname}")
            check(res.converged, f"{tag}: not converged (gap {res.gap:.3e})")
            check(launched == res.iterations,
                  f"{tag}: {launched} launches for {res.iterations} mat-vecs")
            err = float((res.psi - ref.psi).abs().max())
            rel = float((res.psi - ref.psi).abs().sum()
                        / ref.psi.abs().sum())
            check(err <= 1e-9, f"{tag}: max |ψ−ψ_ref| = {err:.3e} > 1e-9")
            say(f"{tag} (tol 1e-9): {res.iterations} iterations, "
                f"{res.matvecs} mat-vecs, gap {res.gap:.3e}, max |ψ−ψ_ref| "
                f"{err:.3e}, rel L1 {rel:.3e}")
            runs[accelerate] = res.matvecs
        plain, acc = runs[False], runs[True]
        say(f"accelerate {gname}: {acc} mat-vecs accelerated against {plain} "
            f"plain")
        if must_gain:
            check(acc < plain, f"{gname}: accelerated used {acc} mat-vecs, "
                  f"plain {plain}: not fewer")
        else:
            check(acc <= plain + 2, f"{gname}: accelerated used {acc} "
                  f"mat-vecs, plain {plain}: beyond the loop's bound")
        out[gname] = (plain, acc)
    report["accelerate_matvecs"] = out


def phase_times(report: dict) -> list[dict]:
    import torch
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call, bsr_spmv_plain
    from repro_torch.kernels.power_step import (power_step_call,
                                                power_step_plain)
    rows = []
    # power_step at the edge_tile service's shapes: twitter, float32
    eng = report["edge_tile_service"].engine
    fmt = eng.fmt
    s = eng.fmt.pad_node_vector(report["edge_tile_service"].last_result.s)
    s_pre = torch.nn.functional.pad(
        s, (0, fmt.n_gather - fmt.n_pad)) * eng._inv_w_gather
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, eng._mu_pad,
            eng._c_pad, s)
    kw = dict(n=fmt.n, tile=fmt.tile)
    ms = time_ms(lambda: power_step_call(*args, **kw), 200)
    plain_ms = time_ms(lambda: power_step_plain(*args[:4], *args[6:],
                                                tile=fmt.tile), 200)
    csr = push_csr(eng.graph, torch.float32)
    x = s_pre[0, :fmt.n, None].contiguous()
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x), 200)
    elt = s.element_size()
    # every slot's src_idx (a sentinel, src == n, can sit anywhere), dst_local
    # of the real slots only (the kernel skips the sentinels'), s_pre's n
    # entries, μ, c, s_old in and s_new out, the gap
    real = int((fmt.src_idx < fmt.n).sum())
    nbytes = (fmt.src_idx.nbytes + 4 * real
              + fmt.tile_first_block.nbytes + fmt.tile_num_blocks.nbytes
              + elt * (fmt.n + 4 * fmt.n_pad) + elt)
    flops = 2 * real + 4 * fmt.n_pad
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    rows.append(dict(
        name="power_step", route="cuda",
        source="src/repro_torch/kernels/csrc/power_step.cu",
        replaces="src/repro/kernels/power_step.py:66",
        launches=report["launches"]["edge_tile"]["power_step"],
        max_abs_err=report["max_abs_err"]["power_step"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / F32_FLOP_PER_S else "operations"),
        library_ms=lib_ms))
    say(f"power_step (twitter, f32): {ms:.4f} ms/launch, "
        f"{report['edge_tile_cold_launches']} launches per cold resolve, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB a step at 3.35 TB/s, "
        f"{real} real slots of {fmt.src_idx.numel()}; "
        f"the step's working set fits the 50 MB L2, so the loop runs warm "
        f"and is timed warm), plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm CSR push {lib_ms:.4f} ms")
    del csr, x
    # power_step at the autotuner's other edge tiles, same graph and dtype
    ms_by_tile = {256: ms}
    for tile in (128, 512):
        _, fmt_t, args_t = edge_tile_inputs(eng.graph, torch.float32,
                                            tile=tile)
        ms_by_tile[tile] = time_ms(
            lambda: power_step_call(*args_t, n=fmt_t.n, tile=tile), 200)
    report["power_step_ms_by_tile"] = ms_by_tile
    say("power_step (twitter, f32) ms/launch by tile: "
        + ", ".join(f"{t}: {v:.4f}" for t, v in sorted(ms_by_tile.items())))
    del fmt_t, args_t

    # bsr_spmv at the bsr service's shapes: clustered graph, float32
    eng = report["bsr_service"].engine
    fmt = eng.fmt
    s = report["bsr_service"].last_result.s
    s_pad = torch.nn.functional.pad(s * eng.ops.inv_w,
                                    (0, fmt.n_src_pad - fmt.n))[None, :]
    args = (s_pad, fmt.tiles, fmt.src_tile, fmt.dst_tile,
            fmt.dst_first_block, fmt.dst_num_blocks)
    kw = dict(num_dst_tiles=fmt.num_dst_tiles)
    ms = time_ms(lambda: bsr_spmv_call(*args, **kw), 100)
    plain_ms = time_ms(lambda: bsr_spmv_plain(*args[:4], **kw), 20)
    csr = push_csr(eng.graph, torch.float32)
    x = s_pad[0, :fmt.n, None].contiguous()
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x), 100)
    elt = s.element_size()
    nbytes = (fmt.tiles.nbytes + fmt.src_tile.nbytes
              + fmt.dst_first_block.nbytes + fmt.dst_num_blocks.nbytes
              + elt * (fmt.n_src_pad + fmt.num_dst_tiles * fmt.td))
    flops = 2 * int(fmt.tiles.numel())
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    # the bound above is the floor of this dense-tile format; a format that
    # keeps only the nonzeros of the 0/1 matrix moves their int32 source ids,
    # n + 1 row offsets, s_pre in and t out
    m = eng.graph.m
    nz_bytes = 4 * m + 4 * (fmt.n + 1) + 2 * elt * fmt.n
    nz_bound = nz_bytes / HBM_BYTES_PER_S * 1e3
    report["bsr_nonzero_bound_ms"] = nz_bound
    rows.append(dict(
        name="bsr_spmv", route="cuda",
        source="src/repro_torch/kernels/csrc/bsr_spmv.cu",
        replaces="src/repro/kernels/bsr_spmv.py:39",
        launches=report["launches"]["bsr"]["bsr_spmv"],
        max_abs_err=report["max_abs_err"]["bsr_spmv"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / F32_FLOP_PER_S else "operations"),
        library_ms=lib_ms))
    say(f"bsr_spmv (clustered, f32): {ms:.4f} ms/launch, "
        f"{report['bsr_cold_launches']} launches per cold resolve, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB a step at 3.35 TB/s; "
        f"the tiles exceed the 50 MB L2, so every step streams them; the "
        f"floor of this dense-tile format), nonzero floor {nz_bound:.4f} ms "
        f"({nz_bytes / 1e6:.1f} MB: {m} int32 source ids, row offsets, "
        f"s_pre, t), plain {plain_ms:.4f} ms, torch.sparse.mm CSR push "
        f"{lib_ms:.4f} ms")
    del csr, x

    # edge_spmv at the tile the cost model picks for the twitter stand-in,
    # unweighted, f32 — the shape the auto --microbench path times (it also
    # launches tiles 128 and 256)
    from repro_torch.kernels.edge_spmv import edge_spmv_call, edge_spmv_plain
    from repro_torch.kernels.formats import build_edge_tiles
    from repro_torch.kernels.ops import DeviceEdgeTiles
    g = report["twitter"]
    fmt = DeviceEdgeTiles.from_format(build_edge_tiles(g, tile=512), "cuda")
    s = torch.as_tensor(np.random.default_rng(0).random(g.n),
                        dtype=torch.float32, device="cuda")
    s_pre = fmt.pad_gather_source(s)
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks)
    kw = dict(n=fmt.n, tile=fmt.tile)
    ms = time_ms(lambda: edge_spmv_call(*args, **kw), 200)
    plain_ms = time_ms(lambda: edge_spmv_plain(
        *args[:4], tile=fmt.tile, num_tiles=fmt.num_tiles), 200)
    csr = push_csr(g, torch.float32)
    x = s_pre[0, :fmt.n, None].contiguous()
    lib_ms = time_ms(lambda: torch.sparse.mm(csr, x), 200)
    elt = s.element_size()
    # every slot's src_idx, dst_local of the real slots only (the kernel
    # skips the sentinels'; no weights on this path), the block ranges,
    # s_pre's n entries once and the padded output once
    real = int((fmt.src_idx < fmt.n).sum())
    nbytes = (fmt.src_idx.nbytes + 4 * real + fmt.tile_first_block.nbytes
              + fmt.tile_num_blocks.nbytes + elt * (fmt.n + fmt.n_pad))
    flops = real
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    rows.append(dict(
        name="edge_spmv", route="cuda",
        source="src/repro_torch/kernels/csrc/edge_spmv.cu",
        replaces="src/repro/kernels/edge_spmv.py:64",
        launches=report["launches"]["auto_microbench"]["edge_spmv"],
        max_abs_err=report["max_abs_err"]["edge_spmv"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / F32_FLOP_PER_S else "operations"),
        library_ms=lib_ms))
    say(f"edge_spmv (twitter, tile 512, f32): {ms:.4f} ms/launch, "
        f"{rows[-1]['launches']} launches on the auto --microbench path, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s, {real} "
        f"real slots of {fmt.src_idx.numel()}), plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm CSR push {lib_ms:.4f} ms")
    del csr, x, fmt, s_pre, args

    # end-to-end cold resolve (host clock, synchronized), three repeats
    for tag in ("edge_tile", "bsr"):
        eng = report[f"{tag}_service"].engine
        walls, iters = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.run(tol=1e-8)
            float(res.psi.sum())
            walls.append((time.perf_counter() - t0) * 1e3)
            iters = res.iterations
        say(f"{tag} cold resolve: {iters} iterations, "
            f"{sorted(walls)} ms (min {min(walls):.3f} ms)")
        report[f"{tag}_resolve"] = (iters, min(walls))
        report[f"{tag}_busy"] = profile_resolve(tag, eng)
    return rows


def profile_resolve(tag, eng) -> float | None:
    """One cold resolve under ``torch.profiler``: device time by kernel and
    the device's busy share of the resolve's wall time (returned; None when
    the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(eng.run(tol=1e-8).psi.sum())
        wall_us = (time.perf_counter() - t0) * 1e6
    # device activities only (kernels, copies): a host op such as
    # aten::copy_ also reports the device time of what it launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        say(f"{tag} profile: no device time recorded (not measured)")
        return None
    say(f"{tag} profile: device busy {busy_us:.1f} us of {wall_us:.1f} us "
        f"wall ({busy_us / wall_us:.1%}); by kernel:")
    for dev_us, count, key in rows[:8]:
        say(f"  {dev_us:10.1f} us  x{count:<4d} {key[:90]}")
    return busy_us / wall_us


def summary(report: dict) -> str:
    """The run's main facts on one line, for readers of the output's tail:
    iterations and rel L1 error of each fixed point (edge_tile, bsr, then
    the auto runs), the worst kernel element's share of its limit, min cold
    resolve ms and the profiled busy share of each regime, bsr_spmv's
    nonzero floor, the auto plans, the plain and accelerated f64 mat-vecs
    and power_step's ms at each edge tile."""
    def g(x):
        return None if x is None else float(f"{x:.4g}")
    return json.dumps({
        "iters": [i for i, _ in report["fixed_points"]],
        "max_rel_l1": g(max(r for _, r in report["fixed_points"])),
        "share_of_limit": [g(report["power_step_share"]),
                           g(report["bsr_spmv_share"])],
        "resolve_ms": {k: g(report[f"{k}_resolve"][1])
                       for k in ("edge_tile", "bsr")},
        "busy": {k: g(report[f"{k}_busy"]) for k in ("edge_tile", "bsr")},
        "bsr_nonzero_bound_ms": g(report["bsr_nonzero_bound_ms"]),
        "edge_spmv_share": g(report["edge_spmv_share"]),
        "auto_plans": report["auto_plans"],
        "accelerate_matvecs": report["accelerate_matvecs"],
        "power_step_ms_by_tile": {k: g(v) for k, v in
                                  report["power_step_ms_by_tile"].items()}})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call
    from repro_torch.kernels.edge_spmv import edge_spmv_call
    from repro_torch.kernels.power_step import power_step_call
    report: dict = {}
    counters = {"power_step": power_step_call, "bsr_spmv": bsr_spmv_call,
                "edge_spmv": edge_spmv_call}
    # each main path and the kernels it must launch
    paths = [("edge_tile", phase_edge_tile, ("power_step",)),
             ("bsr", phase_bsr, ("bsr_spmv",)),
             ("auto_model", lambda r: phase_auto(r, False), ("power_step",)),
             ("auto_microbench", lambda r: phase_auto(r, True),
              ("edge_spmv", "bsr_spmv")),
             ("accelerate", phase_accelerate, ("power_step",))]
    try:
        phase_device(report)
        phase_kernels(report)
        report["launches"] = {}
        for path, run, needs in paths:
            for fn in counters.values():
                fn.launches = 0                  # this main path starts here
            run(report)
            got = {k: fn.launches for k, fn in counters.items()}
            report["launches"][path] = got
            say(f"main path {path}: launches {got}")
            for k in needs:
                check(got[k] > 0, f"kernel {k} never launched on the main "
                      f"path {path}")
        rows = phase_times(report)
    except SmokeFailure as exc:
        print(f"[smoke] FAIL: {exc}", file=sys.stderr)
        return 1
    say(f"summary: {summary(report)}")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
