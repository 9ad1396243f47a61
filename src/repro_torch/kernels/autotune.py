"""Regime autotuner: pick the cheapest execution plan per graph.

:mod:`repro_torch.kernels.formats` keeps two SpMV layouts — the edge-tile
format (the ``power_step`` / ``edge_spmv`` kernels; right for hyper-sparse
social graphs) and the BSR format (dense ``ts × td`` tiles, the ``bsr_spmv``
kernel; wins on clustered operators with decent tile occupancy). The
planner makes the choice per graph:

1. **Measured-occupancy cost model** (default). One O(M) ``bincount`` /
   ``unique`` pass per candidate parameterization estimates the bytes a
   single Power-ψ step moves under each regime:

     * edge-tile:  per block, two i32 index planes plus the gathered source
       floats (``12 B/slot``), padded to ``ceil(cnt_t / eblk)`` blocks per
       node tile, plus the 4 node-vector streams per output tile.
     * BSR:        every materialized block streams its dense ``ts·td``
       f32 tile (``4 B / slot``), plus the output/epilogue vectors per dst
       tile.

   The constants and the candidate shapes are the JAX package's, unchanged,
   so a model-only plan is the same in both packages (label and
   ``est_bytes``). They were set for a TPU; deriving them for Hopper and
   the dtype in use is later work, from the card's measured candidate
   table.

2. **One-shot micro-benchmark** (``microbench=True``). Builds *every*
   candidate of both regimes, times its bare push kernel (``edge_spmv_call``
   for an edge-tile candidate, ``bsr_spmv_call`` for a BSR one) and picks
   the measured winner. On the card: three launches to warm up, then three
   runs of 50 back-to-back launches, each run between one pair of CUDA
   events queued behind a spin kernel (``torch.cuda._sleep``) long enough
   for the host to queue the whole run first, so the events time the
   kernels and not Python's issue of them; the least time a launch over
   the runs. A run the host did not queue in time is not used; its spin is
   doubled, and planning raises when eight runs bring no covered one. On
   the CPU: ``perf_counter`` around three calls of the plain
   versions, the median.

Plans are memoized in a process-level cache keyed by a *structural*
fingerprint of the graph (node/edge counts plus a strided edge sample), the
candidate space and, when a device is involved (microbench or calibration),
the device and dtype — activity patches never touch the key, so
``patch_activity`` / warm re-``prepare`` cycles never re-plan.

:func:`plan_for_bucket` plans one *fleet bucket*: the edge-tile candidates
only (the fleet stacks edge-tile formats along a lane axis), scored on the
triggering member re-padded to the bucket's node capacity and memoized
under the bucket's shape (:func:`bucket_fingerprint`), so every same-bucket
tenant shares one plan.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from ..obs import calibrate as obs_calibrate
from ..obs import explain as obs_explain
from ..obs import log as obs_log
from ..obs import metrics as obs_metrics
from .formats import build_bsr, build_edge_tiles

__all__ = ["RegimePlan", "PlanCache", "PLAN_CACHE", "graph_fingerprint",
           "bucket_fingerprint", "estimate_edge_tile_cost",
           "estimate_bsr_cost", "bsr_occupancy", "plan_regime",
           "plan_for_bucket", "SolverChoice", "choose_solver"]


# Default candidate spaces (the JAX package's). Lane dims stay multiples of
# 128; the sublane/edge-block dims trade padding waste against per-block
# overhead.
EDGE_TILE_CANDIDATES: tuple[tuple[int, int, int], ...] = (
    (256, 8, 128),            # (tile, e1, e2) — the historical default
    (128, 8, 128),
    (512, 8, 128),
)
BSR_CANDIDATES: tuple[tuple[int, int], ...] = (
    (128, 128),               # (ts, td)
    (128, 256),
)

# Rough per-slot traffic in bytes (see module docstring). Absolute values
# only matter relative to each other; microbench overrides both.
_EDGE_SLOT_BYTES = 12.0       # 2 × i32 index + 1 × f32 gather per edge slot
_BSR_SLOT_BYTES = 4.0         # f32 tile value per slot
_NODE_STREAM_BYTES = 16.0     # mu, c, s_old, s_new per output element

# BSR candidates whose tiles would be emptier than this are pruned *before*
# scoring or microbenching: on a hyper-sparse graph a 128×128 tile holding a
# handful of edges makes the format build and the timed step orders of
# magnitude slower than the edge-tile path, and the model already knows the
# regime cannot win.
BSR_MIN_OCCUPANCY = 0.02


@dataclasses.dataclass(frozen=True)
class RegimePlan:
    """A resolved execution plan for ``CudaEngine``."""

    regime: str               # "edge_tile" | "bsr"
    tile: int = 256           # edge-tile params (used when regime=edge_tile)
    e1: int = 8
    e2: int = 128
    ts: int = 128             # BSR params (used when regime=bsr)
    td: int = 128
    est_bytes: float = 0.0    # modeled bytes per step for the winner
    measured_us: float = 0.0  # microbenchmark result (0 when model-only)
    # what ranked the winner: "model" (raw est_bytes), "microbench"
    # (measured µs), or "calibrated" (est_bytes × learned factors)
    source: str = "model"

    def params(self) -> dict:
        if self.regime == "edge_tile":
            return dict(tile=self.tile, e1=self.e1, e2=self.e2)
        return dict(ts=self.ts, td=self.td)

    def label(self) -> str:
        kv = ",".join(f"{k}={v}" for k, v in self.params().items())
        return f"{self.regime}({kv})"


# --------------------------------------------------------------------- #
# Cost model — one O(M) pass per candidate, no format materialization
# --------------------------------------------------------------------- #
def estimate_edge_tile_cost(graph: Graph, *, tile: int, e1: int, e2: int,
                            slot_bytes: float = _EDGE_SLOT_BYTES,
                            node_bytes: float = _NODE_STREAM_BYTES) -> float:
    """Modeled bytes per fused step under the edge-tile regime."""
    eblk = e1 * e2
    num_tiles = max(1, -(-graph.n // tile))
    _, dst = graph.edges_by_dst
    counts = np.bincount(dst // tile, minlength=num_tiles)
    blocks = np.maximum(1, -(-counts // eblk))
    padded_slots = float(blocks.sum()) * eblk
    return padded_slots * slot_bytes + num_tiles * tile * node_bytes


def _bsr_blocks(graph: Graph, ts: int, td: int) -> int:
    """Materialized BSR block count (nonempty + explicit zero dst covers)."""
    nst = max(1, -(-graph.n // ts))
    ndt = max(1, -(-graph.n // td))
    src, dst = graph.edges_by_dst
    key = (dst // td).astype(np.int64) * nst + src // ts
    nonempty = np.unique(key).size if key.size else 0
    # uncovered dst tiles get an explicit zero block (see build_bsr)
    covered = np.unique(dst // td).size if dst.size else 0
    return max(1, nonempty + (ndt - covered))


def bsr_occupancy(graph: Graph, *, ts: int, td: int) -> float:
    """Edges per materialized block slot — ``m / (num_blocks·ts·td)``.

    Matches ``build_bsr(graph).occupancy`` without materializing the format.
    """
    return graph.m / (_bsr_blocks(graph, ts, td) * ts * td)


def estimate_bsr_cost(graph: Graph, *, ts: int, td: int,
                      slot_bytes: float = _BSR_SLOT_BYTES,
                      node_bytes: float = _NODE_STREAM_BYTES) -> float:
    """Modeled bytes per step under the BSR regime."""
    ndt = max(1, -(-graph.n // td))
    return float(_bsr_blocks(graph, ts, td)) * ts * td * slot_bytes + \
        ndt * td * node_bytes


# --------------------------------------------------------------------- #
# Plan cache — structural fingerprint, stable under activity patches
# --------------------------------------------------------------------- #
def graph_fingerprint(graph: Graph, *, sample: int = 64) -> tuple:
    """Cheap structural key: (n, m) plus a strided edge sample.

    Activity rates are deliberately absent — the regime choice depends only
    on sparsity structure, so ``patch_activity`` (and warm re-``prepare``
    with the same graph) hits the cache. A fingerprint collision can only
    yield a valid-but-suboptimal plan, never a wrong answer.
    """
    src, dst = graph.edges_by_dst
    stride = max(1, graph.m // sample)
    return (graph.n, graph.m, tuple(np.asarray(src[::stride]).tolist()),
            tuple(np.asarray(dst[::stride]).tolist()))


def bucket_fingerprint(n_pad: int, e_pad: int, *, extra: tuple = ()) -> tuple:
    """Cache key for a fleet *bucket*: the padded shape, not any one graph.

    Every tenant admitted into the same ``(n_pad, e_pad)`` bucket shares
    one batched solver, so they share one plan too — the key deliberately
    ignores which member graph happened to trigger planning.
    """
    return ("bucket", int(n_pad), int(e_pad)) + extra


class PlanCache:
    """Process-level memo of :func:`plan_regime` results with hit stats.

    Every lookup/store also feeds the obs registry
    (``psi_plan_cache_{hits,misses}_total``; the process-level default
    cache additionally publishes ``psi_plan_cache_size``).
    """

    def __init__(self):
        self._plans: dict[tuple, RegimePlan] = {}
        self.hits = 0
        self.misses = 0

    def _size_gauge(self) -> None:
        # only the shared process cache owns the gauge
        if self is globals().get("PLAN_CACHE"):
            obs_metrics.gauge("psi_plan_cache_size",
                              "memoized plans in the process plan cache") \
                .set(float(len(self._plans)))

    def lookup(self, key: tuple) -> RegimePlan | None:
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            obs_metrics.counter("psi_plan_cache_hits_total",
                                "autotune plan-cache hits").inc()
        return plan

    def store(self, key: tuple, plan: RegimePlan) -> None:
        self.misses += 1
        obs_metrics.counter("psi_plan_cache_misses_total",
                            "autotune plan-cache misses").inc()
        self._plans[key] = plan
        self._size_gauge()

    def clear(self) -> None:
        self._plans.clear()
        self.hits = self.misses = 0
        self._size_gauge()

    def __len__(self) -> int:
        return len(self._plans)


PLAN_CACHE = PlanCache()


# --------------------------------------------------------------------- #
# The planner
# --------------------------------------------------------------------- #
# The microbench on the card (see the module docstring). A kernel of these
# sizes runs 0.01-0.05 ms, less than Python takes to issue its launch, so
# launches timed one by one, or back to back with the card waiting on the
# host, time the issue. The spin kernel in front of each run lasts at least
# twice the run's issue time (from the warm-up's host clock) plus 1 ms,
# counted at 2e6 cycles a ms, above an H100's top SM clock. A run whose
# start event had already passed when its last launch was queued timed the
# host: it is not used, and the spin is doubled for the next run. The
# microbench takes the least of _MB_RUNS covered runs, makes at most
# _MB_MAX_RUNS runs, and raises when none of them was covered.
_MB_WARMUP = 3
_MB_LAUNCHES = 50
_MB_RUNS = 3
_MB_MAX_RUNS = 8
_SPIN_CYCLES_PER_MS = 2_000_000


def _least_covered(run, spin_ms: float) -> float:
    """The least time of up to ``_MB_RUNS`` covered runs. ``run(spin_ms)``
    makes one run behind a spin of ``spin_ms`` and returns ``(covered,
    µs per launch)``; an exposed run doubles the spin. Raises
    ``RuntimeError`` when ``_MB_MAX_RUNS`` runs bring no covered one."""
    covered = []
    for _ in range(_MB_MAX_RUNS):
        queued, us = run(spin_ms)
        if queued:
            covered.append(us)
            if len(covered) == _MB_RUNS:
                break
        else:
            spin_ms *= 2
    if not covered:
        raise RuntimeError(
            f"microbench: the host could not queue {_MB_LAUNCHES} launches "
            f"ahead of the card in {_MB_MAX_RUNS} runs (last spin "
            f"{spin_ms / 2:.1f} ms); every time measured the host's issue")
    return min(covered)


def _device_us_per_launch(step, device: torch.device) -> float:
    """Least device time of one ``step()`` in µs (the card's protocol of
    the module docstring)."""
    for i in range(_MB_WARMUP):
        if i == 1:
            t0 = time.perf_counter()
        step()
    spin_ms = 2e3 * _MB_LAUNCHES * (time.perf_counter() - t0) / (
        _MB_WARMUP - 1) + 1.0

    def run(spin_ms: float) -> tuple[bool, float]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(_MB_LAUNCHES):
            step()
        end.record()
        queued = not start.query()           # the card still spinning
        end.synchronize()
        return queued, start.elapsed_time(end) * 1e3 / _MB_LAUNCHES

    with torch.cuda.device(device):
        return _least_covered(run, spin_ms)


def _microbench_step(graph: Graph, plan: RegimePlan, dtype: torch.dtype,
                     device: torch.device) -> float:
    """Time (µs) of one bare push launch under ``plan``: on the card the
    least device time a launch (:func:`_device_us_per_launch`), on the CPU
    the median host time of three plain calls after one to warm up."""
    from .bsr_spmv import bsr_spmv_call
    from .edge_spmv import edge_spmv_call
    from .ops import DeviceBsr, DeviceEdgeTiles

    s = torch.as_tensor(np.random.default_rng(0).random(graph.n),
                        dtype=dtype, device=device)
    if plan.regime == "edge_tile":
        fmt = DeviceEdgeTiles.from_format(
            build_edge_tiles(graph, tile=plan.tile, e1=plan.e1, e2=plan.e2),
            device)
        s_pre = fmt.pad_gather_source(s)

        def step():
            return edge_spmv_call(s_pre, fmt.src_idx, fmt.dst_local,
                                  fmt.block_tile, fmt.tile_first_block,
                                  fmt.tile_num_blocks, n=fmt.n,
                                  tile=fmt.tile, tile_order=fmt.tile_order)
    else:
        fmt = DeviceBsr.from_format(
            build_bsr(graph, ts=plan.ts, td=plan.td,
                      dtype=numpy_dtype(dtype)), device)
        s_pre = fmt.pad_source(s)

        def step():
            return bsr_spmv_call(s_pre, fmt.tiles, fmt.src_tile,
                                 fmt.dst_tile, fmt.dst_first_block,
                                 fmt.dst_num_blocks,
                                 num_dst_tiles=fmt.num_dst_tiles)
    if device.type == "cuda":
        return _device_us_per_launch(step, device)
    step()                                             # warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


_USE_GLOBAL = object()        # sentinel: "the process calibration store"


def _misrank(site: str, model_winner: RegimePlan, best: RegimePlan,
             ratio: float, basis: str) -> None:
    """Count one modeled-winner ≠ measured-winner disagreement."""
    obs_metrics.gauge(
        "psi_plan_misprediction_ratio",
        "cost of the raw-model winner over the true winner "
        "(1.0 = model ranked correctly)").set(float(ratio))
    if model_winner.regime != best.regime or \
            model_winner.params() != best.params():
        obs_log.event("model_misranked",
                      f"{site}: model picked {model_winner.label()} but "
                      f"{basis} favors {best.label()} ({ratio:.2f}× dearer)",
                      level="warning", site=site, basis=basis,
                      model_winner=model_winner.label(),
                      winner=best.label(), ratio=float(ratio))


def plan_regime(graph: Graph, *, microbench: bool = False,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                edge_tile_candidates=EDGE_TILE_CANDIDATES,
                bsr_candidates=BSR_CANDIDATES,
                cache: PlanCache | None = PLAN_CACHE,
                calibration=_USE_GLOBAL,
                slot_bytes: tuple | None = None,
                _ctx: dict | None = None) -> RegimePlan:
    """Choose edge-tile vs BSR (and their parameters) for ``graph``.

    The model pass scores every candidate of both regimes; with
    ``microbench=True`` every candidate is then timed on ``device`` at
    ``dtype`` and the measured winner is returned. Model-only picks consult
    the :mod:`repro_torch.obs.calibrate` store under the key of ``device``
    and ``dtype``: confident per-regime correction factors turn
    ``est_bytes`` into calibrated µs before ranking (``calibration=None``
    opts out; pass a store to use a private one). ``slot_bytes=(edge, bsr,
    node)`` overrides the model constants. Results are memoized in
    ``cache`` (``cache=None`` bypasses); the key includes the calibration
    generation so a material recalibration replans.

    ``device`` is resolved (and, as everywhere in the port, ``"cuda"``
    raises without a card) only when the plan needs one: to microbench or
    to read the calibration store. A model-only plan with
    ``calibration=None`` touches no device.

    Every call records a :class:`repro_torch.obs.explain.DecisionRecord`
    with the full candidate table, the density-gate prunes and the cache
    state (``_ctx`` lets :func:`plan_for_bucket` record its own kind, site,
    inputs and cache state).
    """
    ctx = _ctx or {}
    kind = ctx.get("kind", "regime_plan")
    site = ctx.get("site", "plan_regime")
    inputs = dict(n=graph.n, m=graph.m, microbench=bool(microbench))
    inputs.update(ctx.get("inputs", ()))
    cal = obs_calibrate.get_store() if calibration is _USE_GLOBAL \
        else calibration
    eb, bb, nb = slot_bytes or (_EDGE_SLOT_BYTES, _BSR_SLOT_BYTES,
                                _NODE_STREAM_BYTES)
    dev = env = None
    if microbench or cal is not None:
        dev = resolve_device(device)
        env = obs_calibrate.env_key(dev, dtype)

    # The calibration key component exists so a *material* recalibration
    # replans — but only when the store can actually change a ranking:
    # with no confident factors (or one uniform default) the multipliers
    # scale every candidate equally.
    cal_sig = None
    if cal is not None:
        m0 = cal.multipliers({"edge_tile", "bsr"}, env=env)
        if len(set(m0.values())) > 1:
            cal_sig = cal.generation

    key = None
    if cache is not None:
        key = graph_fingerprint(graph) + (
            bool(microbench), tuple(edge_tile_candidates),
            tuple(bsr_candidates), cal_sig, slot_bytes, env)
        hit = cache.lookup(key)
        if hit is not None:
            obs_explain.record_decision(
                kind, site, inputs=inputs, cache="hit",
                chosen=hit.label(), source=hit.source,
                candidates=[obs_explain.Candidate(
                    hit.label(), est=hit.est_bytes,
                    measured_us=hit.measured_us, chosen=True)])
            return hit

    # Density gate: drop BSR parameterizations whose tiles would stream
    # mostly zero-fill. Deterministic (structure-only), so it is safe under
    # the cache key above.
    dense_bsr, pruned = [], []
    for ts, td in bsr_candidates:
        occ = bsr_occupancy(graph, ts=ts, td=td)
        if occ >= BSR_MIN_OCCUPANCY:
            dense_bsr.append((ts, td))
        else:
            pruned.append(obs_explain.Pruned(
                f"bsr(ts={ts},td={td})", "BSR_MIN_OCCUPANCY",
                detail=dict(occupancy=round(occ, 6),
                            floor=BSR_MIN_OCCUPANCY)))

    candidates = [
        RegimePlan(regime="edge_tile", tile=t, e1=a, e2=b,
                   est_bytes=estimate_edge_tile_cost(
                       graph, tile=t, e1=a, e2=b,
                       slot_bytes=eb, node_bytes=nb))
        for t, a, b in edge_tile_candidates
    ] + [
        RegimePlan(regime="bsr", ts=ts, td=td,
                   est_bytes=estimate_bsr_cost(graph, ts=ts, td=td,
                                               slot_bytes=bb, node_bytes=nb))
        for ts, td in dense_bsr
    ]
    model_winner = min(candidates, key=lambda p: p.est_bytes)

    mults = cal.multipliers({p.regime for p in candidates}, env=env) \
        if cal is not None else {}
    cal_info = None
    calibrated_us: dict[int, float] = {}

    if microbench:
        # measured ground truth: each candidate's push timed — the model
        # only breaks exact ties
        candidates = [dataclasses.replace(
            p, measured_us=_microbench_step(graph, p, dtype, dev),
            source="microbench") for p in candidates]
        if cal is not None:
            for p in candidates:      # feed the loop-closing store
                cal.observe(p.regime, p.est_bytes, p.measured_us, env=env,
                            source="microbench")
        plan = min(candidates, key=lambda p: (p.measured_us, p.est_bytes))
        mw = min(candidates,          # the raw model's pick, now timed
                 key=lambda p: p.est_bytes)
        _misrank(site, mw, plan, mw.measured_us / max(plan.measured_us,
                                                      1e-12),
                 basis="microbench")
    elif len(set(mults.get(p.regime, 1.0) for p in candidates)) > 1:
        # distinct confident factors: rank by calibrated µs, not raw bytes
        calibrated_us = {i: p.est_bytes * mults[p.regime]
                         for i, p in enumerate(candidates)}
        best_i = min(calibrated_us, key=calibrated_us.get)
        plan = dataclasses.replace(candidates[best_i], source="calibrated")
        cal_info = dict(env=env, generation=cal.generation,
                        factors=cal.factors(env=env))
        mw_us = model_winner.est_bytes * mults[model_winner.regime]
        _misrank(site, model_winner, plan,
                 mw_us / max(calibrated_us[best_i], 1e-12),
                 basis="calibration")
    else:
        plan = model_winner

    obs_explain.record_decision(
        kind, site, inputs=inputs,
        cache="miss" if cache is not None else ctx.get("cache", "bypass"),
        chosen=plan.label(), source=plan.source, calibration=cal_info,
        candidates=[obs_explain.Candidate(
            p.label(), est=p.est_bytes, measured_us=p.measured_us,
            calibrated_us=calibrated_us.get(i),
            chosen=(p.regime == plan.regime
                    and p.params() == plan.params()))
            for i, p in enumerate(candidates)],
        pruned=pruned)

    if cache is not None:
        cache.store(key, plan)
    return plan


def plan_for_bucket(graph: Graph, *, n_pad: int, e_pad: int,
                    microbench: bool = False,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda",
                    edge_tile_candidates=EDGE_TILE_CANDIDATES,
                    cache: PlanCache | None = PLAN_CACHE,
                    calibration=_USE_GLOBAL) -> RegimePlan:
    """Plan the edge-tile parameters for one fleet bucket shape.

    ``graph`` is the member that triggered planning; it is re-padded to the
    bucket's node capacity so the plan reflects the shapes the batched
    solver runs. The result is memoized under :func:`bucket_fingerprint`
    (with the device and dtype when the microbench times it) — every
    same-bucket tenant, current and future, reuses this one plan. Only
    edge-tile candidates are scored: the fleet stacks edge-tile formats
    along a lane axis, and BSR's per-graph block table does not stack. A
    model-only plan is the JAX package's, bit for bit; ``microbench=True``
    times each candidate's bare ``edge_spmv`` launch on ``device`` (one
    lane), as :func:`plan_regime` does.
    """
    key = None
    if cache is not None:
        extra = (bool(microbench), tuple(edge_tile_candidates))
        if microbench:
            extra += (obs_calibrate.env_key(resolve_device(device), dtype),)
        key = bucket_fingerprint(n_pad, e_pad, extra=extra)
        hit = cache.lookup(key)
        if hit is not None:
            obs_explain.record_decision(
                "bucket_plan", "plan_for_bucket",
                inputs=dict(n=graph.n, m=graph.m, n_pad=int(n_pad),
                            e_pad=int(e_pad)),
                cache="hit", chosen=hit.label(), source=hit.source,
                candidates=[obs_explain.Candidate(
                    hit.label(), est=hit.est_bytes,
                    measured_us=hit.measured_us, chosen=True)])
            return hit
    padded = Graph(int(n_pad), graph.src, graph.dst,
                   name=f"{graph.name}@bucket{n_pad}")
    plan = plan_regime(padded, microbench=microbench, dtype=dtype,
                       device=device,
                       edge_tile_candidates=edge_tile_candidates,
                       bsr_candidates=(), cache=None,
                       calibration=calibration,
                       _ctx=dict(kind="bucket_plan", site="plan_for_bucket",
                                 cache="miss" if cache is not None
                                 else "bypass",
                                 inputs=dict(n_pad=int(n_pad),
                                             e_pad=int(e_pad))))
    if cache is not None:
        cache.store(key, plan)
    return plan


# --------------------------------------------------------------------- #
# Solver-level choice: local residual push vs global sweep
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SolverChoice:
    """Which *solver* (not kernel format) a query should pay for.

    A global Power-ψ sweep moves every edge every iteration — O(sweeps·m)
    regardless of how little actually changed. A residual-push solver only
    moves the frontier's out-edges, which wins when the dirty set is small
    and the query only needs a certified top-k, and loses once the frontier
    saturates the graph.
    """

    solver: str               # "push" | "global"
    push_edges: float         # modeled push edge-work for the query
    global_edges: float       # modeled global edge-work (sweeps · m)
    dirty_frac: float
    k_frac: float


def choose_solver(graph: Graph, *, dirty_frac: float, k_frac: float = 1.0,
                  sweeps: int = 50) -> SolverChoice:
    """Model whether local push beats a global sweep for this query.

    Frontier-growth model: a warm push starts from ``dirty_frac·n`` seed
    nodes and each round the frontier grows by the mean out-degree
    ``m/n``, saturating at ``n``. Rounds-to-target scales with how much of
    the vector the query needs: a certified top-k with ``k ≪ n`` stops as
    soon as the k-th margin clears the certificate, modeled as
    ``sweeps·(0.25 + 0.75·k_frac)`` rounds. Each frontier node costs its
    mean out-degree in edge work.

    The model is deliberately coarse — it only has to rank two solvers
    whose costs differ by orders of magnitude in the regimes that matter
    (0.1% dirty vs 100% dirty), not predict wall time.
    """
    if not 0.0 <= dirty_frac <= 1.0:
        raise ValueError(f"dirty_frac must be in [0, 1]; got {dirty_frac}")
    if not 0.0 < k_frac <= 1.0:
        raise ValueError(f"k_frac must be in (0, 1]; got {k_frac}")
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1; got {sweeps}")
    n = max(1, graph.n)
    deg = graph.m / n                       # mean out-degree = fan-out rate
    rounds = max(1, int(sweeps * (0.25 + 0.75 * k_frac)))
    frontier = max(1.0, dirty_frac * n)
    push_edges = 0.0
    for _ in range(rounds):
        push_edges += frontier * deg
        frontier = min(float(n), frontier * max(1.0, deg))
    global_edges = float(sweeps) * graph.m
    solver = "push" if push_edges < global_edges else "global"
    obs_explain.record_decision(
        "solver_choice", "choose_solver",
        inputs=dict(n=graph.n, m=graph.m, dirty_frac=float(dirty_frac),
                    k_frac=float(k_frac), sweeps=int(sweeps),
                    rounds=rounds),
        chosen=solver, source="model",
        candidates=[
            obs_explain.Candidate("push", est=push_edges, unit="edges",
                                  chosen=solver == "push",
                                  detail=dict(rounds=rounds)),
            obs_explain.Candidate("global", est=global_edges, unit="edges",
                                  chosen=solver == "global",
                                  detail=dict(sweeps=int(sweeps))),
        ])
    return SolverChoice(solver=solver, push_edges=push_edges,
                        global_edges=global_edges,
                        dirty_frac=float(dirty_frac),
                        k_frac=float(k_frac))
