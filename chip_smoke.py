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
   the kernel's slot order; ``edge_spmv`` must match to the last bit), at
   float32 and float64, at the main path's shapes, at every shape the
   autotuner may pick or time (edge tiles 128, 256, 512; BSR ``td`` 128 and
   256), on ragged and padded cases, on edge-tile slots shuffled within
   each tile, on a ``cuda`` engine's format after ``patch_edges`` and on a
   hub node of more than two blocks of in-edges, and twice on the same
   inputs (outputs must be bitwise equal); ``bsr_spmv`` on one-byte tiles
   also bitwise against the same tiles in the working dtype, and the fused
   ``bsr_step`` bitwise against the composition it replaces (``s_new``;
   the gap within GAP_RTOL);
3. the serving path in the ``edge_tile`` regime: ``PsiService`` on the
   twitter stand-in with ``backend="cuda"`` through a cold solve, ranked
   requests, an activity update, an edge insert into free sentinel slots
   and an edge removal, each fixed point held against the ``reference``
   backend at float64 on the card;
4. the same in the ``bsr`` regime on a clustered graph (one ``bsr_step``
   launch a step, one-byte tiles), with an edge insert into an existing
   dense tile;
5. ``backend="auto"`` on both graphs: a cold solve and a warm activity
   update, first with the cost model's plan (which must equal the plan
   computed on the host), then with ``microbench=True`` (every candidate's
   push kernel timed on the card; the candidate table is printed), each
   fixed point at gap 0 and held against the float64 reference; before it,
   the clustered graph planned with the microbench three times, every
   candidate's µs printed each time: the pick must not change (or the
   candidates must tie within 3%);
6. ``accelerate=True`` on the ``cuda`` backend at float64 on the twitter
   stand-in: the same ψ as the reference in fewer mat-vecs than the plain
   loop;
7. ``gnn_train``: ``repro_torch.launch.train --arch graphsage-reddit --shape
   minibatch_lg --steps 10`` (the full-width cell, a fresh fanout-sampled
   minibatch of the synthetic Reddit graph each step, every loss finite),
   then 10 steps on one fixed minibatch (the loss must fall), then one
   full-width step (loss and every gradient) on the card at float32 through
   ``seg_mm`` held against the same step at float64 on CPU copies through
   the plain version;
8. ``fleet``: the ``serve --tenants`` path, ``TenantFleet(backend="auto")``
   on the card with 14 tenants — four seeds each of the paper's Table II
   stand-ins dblp, hepph and facebook at their published sizes, and the
   launcher's two small tenants — in five buckets (four in the kernel
   regime, one dense). A cold f32 solve at tol 1e-8; every kernel lane held
   bitwise (s, ψ, count) against the single-lane kernel loop on its own
   tensors, against the solo ``cuda`` engine (inputs compared bit for bit
   first) and against the f64 reference (top-10, rel L1 ≤ 1e-5); ranked
   requests through the frontier; an activity patch (warm, co-tenants
   bitwise); an edge patch that grows a facebook tenant past its bucket's
   block capacity (restack, warm, then the bucket cold and every lane held
   again). ``power_step_lanes`` must launch once a step per kernel bucket,
   ``edge_spmv_lanes`` once per kernel bucket solved;
9. times: CUDA events around back-to-back calls, warm, for each kernel,
   its plain version and one PyTorch sparse call for the same push or sum,
   beside the kernel's bound, and the device time (``torch.profiler``) of
   the kernel and the library call; ``bsr_spmv`` also once after an L2
   flush (its one-byte tiles fit the L2) and beside the floors of f32
   tiles and of the nonzeros; ``bsr_step`` beside the six-launch
   composition it replaced; ``seg_mm``'s bound counts the real message
   rows, the padded count printed beside it, and its device time at other
   aggregation tiles; the edge-tile kernels at every
   autotuner tile and, in device time, with every tile's slots dealt in
   order over its rows (the tail of the in-degree skew); the cold resolves
   and the GraphSAGE step under the profiler; the lane-batched kernels
   against their plain versions at every kernel bucket (f32, f64), each
   bucket's cold solve, and the lane-batched kernels at the facebook bucket
   beside as many single-lane launches, their bound, the plain version and
   a block-diagonal ``torch.sparse.mm``.

Seven more main paths run after the fleet, before the times:

* ``paper``: the paper's comparison (Exp. 1-2) on the DBLP stand-in at
  float64: Power-ψ through the ``cuda`` engine (``power_step``), Power-NF
  (``power_nf``, one chunk loop a 256-origin chunk on the card) over
  exp2's 256 origins at tols 1e-1 ... 1e-9 and over all 12,591 origins at
  1e-9 (twice: the same bits), PageRank against homogeneous ψ. Every count
  must equal ``PAPER_ITERS`` (the JAX package's), full-N Power-NF and
  Power-ψ within 1e-6 rel L2 of ``exact_psi``; each solver's wall and
  device time at tol 1e-9 are printed.
* ``push``: the certified residual-push backend (``PsiService(backend=
  "push")`` and ``frontier="jit"`` rounds on the card) on the DBLP stand-in:
  certified top-10 reads equal the exact top-10 cold and after an activity
  patch (which touches fewer users), the certificate bounds the true
  error, an edge patch rebuilds the frontier table, and the device rounds
  repeat bit for bit. No TPU kernel lies on this path.

* ``stream``: the ``serve --stream`` path. (a) A cold float64 ``cuda``
  ``PsiService`` on the twitter stand-in (every rate at ``RATE_FLOOR``)
  fed a flash crowd of ~100k events (posts, reposts, 96 follows of the
  max in-degree user, 29 unfollows) through a ``StreamIngestor``
  (coalesce 64, a resolve every 1,000 events), then 200 read rounds: the
  event, resolve and ``engine.run`` counts must agree, the edge count
  must be the start plus the follows minus the unfollows, ψ within 1e-6
  rel L1 of a from-scratch f64 ``reference`` (top-10 identical), the
  per-resolve iterations equal ``STREAM_ITERS`` and ``obs.dump`` parse
  back; the first 10,000 events replayed on two fresh services give the
  same bits. It prints ev/s, flush and resolve ms, the busy share of a
  warm resolve, read p50/p99 by op from ``psi_query_seconds``, and the
  re-prepares and format rebuilds. (b) Four dblp tenants in a
  ``TenantFleet(backend="auto")`` at f32 fed an interleaved burst log
  (80k events): events by tenant add up, each lane's ψ within 1e-5 rel L1
  of a solo f64 reference (top-10 identical).

* ``driver``: the ``serve --executor sync|async`` path on the twitter
  stand-in (uncut, ``heterogeneous(n, seed=6)``), on a world-1 mesh over
  NCCL (two ranks cannot share one card under NCCL; the multi-rank
  schedule is held on the CPU by the gloo tests). Sync: ``PsiDriver``
  (16 iterations a chunk, a checkpoint a chunk) at f64 / tol 1e-9 with the
  JAX package's counts (``DRIVER_ITERS``, from
  ``tools/driver_iters_reference.py``), at f32 / tol 1e-7, then restarted
  from its checkpoints at chunks 1 and 3 (ψ bitwise the clean run), and
  ``PsiService(backend="distributed")`` through an activity patch and a
  block-local edge insert. Async: ``AsyncPsiDriver(num_chunks=4)`` at τ = 0
  / f64 with the JAX package's epochs and chunk steps, at τ = 2 with a
  straggler on chunk 1 (max_staleness ≤ τ + 1, overlap printed), a
  checkpoint restart and a warm ``rechunk(6)`` that needs fewer epochs
  than a cold run; a ``StreamIngestor`` on the async driver (~10k burst
  events); then ``serve --executor sync`` and ``--executor async`` as
  subprocesses (exit 0). Every ψ is held against the f64 ``reference``
  engine on the card (top-10 identical, rel L1 ≤ 1e-5); it prints each
  part's host ms, a chunk's ms and the busy share of one sync solve. No
  kernel of the port runs on it.

* ``chaos``: the ``serve --chaos --slo --watch --profile-out`` path. (a)
  The JAX package's f64 chaos gate (``run_chaos(n=200, m=1200,
  horizon=3)``) on the card's ``AsyncPsiDriver`` stack: max|Δψ| ≤ 1e-12
  against the fault-free run after crashes, forced-stale reads, a torn
  stack checkpoint, a NaN patch, a duplicated/reordered/dropped feed,
  recovery and an exactly-once replay; every fault class injected, none
  unsurvived. (b) The same gate at the twitter stand-in's size
  (``CHAOS_SIZE``, run_chaos's own graph), its horizon cut to about
  ``CHAOS_EVENTS`` events, solved to ``CHAOS_SOLVER_TOL``; the oracle and
  chaos walls, restarts, overhead, MTTR and the ladder's derived deadline
  printed. (c) ``ServiceGuard`` over a float32 ``cuda`` service on the
  twitter stand-in: a NaN patch rejected, an α patch rolled back to ψ bit
  for bit a cold solve with the checkpointed rates. (d) ``LaneQuarantine``
  over the fleet phase's fleet: a NaN- and an α-poisoned tenant frozen,
  every other lane bitwise a deep copy of the fleet without the
  quarantine. (e) The CLI drill and ``obs.check --device cuda`` as
  subprocesses (exit 0; the watch's pre-emption, an SLO verdict, a
  folded-stacks file).

* ``lm``: the LM family (``train`` and ``serve --arch <lm>``) at full
  width; no kernel of the port runs on it. (a) ``tinyllama-1.1b`` whole:
  ``repro_torch.launch.train --arch tinyllama-1.1b --shape train_4k --steps
  5`` (seq 4,096, batch cut from 256 to 8, 4 microbatches, AdamW; every loss
  finite), 5 steps on one fixed batch (8 × 1,024; the loss must fall), one
  step at f32 against f64 on the card (2 × 256: loss rel ≤ 1e-5, every
  gradient leaf rel L2 ≤ 1e-4) and the bf16 loss against the f32 one (rel ≤
  1e-2). (b) ``tinyllama-1.1b`` whole: ``repro_torch.launch.serve --arch
  tinyllama-1.1b --shape prefill_32k --gen-len 33 --requests 1`` (a bf16
  prefill of 1 × 32,768, batch cut from 32, and 32 greedy decode steps;
  prefill ms, decode ms a token, cache bytes; one more decode step
  profiled); at f32 a
  prefill of 1 × 2,048 and 32 decode steps against ``forward`` (2e-3).
  (c) ``mixtral-8x7b`` at full width, 2 layers: a bf16 prefill of 1 ×
  10,240 (the banded schedule; each expert's dropped tokens printed), 16
  decode steps past the 4,096 window on the rolling cache, the same at f32
  against ``forward`` (2e-3, capacity E/K so nothing drops), one bf16 AdamW
  step at 1 layer (1 × 2,048). (d) ``yi-9b``, ``nemotron-4-340b``,
  ``mixtral-8x22b`` at full width, 1 layer each: a bf16 prefill of 1 × 512
  and one decode step (finite logits, peak memory).

* ``recsys``: MIND (the recsys family) at the JAX config's full width
  (4,194,304 × 64 item table, 131,072 × 64 profile table, 4 interests, 3
  routing iterations, history 50, 8 tags a user, 1,024 negatives), every
  profile bag summed by ``seg_mm``. (a) ``repro_torch.launch.train --arch
  mind --shape train_batch --steps 5`` (65,536 users a step, AdamW; every
  loss finite; the median step by CUDA events, users/s, peak memory, one
  more step under the profiler). (b) One step on the first 4,096 users of
  its last batch at f32 against f64 on the card (loss rel ≤ 1e-5, every
  gradient leaf rel L2 ≤ 1e-4, ``b_init``'s gradient 0). (c) 10 steps on
  that slice at a constant 1e-2: the loss must fall. (d) ``serve --shape
  serve_p99`` and ``serve_bulk`` (512 and 262,144 users): the interests of
  the first 512 users within 1e-5 of f64. (e) ``serve --shape
  retrieval_cand``: 10⁶ candidates scored, held against the max of the
  per-interest products (1e-5), the top-5 against a sort.

Their exact solves (``exact_psi``, a host sparse LU of tens of seconds
each) run in three worker processes from the start of the run, which the
script ends before it exits.

Phase 2 holds ``seg_mm`` against its plain version on CPU copies, bitwise,
at float32 and float64, d = 8, 128, 602, 75, 32, 96 and 160, with and
without the layout's tile spans, on the trainer's format at the
``minibatch_lg`` shape (as built, with padding blocks, with its slots
shuffled within each tile), on a tile with only padding blocks and a tile
with none, and on the ``full_graph_sm`` and ``molecule`` formats at d = 75,
32, 96, 160 and 6,272, and on the recsys path's profile bags (the
``train_batch`` cell's 524,288 ids, sentinel ids, empty bags) at d = 64;
its backward against the plain gather. Phase 9 times the bag sum there
(the gather and ``seg_mm``) beside ``torch.nn.functional.embedding_bag``.

* ``gnn_families`` (after ``gnn_train``): PNA, NequIP and EquiformerV2
  at full width through ``repro_torch.launch.train`` — ``--arch pna
  --shape full_graph_sm --steps 10``, ``--arch nequip --shape molecule
  --steps 10``, ``--arch equiformer-v2 --shape molecule --steps 5`` (every
  loss finite; each arch's loss must fall over 10 steps on its fixed batch
  from a fresh init); one full-width step of each at float32 on the card
  against the same step at float64 on the card, both through ``seg_mm``
  (``GNN_FAMILY_LIMITS``); rotation invariance of NequIP and EquiformerV2
  at full width (max|o₁ − o₂| / max|o₁| ≤ 1e-3 at f32, ≤ 1e-9 at f64);
  ``sharded_sage_apply`` on a world-1 NCCL mesh against ``sage.apply`` on
  full_graph_sm's graph (rel ≤ 1e-5); one ``sgd`` and one ``adafactor``
  update of the EquiformerV2 tree on the card against CPU float64 copies
  (the parameters rel ≤ 1e-6, the step ≤ ``OPT_STEP_REL``); each arch's
  step ms (CUDA events), busy share (profiler), seg_mm launches a step and
  peak memory.

* ``dryrun``: ``repro_torch.launch.dryrun``. (1) The fake-mode
  dry run of every cell on the 16 × 16 and 2 × 16 × 16 meshes (rank 0 of
  a ``fake`` process group, FakeTensors, ``--device cpu``: nothing on the
  card), one CLI process with DRYRUN_WORKERS tracing workers, started as
  the path starts and waited for at its end (no earlier path and no
  timing runs beside it): 84 records, 78 traced ``ok`` with the JAX
  record's keys and 6 skips. (2)
  DRYRUN_REAL on 16 × 16: traced on fake CUDA tensors (``seg_mm``'s
  registered fake), then rank 0's arguments made real on the card and
  one step run (collectives on the fake backend: compute only); the
  measured peak within DRYRUN_MEM_RTOL of the estimate; PNA's
  ``ogb_products`` as rank 0 of its batch split over the 16 data ranks
  (the rank's shard alone built, ``seg_mm`` launched on it). (3) World 1:
  a (1, 1) mesh gives the bits of ``mesh=None`` for a TinyLlama train step
  and a prefill at full width (DRYRUN_BITWISE) and a PNA ``full_graph_sm``
  train step.

Phases 3 to 8, ``gnn_families``, ``paper``, ``push``, ``stream``,
``driver``, ``chaos``, ``lm``, ``recsys`` and ``dryrun``
are the main paths (the auto phase is two: model-only and microbench): every
launch
counter is set to 0 just before each path and read just after, and each
kernel of a path must have launched there. The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
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
# the gap's summation order differ. bsr_spmv and bsr_step are held against
# their plain versions on the card, a batched matmul that sums in another
# order; bsr_step's gap against the unfused composition's within GAP_RTOL.
POWER_TOL = {"float32": (1e-6, 1e-7), "float64": (1e-14, 1e-16)}
GAP_RTOL = {"float32": 1e-4, "float64": 1e-10}
BSR_TOL = {"float32": (2e-5, 2e-6), "float64": (1e-12, 1e-14)}
# seg_mm against its plain version on CPU copies: both add every slot in slot
# order, so they must agree bitwise (tolerance 0). The full-width GraphSAGE
# step at float32 on the card against float64 on the CPU: relative error of
# the loss and relative L2 error of each gradient (float32 rounding, matmul
# and atomic gather-backward sums in another order).
GNN_LOSS_RTOL = 1e-5
GNN_GRAD_REL_L2 = 1e-4
# seg_mm's widths in phase 2: on the GraphSAGE cell's layouts (its own and
# the other families'), and on the families' own formats
SEG_MM_WIDTHS = (8, 128, 602, 75, 32, 96, 160)
SEG_MM_FAMILY_WIDTHS = (75, 32, 96, 160, 6272)
SEG_MM_FAMILY_LAYOUTS = {"full_graph_sm": "pna", "molecule": "equiformer-v2"}
# The gnn_families path: each arch's CLI run (arch, shape, steps), and the
# limits of its full-width f32 step against the same step at f64 on the card
# (loss rel, gradient rel L2 a leaf): GraphSAGE's for PNA; ten times looser
# for the equivariant nets, whose Wigner matrices and CG products round at
# f32 through deep stacks of small matmuls.
GNN_FAMILY_RUNS = (("pna", "full_graph_sm", 10), ("nequip", "molecule", 10),
                   ("equiformer-v2", "molecule", 5))
GNN_FAMILY_LIMITS = {"pna": (1e-5, 1e-4), "nequip": (1e-4, 1e-3),
                     "equiformer-v2": (1e-4, 1e-3)}
# An optimizer update on the card against CPU float64 copies: the updated
# parameters within rel 1e-6 a leaf, and the step itself (new − old) within
# OPT_STEP_REL: both sides compute in float32 (the optimizers' master
# arithmetic), so the step differs by the rounding of reductions over rows
# of up to 1,792 entries summed in another order (1.04e-6 seen for
# adafactor on the card).
OPT_STEP_REL = 1e-5
# the model-only plan the cost model gives both graphs (computed on the
# host in the run as well; the two must agree)
AUTO_MODEL_LABEL = "edge_tile(tile=512,e1=8,e2=128)"
# the iterations of every checked fixed point, in order: edge_tile (cold,
# update_activity, add_edges, remove_edges), bsr (the same four), then
# auto[model] and auto[microbench], each twitter (cold, update) and
# clustered (cold, update). The f32 maps are deterministic, so a count
# moves only with the summation order or the plan: the microbench picks
# bsr(128,128) on the clustered graph, so that pair is the bsr regime's.
FIXED_POINT_ITERS = [33, 13, 23, 25, 44, 24, 23, 22,
                     33, 12, 42, 24, 33, 12, 44, 23]
# then the fleet's lanes (phase_fleet), in order: the cold solve of the 14
# tenants in admission order (dblp 1-4, hepph 1-4, facebook 1-4, powerlaw2000,
# clustered1024), the warm re-solve after the activity patch, the warm
# re-solve after the edge patch, and the restacked facebook bucket cold
FLEET_ITERS = [35, 35, 33, 36, 35, 35, 36, 36, 35, 34, 35, 40, 33, 34,
               23, 25, 35, 34, 35, 35]


# The paper phase (phase_paper): the DBLP stand-in at float64, the setup of
# benchmarks/exp2_matvecs.py. Its counts, in order, from the JAX package at
# float64 on the host (`PYTHONPATH=src python tools/paper_iters_reference.py`):
# for each tol 1e-1 ... 1e-9 the Power-psi mat-vecs, the Power-NF mat-vecs
# and worst per-origin iterations over exp2's 256 origins (heterogeneous
# rates, seed 7); for each tol the homogeneous (0.15, 0.85) Power-psi and
# PageRank (alpha 0.85) mat-vecs; Power-NF over all 12,591 origins at 1e-9
# (mat-vecs, worst iterations).
PAPER_TOLS = [10.0 ** -k for k in range(1, 10)]
PAPER_NF_ORIGINS = 256
PAPER_ITERS = [18, 499, 9, 21, 1027, 12, 25, 1720, 15, 28, 2515, 19,
               31, 3338, 22, 35, 4188, 25, 38, 5059, 29, 41, 5903, 32,
               45, 6785, 36,
               58, 5, 71, 9, 85, 14, 98, 27, 111, 40, 125, 54, 138, 67,
               152, 81, 165, 94,
               330790, 38]
# The push phase's graph and rates (phase_push): the DBLP stand-in, as the
# paper phase, with heterogeneous rates of seed 6. (The hepph stand-in's
# exact solve, a sparse LU of 34,546 unknowns, runs far past this script's
# time budget.)
PUSH_RATE_SEED = 6
# The stream phase (phase_stream): the service part's event count (a flash
# crowd on the twitter stand-in at float64), the events replayed twice for
# the determinism check, the read rounds after the ingest, and the fleet
# part's events a tenant. STREAM_ITERS are the service's per-resolve
# iteration counts in order, from the first card run: the f64 maps sum in a
# fixed order, so the list repeats from call to call.
STREAM_EVENTS = 100_000
STREAM_REPLAY = 10_000
STREAM_READ_ROUNDS = 200
STREAM_FLEET_EVENTS = 20_000
STREAM_ITERS = [41, 32, 33, 32, 33, 33, 33, 33, 33, 33, 34, 33, 35, 34, 33,
                33, 33, 33, 35, 33, 33, 33, 33, 33, 32, 33, 33, 33, 34, 33,
                34, 32, 33, 35, 33, 33, 34, 33, 33, 34, 34, 33, 33, 33, 33,
                34, 34, 33, 33, 34, 34, 33, 33, 33, 33, 33, 33, 33, 33, 33,
                33, 34, 36, 33, 34, 36, 33, 34, 36, 35, 34, 34, 34, 34, 35,
                34, 34, 34, 38, 36, 35, 36, 36, 36, 37, 36, 36, 36, 36, 35,
                36, 36, 37, 37, 37, 36, 39, 36, 36, 36, 35]

# The driver phase (phase_driver): the fault-tolerant executors on the
# twitter stand-in with heterogeneous rates of seed 6. DRIVER_ITERS are the
# JAX package's counts at float64, tol 1e-9 on the raw l1 gap, on the host
# (`PYTHONPATH=src python tools/driver_iters_reference.py`): the sync
# PsiDriver on a (1, 1) mesh at 16 iterations a chunk (iterations, chunks)
# and the AsyncPsiDriver with 4 chunks at tau = 0 (epochs, chunk steps,
# verification sweeps). The f32 runs stop at the CLI's tol 1e-7 and are
# held against the f64 reference engine (top-10 identical, rel L1 ≤ 1e-5).
DRIVER_ITERS = [48, 3, 45, 180, 1]
DRIVER_TOL_F64 = 1e-9
DRIVER_TOL = 1e-7
DRIVER_STREAM_EVENTS = 10_000

# The chaos phase (phase_chaos): the fault classes the gate must inject, and
# part (b)'s size: run_chaos's own powerlaw_configuration at the twitter
# stand-in's nodes and edges, its horizon cut so the log holds about
# CHAOS_EVENTS events (the full horizon's stream would take the ingest far
# past the path's time budget: each coalesced window patches the async
# driver's O(N) node arrays), solved to CHAOS_SOLVER_TOL on the raw l1 gap:
# the JAX gate's f64 tol, which the f64 gap floor at this N lies below (the
# async push sums in a fixed order).
CHAOS_FAULTS = ("crash", "stale_read", "torn_ckpt", "poison", "dup",
                "reorder", "drop", "hang")
CHAOS_SIZE = (465_017, 834_797)
CHAOS_EVENTS = 20_000
CHAOS_SOLVER_TOL = 1e-13

# The lm path (phase_lm). (a) tinyllama-1.1b whole: the trainer CLI at
# train_4k for LM_CLI_STEPS steps; LM_FIXED_STEPS steps on one fixed batch of
# LM_FIXED (batch, seq: the dense schedule, so the profiled step stays small)
# at a constant LM_FIXED_LR (a step moves the bf16 weights by more than half
# an ulp; the reduced trainer's 3e-3 diverges at full width);
# one step at f32 against f64 at LM_F64 (loss rel LM_LOSS_RTOL, each gradient
# leaf rel L2 LM_GRAD_REL_L2: f32 rounding through 22 layers; the f64 step's
# attention scores and logits are f32 too, as in the JAX package) and the bf16
# loss against the f32 one (LM_BF16_LOSS_RTOL: bf16 weights and activations).
# (b) tinyllama-1.1b through the serve CLI at prefill_32k (1 x LM_PREFILL,
# batch cut from 32), LM_DECODE_STEPS decode steps after the prefill's
# token; at f32, prefill of LM_CHECK_PROMPT and
# LM_DECODE_STEPS steps against forward over LM_CHECK_FORWARD tokens within
# LM_LOGIT_TOL (rtol, atol: the JAX test's tests/test_models_lm.py:58-65).
# (c) mixtral-8x7b at 2 layers: prefill of MOE_PREFILL (> 2·(4096 + 512): the
# banded schedule) and MOE_DECODE steps past the window; f32 against forward
# over MOE_FORWARD (a multiple of the 512 q block, as the banded schedule
# needs); one AdamW step at 1 layer, batch 1 x MOE_TRAIN_SEQ. (d) one layer
# each of LM_WIDE_ARCHS at full width: prefill 1 x LM_WIDE_PROMPT, one decode.
LM_CLI_STEPS = 5
LM_FIXED = (8, 1024)
LM_FIXED_STEPS = 5
LM_FIXED_LR = 1e-5
LM_F64 = (2, 256)
LM_LOSS_RTOL = 1e-5
LM_GRAD_REL_L2 = 1e-4
LM_BF16_LOSS_RTOL = 1e-2
LM_LOGIT_TOL = (2e-3, 2e-3)
LM_PREFILL = 32768
LM_DECODE_STEPS = 32
LM_CHECK_PROMPT = 2048
LM_CHECK_FORWARD = 2560
MOE_PREFILL = 10240
MOE_DECODE = 16
MOE_FORWARD = 10752
MOE_TRAIN_SEQ = 2048
LM_WIDE_ARCHS = ("yi-9b", "nemotron-4-340b", "mixtral-8x22b")
LM_WIDE_PROMPT = 512

# The recsys path (phase_recsys), MIND at the JAX config's full width. (a)
# the trainer CLI at train_batch for RECSYS_CLI_STEPS steps; (b) one step on
# the first RECSYS_SLICE users of its last batch at f32 against f64 on the
# card (loss rel RECSYS_LOSS_RTOL, each gradient leaf rel L2
# RECSYS_GRAD_REL_L2: GraphSAGE's limits); (c) RECSYS_FIXED_STEPS steps on
# that slice at a constant RECSYS_FIXED_LR (the loss must fall); (d) the
# serve CLI at serve_p99 and serve_bulk (RECSYS_SERVE_REQUESTS requests
# each), the interests of the first RECSYS_CHECK_USERS users against f64
# within RECSYS_INTEREST_TOL (max abs); (e) retrieval_cand: the scores
# against the max of the per-interest products (RECSYS_SCORE_TOL, rtol and
# atol: the JAX test's) and the top-5 against a sort. Phase 2 holds seg_mm
# bitwise on the profile bags' layout at d = RECSYS_BAG_D (the train_batch
# cell's 65,536 users x 8 tags over the 131,072-row table, one id in
# RECSYS_BAG_SENTINEL_EVERY the sentinel and every RECSYS_BAG_EMPTY_EVERY-th
# user's bag all sentinels); phase 9 times the bag sum on it.
RECSYS_CLI_STEPS = 5
RECSYS_SLICE = 4096
RECSYS_FIXED_STEPS = 10
RECSYS_FIXED_LR = 1e-2
RECSYS_LOSS_RTOL = 1e-5
RECSYS_GRAD_REL_L2 = 1e-4
RECSYS_SERVE_REQUESTS = 5
RECSYS_CHECK_USERS = 512
RECSYS_INTEREST_TOL = 1e-5
RECSYS_SCORE_TOL = 1e-5
RECSYS_BAG_D = 64
RECSYS_BAG_SENTINEL_EVERY = 16
RECSYS_BAG_EMPTY_EVERY = 97
# the dryrun path: the cells run for real as rank 0 of the 16 x 16
# production mesh on the fake backend (PNA's ogb_products: the rank's
# 153,088 nodes and 7,732,480 edges of the split batch), the largest
# allowed gap between the traced memory estimate and the card's peak (a
# share of the measured), the fake-trace CLI's worker processes (the
# host's 8 cores) and its count of records (84: 78 traced, 6 skips)
DRYRUN_REAL = (("tinyllama-1.1b", "train_4k"), ("mixtral-8x7b", "prefill_32k"),
               ("yi-9b", "train_4k"), ("mind", "train_batch"),
               ("psi-score", "twitter_scale"), ("pna", "ogb_products"))
DRYRUN_MEM_RTOL = 0.15
DRYRUN_WORKERS = 8
DRYRUN_RECORDS = (84, 78, 6)
DRYRUN_BITWISE = (2, 2, 512)            # tinyllama layers, batch, seq


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
    """Mean ms per call over ``iters`` back-to-back calls, after warm-up
    (CUDA events): the larger of the device time and the host's time to
    issue a call."""
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


def device_ms(fn, iters: int) -> float:
    """Device time per call in ms, after 3 warm-up calls: the summed
    duration of every kernel and copy that ``iters`` calls of ``fn`` put on
    the card (``torch.profiler``, CUPTI). Host time between launches is not
    counted, so where a wrapper takes longer to issue a call than its kernel
    takes to run, this is below :func:`time_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a second session where the first recorded nothing: CUPTI has
    # returned an empty session on a loaded host
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU)
        if us > 0:
            break
        say("device_ms: the profiler recorded no device time; again")
    check(us > 0, "the profiler saw no device time")
    return us / iters / 1e3


def both_ms(fn, iters: int) -> tuple[float, float]:
    """(:func:`time_ms`, :func:`device_ms`) of ``fn``."""
    return time_ms(fn, iters), device_ms(fn, iters)


def cold_ms(fn, reps: int = 10) -> tuple[float, float]:
    """(min, median) device ms of one call of ``fn`` that finds the L2
    cold: each time 256 MB are read (more than the 50 MB L2; read, so the
    lines they leave are clean), then a spin kernel holds the card while
    the host queues the call, and CUDA events bracket the call alone."""
    import torch
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.sum()
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), float(np.median(times))


# --------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------- #
def edge_tile_inputs(graph, dtype, *, tile=256, pad_blocks=0, seed=0):
    """Everything ``power_step_call`` takes for ``graph``, on the card, with
    a random series vector made from ``seed``."""
    from repro_torch.kernels.formats import (build_edge_tiles,
                                             pad_edge_tile_blocks)
    from repro_torch.kernels.ops import DeviceEdgeTiles
    fmt_h = build_edge_tiles(graph, tile=tile)
    if pad_blocks:
        fmt_h = pad_edge_tile_blocks(fmt_h, fmt_h.num_blocks + pad_blocks)
    fmt = DeviceEdgeTiles.from_format(fmt_h, "cuda")
    return fmt_h, fmt, power_step_args(graph, fmt, dtype, seed)


def power_step_args(graph, fmt, dtype, seed=0):
    """``power_step_call``'s inputs over the device format ``fmt`` of
    ``graph``: the operators of heterogeneous rates (seed + 1) and a random
    series vector (seed)."""
    import torch
    from repro_torch.core import build_operators, heterogeneous
    ops = build_operators(graph, heterogeneous(graph.n, seed=seed + 1),
                          dtype=dtype, device="cuda")
    rng = np.random.default_rng(seed)
    s = torch.as_tensor(rng.uniform(size=graph.n), dtype=dtype, device="cuda")
    return (fmt.pad_gather_source(s * ops.inv_w), fmt.src_idx, fmt.dst_local,
            fmt.block_tile, fmt.tile_first_block, fmt.tile_num_blocks,
            fmt.pad_node_vector(ops.mu), fmt.pad_node_vector(ops.c),
            fmt.pad_node_vector(s))


def edge_tile_variants(twitter, tile) -> dict:
    """Slot layouts beyond the dst-sorted build, each ``name: (graph, device
    format)`` at ``(tile, 8, 128)``: the twitter stand-in's format with its
    slots shuffled within each tile's block range; the format of a ``cuda``
    engine on the twitter stand-in after ``patch_edges`` (64 new edges in
    sentinel slots after their tiles' sorted edges); and a hub graph,
    ``powerlaw_configuration(5000, 40000, seed=3)`` plus 2,600 in-edges of
    node 1234, whose run spans three or more blocks. (The twitter stand-in
    itself has a hub of 4,644 in-edges.)"""
    import dataclasses
    import torch
    from repro_torch.core import heterogeneous, make_engine
    from repro_torch.graphs import Graph, powerlaw_configuration
    from repro_torch.kernels.formats import block_ranges, build_edge_tiles
    from repro_torch.kernels.ops import DeviceEdgeTiles
    out = {}
    fmt = DeviceEdgeTiles.from_format(build_edge_tiles(twitter, tile=tile),
                                      "cuda")
    rng = np.random.default_rng(9)
    src = fmt.src_idx.reshape(fmt.src_idx.shape[0], -1).cpu().numpy().copy()
    dstl = fmt.dst_local.reshape(src.shape).cpu().numpy().copy()
    first, count = block_ranges(fmt.block_tile.cpu().numpy(), fmt.num_tiles)
    for a, c in zip(first, count):
        perm = rng.permutation(c * src.shape[1])
        src[a:a + c] = src[a:a + c].reshape(-1)[perm].reshape(c, -1)
        dstl[a:a + c] = dstl[a:a + c].reshape(-1)[perm].reshape(c, -1)
    out["shuffled"] = (twitter, dataclasses.replace(
        fmt, src_idx=torch.as_tensor(src, device="cuda").reshape(
            fmt.src_idx.shape),
        dst_local=torch.as_tensor(dstl, device="cuda").reshape(
            fmt.dst_local.shape)))
    eng = make_engine("cuda", graph=twitter,
                      activity=heterogeneous(twitter.n, seed=6),
                      device="cuda", tile=tile)
    used = np.bincount(twitter.dst // tile, minlength=fmt.num_tiles)
    free = eng.fmt_host.tile_num_blocks * eng.fmt_host.eblk - used
    roomy = np.flatnonzero(free >= 64)
    rng = np.random.default_rng(10)
    dst = np.minimum(rng.choice(roomy, 64) * tile + rng.integers(0, tile, 64),
                     twitter.n - 1)
    eng.patch_edges(rng.integers(0, twitter.n, 64), dst)
    check(eng.format_builds == 1, f"patched t{tile}: the format was rebuilt")
    out["patched"] = (eng.graph, eng.fmt)
    g = powerlaw_configuration(5000, 40000, seed=3)
    hub_src = np.random.default_rng(12).choice(
        np.delete(np.arange(g.n), 1234), 2600, replace=False)
    g = Graph(g.n, np.concatenate([g.src, hub_src]),
              np.concatenate([g.dst, np.full(2600, 1234)]))
    out["hub"] = (g, DeviceEdgeTiles.from_format(
        build_edge_tiles(g, tile=tile), "cuda"))
    return out


def deal_rows(fmt):
    """A copy of ``fmt`` whose slots are dealt in order over the rows of
    their tile (slot k of a tile's range of b blocks goes to row
    ``k * tile // (b * eblk)``): the same slots, gathers and blocks, still
    sorted by row, but no row with more than ``b * eblk / tile`` slots.
    Timing both isolates the tail of the in-degree skew (the sums differ;
    nothing is checked)."""
    import dataclasses
    import torch
    eblk = fmt.src_idx[0].numel()
    bt = fmt.block_tile.long()
    first = fmt.tile_first_block.long()[bt]
    span = fmt.tile_num_blocks.long()[bt] * eblk
    pos = ((torch.arange(bt.numel(), device=bt.device) - first)[:, None]
           * eblk + torch.arange(eblk, device=bt.device))
    rows = pos * fmt.tile // span[:, None]
    return dataclasses.replace(fmt, dst_local=rows.to(torch.int32).reshape(
        fmt.dst_local.shape))


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
            err, share = _check_power_step(f"{cname} {dname}", fmt, args,
                                           rtol, atol, gtol)
            if cname == "twitter" and dname == "float32":
                errs["power_step"] = err
                report["power_step_share"] = share
                say(f"  twitter format indices: "
                    f"{(fmt_h.src_idx.nbytes + fmt_h.dst_local.nbytes) / 1e6:.1f} MB")
    # the layouts beyond the dst-sorted build, at every autotuner tile
    report["variants"] = {t: edge_tile_variants(twitter, t)
                          for t in (128, 256, 512)}
    for tile, variants in report["variants"].items():
        for vname, (g, fmt) in variants.items():
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).removeprefix("torch.")
                rtol, atol = POWER_TOL[dname]
                _check_power_step(f"t{tile} {vname} {dname}", fmt,
                                  power_step_args(g, fmt, dtype), rtol, atol,
                                  GAP_RTOL[dname])
    clustered = clustered_blocks(262_144, 4_194_304, block=128, p_in=1.0,
                                 seed=3)
    report["clustered"] = clustered
    report["twitter"] = twitter
    bsr_cases(report, clustered)
    edge_spmv_cases(report, twitter)
    seg_mm_cases(report)


def bsr_cases(report: dict, clustered) -> None:
    """bsr_spmv (the bare push) and bsr_step (the fused step) at every BSR
    shape the autotuner may pick or time and at td 64 and 32 (a thread then
    owns 2 or 1 columns), on the clustered graph and a ragged one, at f32
    and f64: the push on one-byte tiles twice (bitwise
    equal), against the same tiles stored in the working dtype (bitwise
    equal: the cell conversion is exact) and against its plain version (a
    batched matmul summing in another order, BSR_TOL); the step twice
    (bitwise), against the composition it replaces, ``mu * push(s * inv_w)
    + c`` (s_new bitwise, gap within GAP_RTOL), and against its plain
    version (BSR_TOL)."""
    import torch
    from repro_torch.core import build_operators, heterogeneous
    from repro_torch.graphs import clustered_blocks
    from repro_torch.kernels.bsr_spmv import (bsr_spmv_call, bsr_spmv_plain,
                                              bsr_step_plain)
    from repro_torch.kernels.ops import DeviceBsr, bsr_spmv, bsr_step
    ragged = clustered_blocks(1000, 8000, block=128, p_in=0.9, seed=23)
    bcases = [("clustered", clustered, 128),
              ("clustered td256", clustered, 256),
              ("ragged n=1000", ragged, 128), ("ragged td256", ragged, 256),
              ("clustered td64", clustered, 64), ("ragged td32", ragged, 32)]
    errs = report["max_abs_err"]
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).removeprefix("torch.")
        rtol, atol = BSR_TOL[dname]
        for cname, g, td in bcases:
            fmt_h, fmt, args = bsr_inputs(g, dtype, td=td)
            check(fmt.tiles.dtype == torch.uint8,
                  f"bsr {cname} {dname}: count tiles not kept in one byte")
            kw = dict(num_dst_tiles=fmt.num_dst_tiles)
            o1 = bsr_spmv_call(*args, **kw)
            o2 = bsr_spmv_call(*args, **kw)
            wide = torch.as_tensor(fmt_h.tiles, device="cuda")
            ow = bsr_spmv_call(args[0], wide, *args[2:], **kw)
            torch.cuda.synchronize()
            check(torch.equal(o1, o2), f"bsr_spmv {cname} {dname}: two runs "
                  "differ")
            check(torch.equal(o1, ow), f"bsr_spmv {cname} {dname}: one-byte "
                  f"and {dname} tiles differ")
            op = bsr_spmv_plain(*args[:4], **kw)
            err, share = _compare(f"bsr_spmv {cname} {dname}", o1, op, rtol,
                                  atol)
            say(f"bsr_spmv {cname:15s} {dname}: {fmt_h.num_blocks} tiles "
                f"({fmt.tiles.nbytes / 1e6:.1f} MB in one byte a cell, "
                f"{fmt_h.tiles.nbytes / 1e6:.1f} MB in {dname}; occupancy "
                f"{fmt_h.occupancy:.3f}), max abs err {err:.3e} (rtol {rtol},"
                f" atol {atol}; worst element at {share:.3g} of its limit), "
                f"bitwise repeatable and equal on both storages")
            if cname == "clustered" and dname == "float32":
                errs["bsr_spmv"] = err
                report["bsr_spmv_share"] = share
            # the fused step on the same format
            ops = build_operators(g, heterogeneous(g.n, seed=1), dtype=dtype,
                                  device="cuda")
            s = args[0][0, :g.n].contiguous()
            step = (ops.inv_w, ops.mu, ops.c)
            s1, gap1 = bsr_step(s, *step, fmt)
            s2, gap2 = bsr_step(s, *step, fmt)
            fmt_w = DeviceBsr(**{**vars(fmt), "tiles": wide})
            s3, gap3 = bsr_step(s, *step, fmt_w)
            s_ref = ops.mu * bsr_spmv(s * ops.inv_w, fmt) + ops.c
            gap_ref = float(torch.sum(torch.abs(s_ref - s)))
            torch.cuda.synchronize()
            tag = f"bsr_step {cname} {dname}"
            check(torch.equal(s1, s2) and torch.equal(gap1, gap2),
                  f"{tag}: two runs differ")
            check(torch.equal(s1, s3) and torch.equal(gap1, gap3),
                  f"{tag}: one-byte and {dname} tiles differ")
            check(torch.equal(s1, s_ref), f"{tag}: s_new differs from mu * "
                  "bsr_spmv(s * inv_w) + c")
            gap_rel = abs(float(gap1) - gap_ref) / gap_ref
            check(gap_rel <= GAP_RTOL[dname], f"{tag}: gap rel err "
                  f"{gap_rel:.3e} against the composition's > "
                  f"{GAP_RTOL[dname]}")
            sp, _ = bsr_step_plain(s, *step, wide, args[2], args[3],
                                   n_src_pad=fmt.n_src_pad, **kw)
            err, share = _compare(tag, s1, sp, rtol, atol)
            say(f"{tag}: s_new bitwise equal to the unfused composition, "
                f"gap rel err {gap_rel:.3e} (tol {GAP_RTOL[dname]}), max abs "
                f"err {err:.3e} against the plain step (worst element at "
                f"{share:.3g} of its limit), bitwise repeatable")
            if cname == "clustered" and dname == "float32":
                errs["bsr_step"] = err
            del fmt, fmt_w, args, wide, o1, o2, ow, op, ops, s1, s2, s3, sp
        torch.cuda.empty_cache()


def _check_power_step(name, fmt, args, rtol, atol, gtol):
    """power_step twice on ``args`` (bitwise equal) and against its plain
    version on CPU copies; returns (max abs err, worst share of limit)."""
    import torch
    from repro_torch.kernels.power_step import (power_step_call,
                                                power_step_plain)
    kw = dict(n=fmt.n, tile=fmt.tile)
    s1, gap1 = power_step_call(*args, **kw)
    s2, gap2 = power_step_call(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(s1, s2) and torch.equal(gap1, gap2),
          f"power_step {name}: two runs differ")
    host = [a.cpu() for a in args]
    sp, gapp = power_step_plain(*host[:4], *host[6:], tile=fmt.tile)
    err, share = _compare(f"power_step {name}", s1.cpu(), sp, rtol, atol)
    gap_rel = abs(float(gap1) - float(gapp)) / max(abs(float(gapp)), 1e-30)
    check(gap_rel <= gtol, f"power_step {name}: gap rel err {gap_rel:.3e} > "
          f"{gtol}")
    counts = fmt.tile_num_blocks
    say(f"power_step {name:24s}: {fmt.num_tiles} tiles, "
        f"{fmt.src_idx.shape[0]} blocks (max {int(counts.max())}/tile), max "
        f"abs err {err:.3e} (rtol {rtol}, atol {atol}; worst element at "
        f"{share:.3g} of its limit), gap rel err {gap_rel:.3e} (tol {gtol}), "
        f"bitwise repeatable")
    return err, share


def _slot_weights(fmt, dtype, seed):
    """Random per-edge weights in the slot layout of the device format
    ``fmt``, 0 in sentinel slots."""
    import torch
    w = np.random.default_rng(seed).uniform(0.5, 2.0,
                                            size=tuple(fmt.src_idx.shape))
    w[fmt.src_idx.cpu().numpy() == fmt.n] = 0.0
    return torch.as_tensor(w, dtype=dtype, device="cuda")


def edge_spmv_cases(report: dict, twitter) -> None:
    """edge_spmv at every edge-tile shape the autotuner times, on the twitter
    stand-in's format (as built, with 7 pad blocks, shuffled, patched) and on
    the hub graph (:func:`edge_tile_variants`), weighted and not, at f32 and
    f64: twice on the same inputs and against its plain version on CPU copies
    of the inputs, both bitwise (both fold each row in slot order and round
    the weight product before the add)."""
    import torch
    from repro_torch.kernels.edge_spmv import edge_spmv_call, edge_spmv_plain
    from repro_torch.kernels.formats import (build_edge_tiles,
                                             pad_edge_tile_blocks)
    from repro_torch.kernels.ops import DeviceEdgeTiles
    n_cases, worst = 0, 0.0
    for tile in (128, 256, 512):
        base = build_edge_tiles(twitter, tile=tile)
        layouts = {"": DeviceEdgeTiles.from_format(base, "cuda"),
                   "+pad": DeviceEdgeTiles.from_format(
                       pad_edge_tile_blocks(base, base.num_blocks + 7),
                       "cuda")}
        layouts.update({f" {k}": fmt for k, (_, fmt)
                        in report["variants"][tile].items()})
        for lname, fmt in layouts.items():
            host_fmt = [t.cpu() for t in (fmt.src_idx, fmt.dst_local,
                                          fmt.block_tile)]
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).removeprefix("torch.")
                s = torch.as_tensor(
                    np.random.default_rng(tile + len(lname)).uniform(
                        size=fmt.n), dtype=dtype, device="cuda")
                s_pre = fmt.pad_gather_source(s)
                for weighted in (False, True):
                    w = (_slot_weights(fmt, dtype, tile + 1) if weighted
                         else None)
                    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
                            fmt.tile_first_block, fmt.tile_num_blocks, w)
                    kw = dict(n=fmt.n, tile=tile)
                    o1 = edge_spmv_call(*args, **kw)
                    o2 = edge_spmv_call(*args, **kw)
                    torch.cuda.synchronize()
                    name = (f"edge_spmv t{tile}{lname} "
                            f"{'weighted' if weighted else 'plain'} {dname}")
                    check(torch.equal(o1, o2), f"{name}: two runs differ")
                    op = edge_spmv_plain(s_pre.cpu(), *host_fmt,
                                         None if w is None else w.cpu(),
                                         tile=tile, num_tiles=fmt.num_tiles)
                    err = float((o1.cpu() - op).abs().max())
                    worst = max(worst, err)
                    check(torch.equal(o1.cpu(), op), f"{name}: differs from "
                          f"the plain version (max abs err {err:.3e}; must "
                          f"be 0)")
                    check(bool(torch.isfinite(o1).all()),
                          f"{name}: non-finite output")
                    n_cases += 1
                    if tile == 512 and not lname and not weighted \
                            and dname == "float32":
                        report["max_abs_err"]["edge_spmv"] = err
            say(f"edge_spmv t{tile}{lname:10s}: {fmt.src_idx.shape[0]} "
                f"blocks; f32/f64 x plain/weighted bitwise equal to the "
                f"plain version and run to run")
            del fmt, host_fmt
    report["edge_spmv_worst_err"] = worst
    say(f"edge_spmv: {n_cases} cases bitwise equal to the plain version "
        f"(worst max abs err {worst:.3e})")


def _seg_mm_variants(report) -> dict:
    """Host edge-tile layouts for seg_mm, as numpy (src_idx [B, eblk],
    dst_local [B, eblk], block_tile [B], num_tiles, n): the trainer's format
    on one minibatch_lg sample of the synthetic Reddit graph (as built, +3
    padding blocks on the last tile, its slots shuffled within each tile's
    range), a small graph with a tile whose one block is all padding, and the
    same graph with one tile's blocks removed (an empty range)."""
    from repro_torch.graphs import Graph, erdos_renyi
    from repro_torch.kernels.formats import build_edge_tiles
    from repro_torch.launch import train
    from repro_torch.models.gnn.common import DEFAULT_TILES
    t0 = time.perf_counter()
    g = erdos_renyi(train.REDDIT_NODES, train.REDDIT_EDGES_CUT, seed=1)
    t1 = time.perf_counter()
    _, p, dims = train.cell()
    seeds = np.random.default_rng(7).choice(g.n, p["batch_nodes"],
                                            replace=False)
    mb, split = train.sample_minibatch(g, seeds, p["fanout"], n=dims["n"],
                                       e=dims["e"], seed=7)
    fmt = mb.agg.fmt
    say(f"seg_mm inputs: synthetic Reddit graph (n={g.n}, m={g.m}) in "
        f"{t1 - t0:.2f} s; one minibatch_lg sample in {split['sample']:.3f} s"
        f", its format in {split['format']:.3f} s: n={fmt.n}, "
        f"{mb.agg.edge_ids.numel()} real edges in {mb.agg.num_slots} slots "
        f"({mb.agg.padding:.3f} per edge), {fmt.num_tiles} tiles of "
        f"{fmt.tile}, {fmt.src_idx.shape[0]} blocks of {fmt.e1 * fmt.e2}")
    report["seg_mm_padding"] = mb.agg.padding
    eblk = fmt.e1 * fmt.e2
    src = fmt.src_idx.numpy().reshape(-1, eblk)
    dstl = fmt.dst_local.numpy().reshape(-1, eblk)
    bt = fmt.block_tile.numpy()
    out = {"minibatch": (src, dstl, bt, fmt.num_tiles, fmt.n)}
    last = fmt.num_tiles - 1
    out["minibatch+pad"] = (
        np.concatenate([src, np.full((3, eblk), fmt.n, np.int32)]),
        np.concatenate([dstl, np.zeros((3, eblk), np.int32)]),
        np.concatenate([bt, np.full(3, last, np.int32)]), fmt.num_tiles,
        fmt.n)
    rng = np.random.default_rng(9)
    src_s, dstl_s = src.copy(), dstl.copy()
    starts = np.searchsorted(bt, np.arange(fmt.num_tiles + 1))
    for a, b in zip(starts[:-1], starts[1:]):
        perm = rng.permutation((b - a) * eblk)
        src_s[a:b] = src_s[a:b].reshape(-1)[perm].reshape(b - a, eblk)
        dstl_s[a:b] = dstl_s[a:b].reshape(-1)[perm].reshape(b - a, eblk)
    out["minibatch shuffled"] = (src_s, dstl_s, bt, fmt.num_tiles, fmt.n)
    small = erdos_renyi(2000, 20000, seed=8)       # nodes 512..1023: no edge
    keep = (small.dst < 512) | (small.dst >= 1024)
    small = Graph(small.n, small.src[keep], small.dst[keep])
    tile, e1, e2 = DEFAULT_TILES
    f = build_edge_tiles(small, tile=tile, e1=e1, e2=e2)
    s2, d2 = f.src_idx.reshape(-1, eblk), f.dst_local.reshape(-1, eblk)
    check(bool((s2[f.block_tile == 1] == small.n).all()),
          "seg_mm idle-tile case: tile 1 holds a real slot")
    out["idle tile"] = (s2, d2, f.block_tile, f.num_tiles, small.n)
    k = f.block_tile != 1
    out["empty tile"] = (s2[k], d2[k], f.block_tile[k], f.num_tiles, small.n)
    # the gnn_families path's formats: PNA's full_graph_sm batch and the
    # equivariant nets' molecule batch
    for name, arch in SEG_MM_FAMILY_LAYOUTS.items():
        cfg = train.cell(arch, name)[0]
        ff = train.shape_batch(arch, name, cfg, "cpu").agg.fmt
        out[name] = (ff.src_idx.numpy().reshape(-1, eblk),
                     ff.dst_local.numpy().reshape(-1, eblk),
                     ff.block_tile.numpy(), ff.num_tiles, ff.n)
    return out


def recsys_bag_case() -> tuple:
    """The train_batch cell's profile bags on the host: (ids, bag_ids,
    n_bags, vocab) for its 65,536 users x 8 tags over the 131,072-row
    profile table (numpy seed 11), one id in RECSYS_BAG_SENTINEL_EVERY the
    sentinel and every RECSYS_BAG_EMPTY_EVERY-th user's bag all sentinels
    (an empty bag of the layout)."""
    from repro_torch.configs import get_arch
    entry = get_arch("mind")
    cfg = entry.config()
    users = entry.shape("train_batch").params["batch"]
    bags = np.repeat(np.arange(users), cfg.profile_tags)
    ids = np.random.default_rng(11).integers(0, cfg.n_profile, bags.size)
    ids[::RECSYS_BAG_SENTINEL_EVERY] = cfg.n_profile
    ids[bags % RECSYS_BAG_EMPTY_EVERY == 0] = cfg.n_profile
    return ids, bags, users, cfg.n_profile


def _bag_seg_mm_layout(ids, bags, n_bags, vocab) -> tuple:
    """The bag layout of :func:`recsys_bag_case` as a seg_mm layout tuple:
    each real slot's source a row below ``n_bags`` (its id mod n_bags), the
    padding slots' the sentinel ``n_bags``."""
    from repro_torch.models.recsys.embedding import bag_layout
    lay = bag_layout(ids, bags, n_bags, vocab, device="cpu")
    fmt = lay.fmt
    eblk = fmt.e1 * fmt.e2
    src = np.full(lay.num_slots, n_bags, np.int32)
    src[lay.slots.numpy()] = ids[lay.edge_ids.numpy()] % n_bags
    return (src.reshape(-1, eblk), fmt.dst_local.numpy().reshape(-1, eblk),
            fmt.block_tile.numpy(), fmt.num_tiles, n_bags)


def _seg_mm_args(layout, d, dtype, gen):
    """seg_mm_call's inputs on the card: random rows x[n + 1, d] (the
    sentinel row n zero) gathered into the layout, and the int32 arrays."""
    import torch
    from repro_torch.kernels.formats import block_ranges
    src, dstl, bt, num_tiles, n = layout
    x = torch.randn(n + 1, d, generator=gen, dtype=dtype, device="cuda")
    x[n] = 0.0
    idx = torch.as_tensor(src.reshape(-1), device="cuda").long()
    msgs = x.index_select(0, idx).reshape(src.shape[0], src.shape[1], d)
    first, count = block_ranges(bt, num_tiles)
    i32 = [torch.as_tensor(np.asarray(a, np.int32), device="cuda")
           for a in (dstl, bt, first, count)]
    return (msgs, *i32)


def seg_mm_cases(report: dict) -> None:
    """seg_mm against its plain version on CPU copies of the inputs (the
    plain version adds every slot in slot order, the kernel a row's slots in
    slot order and no padding past the tile span: held bitwise, since a sum
    from +0.0 is unchanged by a zero row), twice on the same inputs with the
    layout's tile span and once without it (all bitwise), at f32 and f64,
    on every layout of :func:`_seg_mm_variants` at the GraphSAGE cell's d =
    8, 128, 602 and the other families' 75 (PNA) and 32, 96, 160 (NequIP's
    (2l+1)·32), and on the families' own formats at 75, 32, 96, 160 and
    6,272 (EquiformerV2's 49·128), and on the recsys path's profile bags
    (:func:`recsys_bag_case`: sentinel ids, empty bags) at d =
    RECSYS_BAG_D; then the backward against the plain gather."""
    import torch
    from repro_torch.kernels.formats import tile_spans
    from repro_torch.kernels.seg_mm import SegMM, seg_mm_call, seg_mm_plain
    from repro_torch.models.gnn.common import DEFAULT_TILES
    tile = DEFAULT_TILES[0]
    layouts = _seg_mm_variants(report)
    report["bag_case"] = recsys_bag_case()
    layouts["profile bags"] = _bag_seg_mm_layout(*report["bag_case"])
    gen = torch.Generator("cuda").manual_seed(0)
    errs = report["max_abs_err"]
    n_cases = 0
    for name, layout in layouts.items():
        t_layout = time.perf_counter()
        src, _, bt, num_tiles, n = layout
        span = torch.as_tensor(tile_spans(src, n, bt, num_tiles),
                               device="cuda")
        widths = ((RECSYS_BAG_D,) if name == "profile bags" else
                  SEG_MM_FAMILY_WIDTHS if name in SEG_MM_FAMILY_LAYOUTS
                  else SEG_MM_WIDTHS)
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            for d in widths:
                args = _seg_mm_args(layout, d, dtype, gen)
                o1 = seg_mm_call(*args, tile=tile, tile_span=span)
                o2 = seg_mm_call(*args, tile=tile, tile_span=span)
                o3 = seg_mm_call(*args, tile=tile)
                torch.cuda.synchronize()
                tag = f"seg_mm {name} d={d} {dname}"
                check(torch.equal(o1, o2), f"{tag}: two runs differ")
                check(torch.equal(o1, o3), f"{tag}: differs without the "
                      f"tile span")
                host = [a.cpu() for a in args]
                op = seg_mm_plain(host[0], host[1], host[2], tile=tile,
                                  num_tiles=layout[3])
                err = float((o1.cpu() - op).abs().max())
                check(torch.equal(o1.cpu(), op), f"{tag}: differs from the "
                      f"plain version (max abs err {err:.3e}; must be 0)")
                check(bool(torch.isfinite(o1).all()), f"{tag}: non-finite")
                if name == "empty tile":
                    check(bool((o1[tile:2 * tile] == 0).all()),
                          f"{tag}: the tile without blocks is not zero")
                if name == "minibatch" and dname == "float32" and d in (
                        128, 602):
                    errs["seg_mm" if d == 602 else "seg_mm_d128"] = err
                if name == "molecule" and dname == "float32" and d == 6272:
                    errs["seg_mm_d6272"] = err
                if name == "profile bags" and dname == "float32":
                    errs["seg_mm_d64"] = err
                n_cases += 1
                del args, o1, o2, o3, host, op
        say(f"seg_mm {name:18s}: {layout[0].shape[0]} blocks, {layout[3]} "
            f"tiles, {int(span.sum())} slots in the tile spans of "
            f"{src.size}; f32/f64 x d {'/'.join(map(str, widths))} bitwise "
            f"equal to the plain version, with and without the span, and "
            f"run to run ({time.perf_counter() - t_layout:.1f} s)")
    # the backward: dM = dY at each slot's row, against the plain gather
    args = _seg_mm_args(layouts["minibatch+pad"], 128, torch.float32, gen)
    msgs = args[0].clone().requires_grad_()
    out = SegMM.apply(msgs, *args[1:], tile)
    w = torch.randn(out.shape, generator=gen, device="cuda")
    (out * w).sum().backward()
    rows = (args[2].long()[:, None] * tile + args[1].long()).reshape(-1)
    check(torch.equal(msgs.grad.reshape(-1, 128).cpu(),
                      w.cpu().index_select(0, rows.cpu())),
          "seg_mm backward: differs from the plain gather")
    say(f"seg_mm: {n_cases} cases bitwise equal to the plain version; "
        f"backward equal to the plain gather (minibatch+pad, d=128)")
    torch.cuda.empty_cache()


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
    import torch
    from repro_torch.core import heterogeneous
    from repro_torch.kernels.bsr_spmv import bsr_step_call
    g = report["clustered"]
    rng = np.random.default_rng(2)
    src = rng.integers(0, g.n, 64)
    dst = (src // 128) * 128 + rng.integers(0, 128, 64)  # same dense tile
    _drive_service("bsr", g, heterogeneous(g.n, seed=6), bsr_step_call,
                   report, {"regime": "bsr"}, (src, dst))
    tiles = report["bsr_service"].engine.fmt.tiles
    check(tiles.dtype == torch.uint8, f"bsr service: tiles kept as "
          f"{tiles.dtype} after the edge patch, not one byte a cell")


def microbench_stability(report: dict, g, runs: int = 3) -> None:
    """Plan the clustered graph with the microbench ``runs`` times (no plan
    cache, no calibration) and print every candidate's µs each time. The
    pick must be the same each time, unless the candidates it moves between
    are within 3% of each other in every run (a tie, reported as such)."""
    from repro_torch.kernels import autotune
    from repro_torch.obs import explain
    picks, tables = [], []
    for k in range(runs):
        plan = autotune.plan_regime(g, microbench=True, device="cuda",
                                    cache=None, calibration=None)
        rec = explain.get_log().last(kind="regime_plan")
        table = {c.name: c.measured_us for c in rec.candidates}
        picks.append(plan.label())
        tables.append(table)
        say(f"microbench stability, clustered, planning {k + 1}: pick "
            f"{plan.label()}; us " + ", ".join(
                f"{name} {us:.2f}" for name, us in table.items()))
    stable = len(set(picks)) == 1
    tie = all(max(t[p] for p in set(picks)) <= 1.03 * min(
        t[p] for p in set(picks)) for t in tables)
    check(stable or tie, f"microbench picks {picks} differ and do not tie: "
          f"{tables}")
    say(f"microbench stability, clustered: {runs} plannings picked "
        f"{picks[0] if stable else picks} "
        f"({'stable' if stable else 'a tie within 3%'})")
    report["microbench_stability"] = (picks, tables)


def phase_auto(report: dict, microbench: bool) -> None:
    """``PsiService(backend="auto")`` on both graphs: the plan, a cold
    solve and a warm activity update, each fixed point at gap 0 and held
    against the f64 reference. Model-only, the plan must be the one the
    cost model gives on the host; with ``microbench`` the candidate table
    (every candidate's push kernel timed on the card) is printed."""
    import torch
    from repro_torch.core import PsiService, heterogeneous
    from repro_torch.kernels import autotune
    from repro_torch.kernels.bsr_spmv import bsr_step_call
    from repro_torch.kernels.power_step import power_step_call
    from repro_torch.obs import explain
    mode = "microbench" if microbench else "model"
    if microbench:
        microbench_stability(report, report["clustered"])
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
                   else bsr_step_call)
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


def phase_gnn_train(report: dict) -> None:
    """The ``graphsage-reddit`` ``minibatch_lg`` cell: 10 trainer steps
    through the CLI entry point, 10 steps on one fixed minibatch (the loss
    must fall), and one full-width step on the card at f32 held against the
    same step at f64 on CPU copies (plain versions)."""
    import dataclasses
    import torch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.models.gnn import sage
    from repro_torch.train.optim import (adamw, cosine_schedule, tree_leaves,
                                         tree_map)
    t0 = time.perf_counter()
    before = seg_mm_call.launches
    run = train.main(["--arch", "graphsage-reddit", "--shape", "minibatch_lg",
                      "--steps", "10", "--device", "cuda"])
    per_step = (seg_mm_call.launches - before) / 10
    losses = run["losses"]
    check(len(losses) == 10 and all(np.isfinite(losses)),
          f"gnn_train: losses {losses}")
    splits = {k: float(np.median([sp[k] for sp in run["splits"]]))
              for k in ("sample", "format", "h2d", "device")}
    say(f"gnn_train minibatch_lg: 10 steps in {time.perf_counter() - t0:.2f} "
        f"s (data set-up included), losses {[round(x, 4) for x in losses]}, "
        f"{per_step:g} seg_mm launches a step (2 layers, forward and the "
        f"remat's recompute), median split (ms): "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in splits.items())
        + f"; slots per real edge {min(run['padding']):.3f}-"
        f"{max(run['padding']):.3f}")
    check(max(run["padding"]) <= 2.0, "gnn_train: the aggregation format "
          f"pads past 2x the real edges ({max(run['padding']):.3f})")
    # one fixed minibatch: the loss must fall
    cfg, p, dims = train.cell()
    data = run["data"]
    seeds = np.random.default_rng(11).choice(data.graph.n, p["batch_nodes"],
                                             replace=False)
    mb, _ = train.sample_minibatch(data.graph, seeds, p["fanout"],
                                   n=dims["n"], e=dims["e"], seed=11)
    batch = mb.to("cuda").batch(data)
    fparams = sage.init_params(cfg, 1, device="cuda")
    opt = adamw(cosine_schedule(1e-3, 10_000, 100))
    state = opt.init(fparams)
    fixed = []
    for _ in range(10):
        fparams, state, loss = train.train_step(fparams, state, batch, cfg,
                                                opt)
        fixed.append(float(loss))
    check(all(np.isfinite(fixed)) and fixed[-1] < fixed[0],
          f"gnn_train fixed minibatch: the loss did not fall: {fixed}")
    say(f"gnn_train fixed minibatch: losses {[round(x, 5) for x in fixed]}")
    # one full-width step: f32 on the card (seg_mm) against f64 on the CPU
    params = sage.init_params(cfg, 2, device="cuda")
    loss = sage.loss_fn(params, batch, cfg)
    loss.backward()
    loss = loss.detach()
    p64 = tree_map(lambda t: t.detach().cpu().double().requires_grad_(),
                   params)
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    t1 = time.perf_counter()
    loss64 = sage.loss_fn(p64, batch.to("cpu"), cfg64)
    loss64.backward()
    loss64 = loss64.detach()
    loss_rel = abs(float(loss) - float(loss64)) / abs(float(loss64))
    grad_rel = [float((a.grad.cpu().double() - b.grad).norm() / b.grad.norm())
                for a, b in zip(tree_leaves(params), tree_leaves(p64))]
    check(loss_rel <= GNN_LOSS_RTOL, f"gnn_train f32 step vs f64: loss rel "
          f"err {loss_rel:.3e} > {GNN_LOSS_RTOL}")
    check(max(grad_rel) <= GNN_GRAD_REL_L2, f"gnn_train f32 step vs f64: "
          f"gradient rel L2 errors {grad_rel} (limit {GNN_GRAD_REL_L2})")
    say(f"gnn_train full-width step: f32 on the card vs f64 on the CPU "
        f"({time.perf_counter() - t1:.2f} s): loss {float(loss):.6f} vs "
        f"{float(loss64):.6f} (rel {loss_rel:.3e}, limit {GNN_LOSS_RTOL}), "
        f"gradient rel L2 max {max(grad_rel):.3e} over {len(grad_rel)} "
        f"leaves (limit {GNN_GRAD_REL_L2})")
    report["gnn"] = dict(losses=losses, fixed=fixed, per_step=per_step,
                         splits=splits, padding=max(run["padding"]),
                         loss_rel=loss_rel, grad_rel=max(grad_rel))
    report["gnn_step"] = (fparams, state, batch, cfg, opt)
    del run, data, params, p64, loss64


# --------------------------------------------------------------------- #
# The other GNN families (PNA, NequIP, EquiformerV2) and 2-D sharded
# message passing
# --------------------------------------------------------------------- #
def _rel_err(a, b, total: float, floor: float = 1e-3) -> float:
    """‖a − b‖ over the larger of ‖b‖ and ``floor`` of the whole tree's
    norm ``total``: a leaf whose true gradient is 0 (EquiformerV2's last
    attention bias: the segment softmax ignores a shift of a head's logits)
    holds f32 rounding noise alone, so it is held in absolute terms."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).norm()) / max(float(b.norm()), floor * total)


@contextlib.contextmanager
def extreme_selections(record: list, replay: list | None = None):
    """Within: every segment max / min of the GNN substrate
    (``common._scatter_extreme``) appends the mask of the edges that take
    it to ``record``; with ``replay``, it takes instead the mean of the
    edges of the next recorded mask (the edges tied at the extreme share
    its gradient evenly, as ``scatter_reduce`` does). Run an f64 pass on
    the masks of an f32 pass to take the gradient of the branch the f32
    pass took: where two edges' values lie within f32 rounding of each
    other the two passes may pick different ones, and the gradient of a
    max jumps there."""
    import torch
    from repro_torch.models.gnn import common
    orig = common._scatter_extreme
    masks = iter(replay or ())

    def patched(values, dst, n, reduce):
        idx = dst.long().reshape((-1,) + (1,) * (values.dim() - 1)
                                 ).expand_as(values)
        if replay is None:
            out = orig(values, dst, n, reduce)
            record.append(values.detach() == out.detach().gather(0, idx))
            return out
        mask = next(masks).to(values.dtype)
        record.append(mask.bool())
        shape = (n + 1,) + values.shape[1:]
        num = values.new_zeros(shape).scatter_add(0, idx, values * mask)
        cnt = values.new_zeros(shape).scatter_add(0, idx, mask)
        return num / torch.clamp(cnt, min=1)

    common._scatter_extreme = patched
    try:
        yield
    finally:
        common._scatter_extreme = orig


def _grads(params):
    import torch
    from repro_torch.train.optim import tree_leaves
    return [p.grad.detach().clone() if p.grad is not None
            else torch.zeros_like(p) for p in tree_leaves(params)]


def _rotation_matrix():
    """The JAX test's rotation (tests/test_models_gnn.py): R from the l = 1
    Wigner block at (α, cos β) = (1.1, 0.4), in xyz order."""
    import torch
    from repro_torch.models.gnn import so3
    d1 = so3.wigner_real(1, torch.tensor([1.1], dtype=torch.float64),
                         torch.tensor([0.4], dtype=torch.float64))[0]
    m = np.array([[0., -1, 0], [0, 0, 1], [1, 0, 0]])
    return np.linalg.inv(m) @ d1.numpy() @ m


def families_steps(fam, dev: str = "cuda") -> None:
    """(a) the CLI runs and the fixed-batch runs, (b) one full-width step
    at f32 against f64 on the card, per arch."""
    import dataclasses
    import torch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.launch.specs import _GNN_MODS
    from repro_torch.train.optim import adamw, cosine_schedule, tree_leaves
    for arch, shape, steps in GNN_FAMILY_RUNS:
        mod = _GNN_MODS[arch]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, t0 = seg_mm_call.launches, time.perf_counter()
        run = train.main(["--arch", arch, "--shape", shape, "--steps",
                          str(steps), "--device", dev])
        wall = time.perf_counter() - t0
        per_step = (seg_mm_call.launches - before) / steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses, cfg, batch = run["losses"], run["cfg"], run["batch"]
        check(len(losses) == steps and all(np.isfinite(losses)),
              f"gnn_families {arch}: CLI losses {losses}")
        # one fixed batch, a fresh init: the loss must fall over 10 steps
        params = mod.init_params(cfg, 1, device=dev)
        opt = adamw(cosine_schedule(1e-3, 10_000, 100))
        state = opt.init(params)
        fixed = []
        for _ in range(10):
            params, state, loss = train.train_step(params, state, batch,
                                                   cfg, opt, mod)
            fixed.append(float(loss))
        check(all(np.isfinite(fixed)) and fixed[-1] < fixed[0],
              f"gnn_families {arch}: the loss did not fall on a fixed batch:"
              f" {fixed}")
        step_ms = float(np.median(run["device_ms"][1:]))
        say(f"gnn_families {arch} --shape {shape}: {steps} CLI steps in "
            f"{wall:.2f} s (data set-up included), losses "
            f"{[round(x, 4) for x in losses]}, device ms a step "
            f"{[round(x, 2) for x in run['device_ms']]} (median after the "
            f"first {step_ms:.2f}), {per_step:g} seg_mm launches a step, "
            f"peak memory {peak:.2f} GiB; fixed batch, 10 steps: "
            f"{fixed[0]:.6g} -> {fixed[-1]:.6g}")
        # (b) one full-width step, f32 against f64, both on the card
        limits = GNN_FAMILY_LIMITS[arch]
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        p32 = mod.init_params(cfg, 2, device=dev)
        sel32, sel64, fixed64 = [], [], []
        with extreme_selections(sel32):
            loss32 = mod.loss_fn(p32, batch, cfg)
            loss32.backward()
        loss32, g32 = float(loss32), _grads(p32)

        def step64(*sel):
            tree64 = _retree(p32, iter([p.detach().double().requires_grad_()
                                        for p in tree_leaves(p32)]))
            with extreme_selections(*sel):
                loss64 = mod.loss_fn(tree64, batch, cfg64)
                loss64.backward()
            return float(loss64), _grads(tree64)

        # the f64 step as it runs, then on the f32 step's max/min branches
        loss_raw, g_raw = step64(sel64)
        flips = sum(int((a != b).sum()) for a, b in zip(sel32, sel64))
        loss64, g64 = step64(fixed64, sel32) if flips else (loss_raw, g_raw)
        total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g64)))
        loss_rel = abs(loss32 - loss64) / abs(loss64)
        grad_rel = [_rel_err(a, b, total) for a, b in zip(g32, g64)]
        raw_rel = max(_rel_err(a, b, total) for a, b in zip(g32, g_raw))
        share = (loss_rel / limits[0], max(grad_rel) / limits[1])
        check(share[0] <= 1.0, f"gnn_families {arch} f32 vs f64: loss rel "
              f"{loss_rel:.3e} > {limits[0]}")
        check(share[1] <= 1.0, f"gnn_families {arch} f32 vs f64: gradient "
              f"rel L2 {max(grad_rel):.3e} > {limits[1]}")
        say(f"gnn_families {arch} full-width step, f32 vs f64 on the card: "
            f"loss {loss32:.7g} vs {loss64:.7g} (rel {loss_rel:.3e}, "
            f"{share[0]:.3f} of {limits[0]}), gradient rel L2 max "
            f"{max(grad_rel):.3e} over {len(grad_rel)} leaves ({share[1]:.3f} "
            f"of {limits[1]}); {len(sel32)} segment max/min, {flips} edge "
            f"selections of them differ between f32 and f64"
            + (f" (the f64 step held on the f32 step's selections; as it "
               f"runs, gradient rel L2 max {raw_rel:.3e})" if flips else ""))
        fam[arch] = dict(shape=shape, losses=losses, fixed=fixed,
                         step_ms=step_ms, device_ms=run["device_ms"],
                         per_step=per_step, peak_gib=peak, loss_rel=loss_rel,
                         grad_rel=max(grad_rel), share=share, flips=flips,
                         raw_grad_rel=raw_rel,
                         run=(run["params"], run["state"], batch, cfg,
                              run["opt"]))
        if arch == "equiformer-v2":
            fam["eq_grads"] = (p32, g32)
        del run, g64, g_raw, sel32, sel64, fixed64
        torch.cuda.empty_cache()


def _retree(tree, it):
    """``tree`` with its leaves replaced, in order, from ``it``."""
    if isinstance(tree, dict):
        return {k: _retree(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_retree(t, it) for t in tree]
    return next(it)


def families_rotation(fam, dev: str = "cuda") -> None:
    """(c) rotation invariance of NequIP and EquiformerV2 at full width on
    the molecule batch, f32 and f64."""
    import dataclasses
    import torch
    from repro_torch.launch.specs import _GNN_MODS
    from repro_torch.train.optim import tree_leaves
    rot = _rotation_matrix()
    for arch in ("nequip", "equiformer-v2"):
        mod = _GNN_MODS[arch]
        params, _, batch, cfg, _ = fam[arch]["run"]
        for dtype, limit in ((torch.float32, 1e-3), (torch.float64, 1e-9)):
            pos = batch.pos.double()
            b2 = dataclasses.replace(batch, pos=(pos @ torch.as_tensor(
                rot, device=dev).T).to(dtype))
            b1 = dataclasses.replace(batch, pos=pos.to(dtype))
            p = _retree(params, iter([t.detach().to(dtype)
                                      for t in tree_leaves(params)]))
            c = dataclasses.replace(cfg, dtype=dtype)
            with torch.no_grad():
                o1, o2 = mod.apply(p, b1, c), mod.apply(p, b2, c)
            err = float((o1 - o2).abs().max() / o1.abs().max())
            name = str(dtype).removeprefix("torch.")
            check(np.isfinite(err) and err <= limit, f"gnn_families {arch} "
                  f"{name}: rotation changes the output by {err:.3e} "
                  f"(limit {limit})")
            say(f"gnn_families {arch} rotation invariance ({name}, full "
                f"width, molecule batch): max|o1 - o2| / max|o1| = "
                f"{err:.3e} ({err / limit:.3f} of {limit})")
            fam[f"rot_{arch}_{name}"] = err
        torch.cuda.empty_cache()


def families_sharded(fam, dev: str = "cuda") -> None:
    """(d) ``sharded_sage_apply`` on a world-1 NCCL mesh against
    ``sage.apply`` on full_graph_sm's synthetic graph."""
    import torch
    from repro_torch.graphs import erdos_renyi
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import sage
    from repro_torch.models.gnn.common import batch_from_graph
    from repro_torch.models.gnn.sharded_mp import (build_sharded_graph,
                                                   features_from_src_layout,
                                                   features_to_src_layout,
                                                   sharded_sage_apply)
    g = erdos_renyi(train.CORA_NODES, train.CORA_EDGES, seed=1)
    cfg = sage.SageConfig(d_feat=1433, d_hidden=128, n_classes=7)
    x = np.random.default_rng(5).standard_normal((g.n, 1433),
                                                 dtype=np.float32)
    params = sage.init_params(cfg, 0, device=dev)
    with torch.no_grad():
        ref = sage.apply(params, batch_from_graph(g, x, device=dev), cfg)
    mesh = make_mesh((1, 1), device=dev)
    try:
        t0 = time.perf_counter()
        part, sg = build_sharded_graph(g, mesh)
        out = sharded_sage_apply(params, torch.as_tensor(
            features_to_src_layout(part, x)[mesh.row], device=dev), part,
            sg, mesh, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mesh.close()
    got = features_from_src_layout(part, out.cpu().numpy()[None])
    want = ref.cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(rel <= 1e-5, f"gnn_families sharded_sage_apply (world 1, NCCL): "
          f"rel err {rel:.3e} against sage.apply (limit 1e-5)")
    say(f"gnn_families sharded_sage_apply on a world-1 NCCL mesh "
        f"(n={g.n}, {2 * g.m} directed edges, d_feat 1433): max rel err "
        f"{rel:.3e} against sage.apply (limit 1e-5), {wall * 1e3:.1f} ms "
        f"with the partition")
    fam["sharded_rel"] = rel


def _worst_leaf(card, host) -> float:
    """The largest :func:`_rel_err` of a leaf, with a floor of 1e-6 of the
    host tree's norm (a zero leaf stays zero)."""
    import torch
    total = float(torch.sqrt(sum((u.double() ** 2).sum() for u in host)))
    return max(_rel_err(a, b, total, floor=1e-6) for a, b in zip(card, host))


def families_optimizers(fam, dev: str = "cuda") -> None:
    """(e) one ``sgd`` and one ``adafactor`` update of the EquiformerV2
    tree on the card against the same update on CPU float64 copies."""
    import torch
    from repro_torch.train import optim
    params, grads = fam.pop("eq_grads")
    leaves = optim.tree_leaves(params)
    for name in ("sgd", "adafactor"):
        make = getattr(optim, name)
        out = {}
        for where, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            p = _retree(params, iter([t.detach().to(where, dtype).clone()
                                      for t in leaves]))
            g = _retree(params, iter([t.to(where, dtype) for t in grads]))
            opt = make(optim.constant_schedule(1e-3))
            before = [t.clone() for t in optim.tree_leaves(p)]
            opt.apply(g, opt.init(p), p)
            after = optim.tree_leaves(p)
            out[dtype] = (after, [a - b for a, b in zip(after, before)])
        (p32, d32), (p64, d64) = out[torch.float32], out[torch.float64]
        rel, d_rel = _worst_leaf(p32, p64), _worst_leaf(d32, d64)
        check(rel <= 1e-6, f"gnn_families {name} update on the card vs CPU "
              f"f64 copies: the parameters' rel L2 {rel:.3e} (limit 1e-6)")
        check(d_rel <= OPT_STEP_REL, f"gnn_families {name} update on the "
              f"card vs CPU f64 copies: the step's rel L2 {d_rel:.3e} "
              f"(limit {OPT_STEP_REL})")
        say(f"gnn_families {name} update of the EquiformerV2 tree "
            f"({len(leaves)} leaves, "
            f"{sum(t.numel() for t in leaves) / 1e6:.2f}M parameters), the "
            f"card against CPU f64 copies: parameters max leaf rel L2 "
            f"{rel:.3e} (limit 1e-6), the step itself {d_rel:.3e} (limit "
            f"{OPT_STEP_REL})")
        fam[f"{name}_rel"], fam[f"{name}_step_rel"] = rel, d_rel


def phase_gnn_families(report: dict) -> None:
    """PNA (full_graph_sm), NequIP and EquiformerV2 (molecule) through the
    trainer's CLI, a fixed-batch run and one f32 step against f64 on the
    card each; rotation invariance at full width; the 2-D sharded GraphSAGE
    forward on a world-1 NCCL mesh; one sgd and one adafactor update; the
    step times, busy shares and peak memory."""
    import torch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.launch.specs import _GNN_MODS
    t0 = time.perf_counter()
    fam = report["gnn_families"] = {}
    families_steps(fam)
    families_rotation(fam)
    families_sharded(fam)
    families_optimizers(fam)
    # (f) each arch's step under the profiler: busy share, seg_mm's share
    for arch, _, _ in GNN_FAMILY_RUNS:
        params, state, batch, cfg, opt = fam[arch]["run"]
        before = seg_mm_call.launches
        fam[arch]["busy"], fam[arch]["seg_mm_share"] = profile_run(
            f"gnn_families {arch} train step", lambda: float(train.train_step(
                params, state, batch, cfg, opt, _GNN_MODS[arch])[2]),
            kernel="seg_mm")
        check(seg_mm_call.launches > before, f"gnn_families {arch}: the "
              "profiled step launched no seg_mm")
    report["gnn_families_batch"] = fam["equiformer-v2"]["run"][2]
    for arch, _, _ in GNN_FAMILY_RUNS:
        del fam[arch]["run"]
    fam["path_s"] = time.perf_counter() - t0
    say(f"gnn_families: path {fam['path_s']:.1f} s; "
        + "; ".join(f"{a} step {fam[a]['step_ms']:.2f} ms, busy "
                    f"{(fam[a]['busy'] or 0):.1%}, seg_mm "
                    f"{fam[a]['per_step']:g} a step, peak "
                    f"{fam[a]['peak_gib']:.2f} GiB"
                    for a, _, _ in GNN_FAMILY_RUNS))
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# The multi-tenant fleet (serve --tenants): lane-batched kernels
# --------------------------------------------------------------------- #
FLEET_SEEDS = (1, 2, 3, 4)
# every bucket of the fleet phase under the default BucketPolicy, and its
# regime (dense_max_n 1024)
FLEET_BUCKETS = {(16_384, 65_536): "cuda", (65_536, 524_288): "cuda",
                 (65_536, 1_048_576): "cuda", (4_096, 16_384): "cuda",
                 (1_024, 16_384): "dense"}


def fleet_tenants() -> list:
    """``(tenant id, graph, activity)``: four seeds each of the paper's
    Table II stand-ins dblp, hepph and facebook at their published sizes,
    then ``serve --tenants``' two small tenants."""
    from repro_torch.core import heterogeneous
    from repro_torch.graphs import (clustered_blocks, load_dataset,
                                    powerlaw_configuration)
    graphs = [(f"{name}-{s}", load_dataset(name, seed=s))
              for name in ("dblp", "hepph", "facebook") for s in FLEET_SEEDS]
    graphs += [("powerlaw2000", powerlaw_configuration(2_000, 12_000,
                                                       seed=100)),
               ("clustered1024", clustered_blocks(1_024, 10_000, block=128,
                                                  p_in=0.9, seed=101))]
    return [(tid, g, heterogeneous(g.n, seed=200 + k))
            for k, (tid, g) in enumerate(graphs)]


def _lane(fleet, tid):
    """(bucket, lane, the lane's own single-lane format and f[1, ·] step
    vectors) of tenant ``tid`` in a cuda-regime bucket."""
    import dataclasses
    rec = fleet._rec(tid)
    bucket = fleet._buckets[rec.spec]
    lane = bucket.order.index(tid)
    fmt, inv_w_g, mu_pad, c_pad = bucket.args
    one = dataclasses.replace(fmt, **{
        k: getattr(fmt, k)[lane] for k in (
            "src_idx", "dst_local", "block_tile", "tile_first_block",
            "tile_num_blocks", "tile_order")})
    return bucket, lane, one, inv_w_g[lane], mu_pad[lane], c_pad[lane]


def single_lane_solve(fleet, tid, s0):
    """The solo loop's rule (stop at the first gap ≤ tol) with the
    single-lane ``power_step`` on ``tid``'s lane's own tensors — its format
    at the bucket's plan, μ, c, 1/w, ‖B‖ — from ``s0`` (f[1, n_pad]), then
    the fleet's epilogue with the single-lane ``edge_spmv``. Returns
    (s, gap, iterations, ψ f[n])."""
    import torch
    from repro_torch.kernels.ops import edge_spmv, power_step
    bucket, lane, fmt, inv_w_g, mu, c = _lane(fleet, tid)
    scale = bucket.scale[lane]
    tol = torch.tensor(fleet.tol, dtype=fleet.dtype)
    s, gap, t = s0, torch.tensor(float("inf"), dtype=fleet.dtype), 0
    while bool(gap > tol) and t < fleet.max_iter:
        s, raw = power_step(s, inv_w_g, mu, c, fmt)
        gap = (scale * raw).cpu()
        t += 1
    push = edge_spmv(s[0, :fmt.n] * inv_w_g[0, :fmt.n], fmt)
    psi = (bucket.lam[lane] * push + bucket.d[lane]) * bucket.inv_n[lane]
    return s, float(gap), t, psi[:fleet._rec(tid).n]


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two float
    tensors of one dtype."""
    import torch
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return int((a.contiguous().view(ints).long()
                - b.contiguous().view(ints).long()).abs().max())


def check_fleet_lane(fleet, tid, graph, act, s0_node, tag, report) -> None:
    """Hold ``tid``'s lane, just solved from ``s0_node`` (node order; None:
    cold), three ways:

    1. against :func:`single_lane_solve` on its own tensors from the same
       start: s, ψ and the count bitwise equal;
    2. against a solo ``cuda`` engine on ``graph`` at the bucket's plan:
       its inputs (μ, c, 1/w, ‖B‖) compared bit for bit first. Where they
       are equal, the count, the gap, s and the engine's own ψ must be too
       (both epilogues push through ``edge_spmv`` and multiply by 1/n
       rounded once). Where an input differs, its ulps are printed; the
       count must be equal and ψ within rel L1 1e-6;
    3. against the f64 ``reference`` on the card: top-10 identical and rel
       L1 ≤ 1e-5.
    """
    import torch
    from repro_torch.core import make_engine
    from repro_torch.core.incremental import RankingCache
    rec = fleet._rec(tid)
    n = rec.n
    bucket, lane, fmt, inv_w_g, mu, c = _lane(fleet, tid)
    psi_lane = torch.as_tensor(rec.psi, device="cuda")
    s_lane = bucket.s[lane]
    s0 = (c.clone() if s0_node is None
          else fmt.pad_node_vector(torch.as_tensor(
              s0_node, dtype=fleet.dtype, device="cuda")))
    s1, gap1, t1, psi1 = single_lane_solve(fleet, tid, s0)
    check(t1 == rec.iterations and torch.equal(s1, s_lane)
          and torch.equal(psi1, psi_lane) and gap1 == rec.gap,
          f"{tag}: lane differs from the single-lane loop on its own "
          f"tensors (iterations {rec.iterations} vs {t1}, s equal "
          f"{torch.equal(s1, s_lane)}, ψ equal {torch.equal(psi1, psi_lane)}"
          f", gap {rec.gap} vs {gap1})")
    plan = bucket.plan
    eng = make_engine("cuda", graph=graph, activity=act, device="cuda",
                      dtype=fleet.dtype, tile=plan.tile, e1=plan.e1,
                      e2=plan.e2)
    ops = eng.ops
    ins = {"mu": (ops.mu, mu[0, :n]), "c": (ops.c, c[0, :n]),
           "1/w": (ops.inv_w, inv_w_g[0, :n]),
           "|B|": (ops.b_norm.reshape(1), bucket.scale[lane].reshape(1))}
    differ = {k: _ulps(a, b) for k, (a, b) in ins.items()
              if not torch.equal(a, b)}
    res = eng.run(tol=fleet.tol, s0=None if s0_node is None else torch.as_tensor(
        s0_node, dtype=fleet.dtype, device="cuda"))
    rel_solo = float((res.psi.double() - psi_lane.double()).abs().sum()
                     / res.psi.double().abs().sum())
    check(res.iterations == rec.iterations, f"{tag}: {rec.iterations} "
          f"iterations, the solo cuda engine {res.iterations}")
    if not differ:
        check(res.gap == rec.gap and torch.equal(res.s, s_lane[0, :n])
              and torch.equal(res.psi, psi_lane),
              f"{tag}: inputs bitwise equal to the solo cuda engine's, but "
              f"gap {rec.gap} vs {res.gap}, s equal "
              f"{torch.equal(res.s, s_lane[0, :n])}, ψ off in "
              f"{int((res.psi != psi_lane).sum())} of {n} entries (rel L1 "
              f"{rel_solo:.3e})")
        solo = "inputs bitwise equal; count, gap, s and ψ bitwise"
    else:
        check(rel_solo <= 1e-6, f"{tag}: ψ rel L1 {rel_solo:.3e} from the "
              f"solo cuda engine's (limit 1e-6)")
        solo = (f"inputs differ (ulps: " + ", ".join(
            f"{k} {v}" for k, v in differ.items()) + f"); count equal, ψ "
            f"rel L1 {rel_solo:.3e}")
    ref = make_engine("reference", graph=graph, activity=act,
                      dtype=torch.float64, device="cuda").run(tol=1e-12)
    rel = float((psi_lane.double() - ref.psi).abs().sum()
                / ref.psi.abs().sum())
    top = RankingCache(psi_lane).top_k(10)[0]
    ref_top = RankingCache(ref.psi).top_k(10)[0]
    check(ref.converged and rel <= 1e-5, f"{tag}: ψ rel L1 {rel:.3e} from "
          f"the f64 reference (limit 1e-5)")
    check(np.array_equal(top, ref_top), f"{tag}: top-10 {top.tolist()} != "
          f"f64 reference {ref_top.tolist()}")
    say(f"{tag}: {rec.iterations} iterations, gap {rec.gap:.3e}; bitwise the "
        f"single-lane loop (s, ψ, count); solo cuda engine: {solo}; f64 "
        f"reference rel L1 {rel:.3e}, top-10 identical")
    report.setdefault("fixed_points", []).append((rec.iterations, rel))
    report.setdefault("fleet_rel_solo", []).append(rel_solo)
    del eng, ref


def _cold_bucket(fleet, spec) -> None:
    """Make one bucket's lanes cold (s₀ = c) and stale, so the next
    ``solve`` runs that bucket alone from scratch."""
    bucket = fleet._buckets[spec]
    bucket.s = fleet._cold_state(bucket)
    for tid in bucket.order:
        rec = fleet._tenants[tid]
        rec.s_host = None
        rec.solved_epoch = -1


def fleet_solve(fleet, tag, report) -> None:
    """``fleet.solve()``, checking that ``power_step_lanes`` launched once a
    step for each cuda bucket solved (its longest active lane's count), not
    once a lane, and ``edge_spmv_lanes`` once a cuda bucket solved."""
    from repro_torch.kernels.edge_spmv import edge_spmv_lanes_call
    from repro_torch.kernels.power_step import power_step_lanes_call
    stale = {t for t in fleet.tenant_ids if fleet.stats(t)["staleness"]}
    cuda = [b for b in fleet._buckets.values()
            if (b.regime or fleet._regime_for(b.spec)) == "cuda"
            and stale & set(b.order)]
    before = (power_step_lanes_call.launches, edge_spmv_lanes_call.launches)
    t0 = time.perf_counter()
    ran = fleet.solve()
    wall = time.perf_counter() - t0
    steps = sum(max(fleet.stats(t)["iterations"] for t in b.order
                    if t in stale) for b in cuda)
    got = (power_step_lanes_call.launches - before[0],
           edge_spmv_lanes_call.launches - before[1])
    check(ran == len(stale), f"{tag}: {ran} lanes ran, {len(stale)} stale")
    check(got == (steps, len(cuda)), f"{tag}: power_step_lanes / "
          f"edge_spmv_lanes launched {got}, expected {steps} (one a step "
          f"of each of {len(cuda)} cuda buckets) / {len(cuda)}")
    say(f"{tag}: {ran} lanes in {wall:.3f} s; power_step_lanes {got[0]} "
        f"launches (one a step a bucket), edge_spmv_lanes {got[1]}")


def phase_fleet(report: dict) -> None:
    """``TenantFleet`` (the ``serve --tenants`` path) with the kernel regime
    on the card: 14 tenants (:func:`fleet_tenants`) in the default bucket
    policy's five buckets (:data:`FLEET_BUCKETS`), a cold f32 solve at tol
    1e-8 with every lane held three ways (:func:`check_fleet_lane`), ranked
    requests through the frontier, an activity patch (warm re-solve,
    co-tenants bitwise), and an edge patch that grows a facebook tenant past
    its bucket's block capacity (restack; the lanes held again)."""
    import torch
    from repro_torch.core import Activity, RankingCache
    from repro_torch.graphs import Graph
    from repro_torch.serving import TenantFleet
    t0 = time.perf_counter()
    tenants = fleet_tenants()
    report["fleet_data_s"] = time.perf_counter() - t0
    fleet = TenantFleet(backend="auto", tol=1e-8, device="cuda")
    t0 = time.perf_counter()
    for tid, g, act in tenants:
        fleet.admit(tid, g, act)
    say(f"fleet: {len(tenants)} tenants made in {report['fleet_data_s']:.2f} "
        f"s, admitted in {time.perf_counter() - t0:.2f} s: " + ", ".join(
            f"{tid} n={g.n} m={g.m}" for tid, g, _ in tenants))
    graphs = {tid: (g.dedup(), act) for tid, g, act in tenants}
    fleet_solve(fleet, "fleet cold", report)
    occ = fleet.occupancy()
    got = {(s.n_pad, s.e_pad): a["regime"] for s, a in occ.items()}
    check(got == FLEET_BUCKETS, f"fleet buckets {got} != {FLEET_BUCKETS}")
    for spec, acct in occ.items():
        say(f"fleet {spec}: {acct['tenants']} lanes, regime "
            f"{acct['regime']}, plan {acct.get('plan')}, node occupancy "
            f"{acct['node_occupancy']:.3f}, edge occupancy "
            f"{acct['edge_occupancy']:.3f}")
    cold = {}
    for tid, _, _ in tenants:
        g, act = graphs[tid]
        cold[tid] = fleet.stats(tid)["iterations"]
        if fleet.occupancy()[fleet.spec_of(tid)]["regime"] == "cuda":
            check_fleet_lane(fleet, tid, g, act, None, f"fleet cold {tid}",
                             report)
        else:
            _check_fleet_psi_only(fleet, tid, g, act, f"fleet cold {tid}",
                                  report)
    # ranked requests through the frontier
    fr = fleet.frontier
    rng = np.random.default_rng(5)
    for r in range(3):
        ids = [tenants[int(k)][0] for k in rng.integers(0, len(tenants), 8)]
        users = np.asarray([int(rng.integers(0, fleet.stats(t)["n"]))
                            for t in ids])
        got = fr.scores_batch(ids, users)
        want = [fleet.psi(t)[u] for t, u in zip(ids, users)]
        check(np.array_equal(got, np.asarray(want, got.dtype)),
              f"fleet request {r}: scores_batch != the lanes' ψ")
        for t in set(ids):
            idx, vals = fr.top_k(t, 10)
            ridx, _ = RankingCache(torch.from_numpy(fleet.psi(t))).top_k(10)
            check(np.array_equal(idx, ridx), f"fleet request {r}: top-10 "
                  f"of {t}")
            check(np.array_equal(fr.rank_of(t, idx), np.arange(10)),
                  f"fleet request {r}: rank_of({t})")
    top = fr.global_top_k(10)
    best = max((float(fleet.psi(t).max()), t) for t in fleet.tenant_ids)
    check(top[0][0] == best[1] and top[0][2] == best[0]
          and [s for *_, s in top] == sorted((s for *_, s in top),
                                             reverse=True),
          f"fleet global_top_k {top[:3]} (best {best})")
    say(f"fleet frontier: 3 batches of 8 (tenant, user) reads equal the "
        f"lanes' ψ; top-10 and rank_of per tenant; global top-3 "
        + ", ".join(f"{t}/{u}@{s:.3e}" for t, u, s in top[:3]))
    # an activity patch on one tenant: it re-solves warm, co-tenants bitwise
    tid = "hepph-1"
    before = {t: fleet.psi(t).copy() for t in fleet.tenant_ids}
    s0 = fleet.series(tid).copy()
    u = int(rng.integers(0, fleet.stats(tid)["n"]))
    g, act = graphs[tid]
    lam = act.lam.copy()
    lam[u] *= 20
    fleet.patch_activity(tid, np.asarray([u]), lam=np.asarray([lam[u]]))
    fleet_solve(fleet, f"fleet patch_activity {tid}", report)
    graphs[tid] = (g, Activity(lam, act.mu.copy()))
    warm = fleet.stats(tid)["iterations"]
    check(warm < cold[tid], f"fleet patch_activity {tid}: {warm} warm "
          f"iterations, not fewer than cold {cold[tid]}")
    for t, psi in before.items():
        if t != tid:
            check(np.array_equal(psi, fleet.psi(t)), f"fleet patch_activity "
                  f"{tid}: co-tenant {t}'s ψ moved")
    check_fleet_lane(fleet, tid, *graphs[tid], s0,
                     f"fleet patch_activity {tid} (warm, from {cold[tid]} "
                     f"cold)", report)
    # an edge patch that grows a facebook tenant past its bucket's blocks
    spec = fleet.spec_of("facebook-1")
    bucket = fleet._buckets[spec]
    nb = bucket.nb
    tile, eblk = bucket.plan.tile, bucket.plan.e1 * bucket.plan.e2
    need = {}
    for t in bucket.order:
        counts = np.bincount(fleet._rec(t).host.dst_by_dst // tile,
                             minlength=spec.n_pad // tile)
        need[t] = int(np.maximum(1, -(-counts // eblk)).sum())
    tid = max(need, key=need.get)
    k = nb - need[tid] + 2              # blocks to add: past nb by 2
    g, act = graphs[tid]
    have = set((g.src.astype(np.int64) * g.n + g.dst).tolist())
    src, dst = [], []
    while len(src) < k * eblk:          # k blocks' worth into node tile 0
        s_, d_ = int(rng.integers(0, g.n)), int(rng.integers(0, tile))
        key = s_ * g.n + d_
        if s_ != d_ and key not in have:
            have.add(key)
            src.append(s_)
            dst.append(d_)
    before = {t: fleet.psi(t).copy() for t in fleet.tenant_ids}
    s0 = fleet.series(tid).copy()
    fleet.patch_edges(tid, np.asarray(src, np.int32),
                      np.asarray(dst, np.int32))
    check(fleet.stats(tid)["rebuckets"] == 0 and fleet.spec_of(tid) == spec,
          f"fleet patch_edges {tid}: rebucketed")
    fleet_solve(fleet, f"fleet patch_edges {tid} (+{len(src)} edges)",
                report)
    check(bucket.nb > nb and bucket is fleet._buckets[spec],
          f"fleet patch_edges {tid}: block capacity {nb} -> {bucket.nb}, "
          f"no restack")
    warm = fleet.stats(tid)["iterations"]
    check(warm < cold[tid], f"fleet patch_edges {tid}: {warm} warm "
          f"iterations, not fewer than cold {cold[tid]}")
    for t, psi in before.items():
        if t != tid:
            check(np.array_equal(psi, fleet.psi(t)), f"fleet patch_edges "
                  f"{tid}: co-tenant {t}'s ψ moved")
    host = fleet._rec(tid).host
    graphs[tid] = (Graph(host.n, host.src_by_dst.copy(),
                         host.dst_by_dst.copy()), host.activity())
    say(f"fleet patch_edges {tid}: {len(src)} edges into node tile 0 "
        f"({k} blocks), block capacity {nb} -> {bucket.nb}, bucket "
        f"restacked")
    check_fleet_lane(fleet, tid, *graphs[tid], s0,
                     f"fleet patch_edges {tid} (warm, from {cold[tid]} "
                     f"cold)", report)
    # the restacked bucket, cold: every lane held again
    _cold_bucket(fleet, spec)
    fleet_solve(fleet, f"fleet restacked {spec} cold", report)
    for t in bucket.order:
        check_fleet_lane(fleet, t, *graphs[t], None,
                         f"fleet restacked cold {t}", report)
    report["fleet"] = fleet
    report["fleet_cold_iters"] = cold


def _check_fleet_psi_only(fleet, tid, graph, act, tag, report) -> None:
    """A dense-regime lane: ψ against the f64 reference on the card (top-10
    identical, rel L1 ≤ 1e-5)."""
    import torch
    from repro_torch.core import make_engine
    from repro_torch.core.incremental import RankingCache
    rec = fleet._rec(tid)
    psi = torch.as_tensor(rec.psi, device="cuda")
    ref = make_engine("reference", graph=graph, activity=act,
                      dtype=torch.float64, device="cuda").run(tol=1e-12)
    rel = float((psi.double() - ref.psi).abs().sum() / ref.psi.abs().sum())
    top = RankingCache(psi).top_k(10)[0]
    ref_top = RankingCache(ref.psi).top_k(10)[0]
    check(rec.converged and rel <= 1e-5 and np.array_equal(top, ref_top),
          f"{tag}: converged {rec.converged}, rel L1 {rel:.3e} (limit "
          f"1e-5), top-10 {top.tolist()} vs {ref_top.tolist()}")
    say(f"{tag}: {rec.iterations} iterations (dense regime), gap "
        f"{rec.gap:.3e}; f64 reference rel L1 {rel:.3e}, top-10 identical")
    report.setdefault("fixed_points", []).append((rec.iterations, rel))


# --------------------------------------------------------------------- #
# The paper's comparison path and the certified push backend
# --------------------------------------------------------------------- #
def push_edge(g) -> tuple[int, int]:
    """The follow edge the push phase inserts: node 0 starts following the
    most-followed user it does not follow yet."""
    leaders = set(g.dst[g.src == 0].tolist()) | {0}
    for i in np.argsort(-g.in_degree, kind="stable"):
        if int(i) not in leaders:
            return 0, int(i)
    raise SmokeFailure("node 0 follows every user")


def exact_job(kind: str):
    """The host float64 exact solves (``exact_psi``, a sparse LU) of the
    paper and push phases, run in a worker process while the card works:
    each takes tens of seconds on one core. Returns (seconds, result):
    ``paper`` ψ of the paper phase's rates; ``push`` (ψ, the patched user,
    ψ after its λ × 1.2); ``edge`` ψ after :func:`push_edge`."""
    from repro_torch.core import Activity, exact_psi, heterogeneous
    from repro_torch.graphs import Graph, load_dataset
    g = load_dataset("dblp")
    t0 = time.perf_counter()
    if kind == "paper":
        out = exact_psi(g, heterogeneous(g.n, seed=7))[0]
    elif kind == "push":
        act = heterogeneous(g.n, seed=PUSH_RATE_SEED)
        psi = exact_psi(g, act)[0]
        u = int(np.argsort(-psi)[5])
        lam = act.lam.copy()
        lam[u] = act.lam[u] * 1.2
        out = (psi, u, exact_psi(g, Activity(lam, act.mu))[0])
    else:
        src, dst = push_edge(g)
        g2 = Graph(g.n, np.append(g.src, src), np.append(g.dst, dst)).dedup()
        out = exact_psi(g2, heterogeneous(g.n, seed=PUSH_RATE_SEED))[0]
    return time.perf_counter() - t0, out


def _exact(report, kind):
    secs, out = report["exact_jobs"][kind].get(timeout=900)
    report.setdefault("exact_s", {})[kind] = secs
    return out


def solve_times(fn) -> tuple[float, float | None, object]:
    """(wall ms, device ms, result) of one more call of ``fn``: the host
    clock around the call and a synchronise, then the call again under the
    profiler (the summed duration of its kernels and copies; None when the
    profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type != DeviceType.CPU)
    return wall, (us / 1e3 if us > 0 else None), out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_paper(report: dict) -> None:
    """The paper's comparison (Exp. 1-2, ``benchmarks/exp2_matvecs.py``) on
    the card at float64: the DBLP stand-in (Table II's size, uncut), Power-ψ
    through the ``cuda`` engine (``power_step``) and Power-NF over exp2's
    256 origins at every tol 1e-1 ... 1e-9, Power-NF over all 12,591
    origins at 1e-9 (twice: the same bits), and in the homogeneous regime
    Power-ψ against PageRank. Every count must equal ``PAPER_ITERS`` (the
    JAX package's), full-N Power-NF and Power-ψ must be within 1e-6 rel L2
    of ``exact_psi``, PageRank within 1e-6 max abs of homogeneous ψ."""
    import torch
    from repro_torch.core import (build_operators, build_pagerank_ops,
                                  heterogeneous, homogeneous, make_engine,
                                  pagerank, power_nf)
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels.power_step import power_step_call
    g = load_dataset("dblp")
    kw = dict(dtype=torch.float64, device="cuda")
    act = heterogeneous(g.n, seed=7)
    ops = build_operators(g, act, **kw)
    eng = make_engine("cuda", graph=g, activity=act, **kw)
    hom_eng = make_engine("cuda", graph=g,
                          activity=homogeneous(g.n, lam=0.15, mu=0.85), **kw)
    pro = build_pagerank_ops(g, **kw)
    origins = np.sort(np.random.default_rng(1).choice(
        g.n, PAPER_NF_ORIGINS, replace=False))

    def psi_solve(engine, tol, tag):
        before = power_step_call.launches
        res = engine.run(tol=tol)
        launched = power_step_call.launches - before
        check(res.converged, f"paper {tag} tol {tol:.0e}: not converged")
        check(launched == res.iterations, f"paper {tag} tol {tol:.0e}: "
              f"{launched} launches for {res.iterations} iterations")
        return res

    counts, hom_counts = [], []
    for tol in PAPER_TOLS:
        res = psi_solve(eng, tol, "Power-ψ")
        nf = power_nf(ops, tol=tol, chunk=256, origins=origins)
        counts += [res.matvecs, nf.matvecs, nf.max_iterations]
        full = nf.matvecs * g.n / PAPER_NF_ORIGINS
        say(f"paper tol {tol:.0e}: Power-ψ {res.matvecs} mat-vecs; "
            f"Power-NF {nf.matvecs} over {PAPER_NF_ORIGINS} origins (worst "
            f"{nf.max_iterations} iterations, ~{full:.0f} for all {g.n}): "
            f"ratio Power-NF/Power-ψ {full / res.matvecs:.0f}x")
    for tol in PAPER_TOLS:
        hom = psi_solve(hom_eng, tol, "homogeneous Power-ψ")
        pr = pagerank(pro, alpha=0.85, tol=tol)
        check(pr.converged, f"paper PageRank tol {tol:.0e}: not converged")
        hom_counts += [hom.matvecs, pr.matvecs]
        say(f"paper homogeneous tol {tol:.0e}: Power-ψ {hom.matvecs} "
            f"mat-vecs, PageRank {pr.matvecs}")
    nf_all = power_nf(ops, tol=PAPER_TOLS[-1], chunk=256)
    got = counts + hom_counts + [nf_all.matvecs, nf_all.max_iterations]
    say(f"paper counts: {got}")
    check(got == PAPER_ITERS, f"paper counts {got} != {PAPER_ITERS}")
    psi_true = _exact(report, "paper")
    rel_nf = _rel_l2(nf_all.psi, psi_true)
    rel_psi = _rel_l2(res.psi.cpu().numpy(), psi_true)
    pr_err = float((pr.pi - hom.psi).abs().max())
    say(f"paper at tol 1e-9: rel L2 vs exact_psi: Power-NF (all origins) "
        f"{rel_nf:.3e}, Power-ψ {rel_psi:.3e}; max |PageRank − ψ_hom| "
        f"{pr_err:.3e}; Power-NF/Power-ψ mat-vecs {nf_all.matvecs} / "
        f"{res.matvecs} = {nf_all.matvecs / res.matvecs:.0f}x")
    check(rel_nf <= 1e-6 and rel_psi <= 1e-6,
          f"paper: rel L2 vs exact {rel_nf:.3e} / {rel_psi:.3e} > 1e-6")
    check(pr_err <= 1e-6, f"paper: PageRank vs ψ_hom {pr_err:.3e} > 1e-6")
    check(bool(torch.isfinite(res.psi).all()) and res.psi.shape == (g.n,),
          "paper: Power-ψ not finite or of the wrong shape")
    # each solver at tol 1e-9 once more by the host clock, then under the
    # profiler; the Power-NF call by the clock must give the first's bits
    tol = PAPER_TOLS[-1]
    rows = {}
    for name, fn, mv in (
            ("power_psi", lambda: eng.run(tol=tol), res.matvecs),
            ("power_nf_256", lambda: power_nf(ops, tol=tol, chunk=256,
                                              origins=origins), None),
            ("power_nf_all", lambda: power_nf(ops, tol=tol, chunk=256),
             nf_all.matvecs),
            ("power_psi_hom", lambda: hom_eng.run(tol=tol), hom.matvecs),
            ("pagerank", lambda: pagerank(pro, alpha=0.85, tol=tol),
             pr.matvecs)):
        wall, dev, out = solve_times(fn)
        if name == "power_nf_all":
            check(np.array_equal(out.psi, nf_all.psi),
                  "paper: a second Power-NF run at tol 1e-9 gave other bits")
        mv = out.matvecs if mv is None else mv
        rows[name] = dict(wall_ms=wall, device_ms=dev, matvecs=mv)
        say(f"paper time {name} (tol 1e-9): wall {wall:.2f} ms, device "
            + (f"{dev:.2f} ms" if dev is not None else "not measured")
            + f", {mv} mat-vecs")
    per = rows["power_nf_all"]
    say(f"paper Power-NF per origin: wall {per['wall_ms'] / g.n:.4f} ms, "
        f"{nf_all.matvecs / g.n:.1f} mat-vecs; exact_psi (host LU, one core "
        f"of a worker) {report['exact_s']['paper']:.1f} s")
    report["paper"] = dict(counts=got, rel_nf=rel_nf, rel_psi=rel_psi,
                           pr_err=pr_err, times=rows)


def phase_push(report: dict) -> None:
    """The certified residual-push backend on the card: ``PsiService(backend
    ="push")`` (host float64 rounds, device operators) and a ``push`` engine
    with ``frontier="jit"`` (rounds on the card, f32, 128 nodes a round) on
    the DBLP stand-in, each held against ``exact_psi``: the cold certified
    top-10 equals the exact one, the certificate bounds the true error
    after ``run(tol=1e-9)``, an activity patch (the 6th-ranked user's λ ×
    1.2) is served by a warm certified top-10 that equals the new exact one
    and touches fewer users than the cold read, an edge patch rebuilds the
    frontier table and the re-solve lands within 1e-6 of exact, and the
    device rounds run twice from one state give the same rounds and bits.
    No TPU kernel lies on this path."""
    import torch
    from repro_torch.core import PsiService, heterogeneous, make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.localpush import cold_state, push
    g = load_dataset("dblp")
    act = heterogeneous(g.n, seed=PUSH_RATE_SEED)
    psi_true, u, psi_patched = _exact(report, "push")

    def exact_top(psi):
        return set(np.argsort(-psi, kind="stable")[:10].tolist())

    out = {}
    svc = PsiService(g, act, tol=1e-9, backend="push", device="cuda")
    for tag in ("cold", "warm"):
        if tag == "warm":
            svc.update_activity(np.asarray([u]),
                                lam=np.asarray([act.lam[u] * 1.2]),
                                resolve=False)
        t0 = time.perf_counter()
        cert = svc.top_k_certified(10)
        wall = (time.perf_counter() - t0) * 1e3
        stats = dict(svc.engine.last_run_stats)
        want = exact_top(psi_true if tag == "cold" else psi_patched)
        check(cert.certified, f"push {tag}: top-10 not certified "
              f"(margin {cert.margin:.3e}, bound {cert.err_bound})")
        check(set(cert.indices.tolist()) == want,
              f"push {tag}: certified top-10 != exact top-10")
        check(svc.last_result.psi.device.type == "cuda",
              f"push {tag}: ψ not on the card")
        out[tag] = dict(wall_ms=wall, rounds=stats["rounds"],
                        edge_work=stats["edge_work"],
                        touched_frac=stats["touched_frac"],
                        err_bound=cert.err_bound)
        say(f"push {tag} certified top-10 (user {u} patched)"
            if tag == "warm" else "push cold certified top-10")
        say(f"  {wall:.1f} ms, {stats['rounds']} rounds, edge work "
            f"{stats['edge_work']}, touched {stats['touched_frac']:.1%}, "
            f"bound {cert.err_bound:.3e}, equals the exact top-10")
        if tag == "cold":
            svc.resolve()                 # run(tol=1e-9) from the handle
            err = float(np.abs(svc.engine.last_psi_host - psi_true).max())
            bound = svc.engine.psi_error_bound()
            check(bound is not None and err <= bound,
                  f"push: true error {err:.3e} > certificate {bound}")
            say(f"push resolve to tol 1e-9: |ψ_host − exact|∞ {err:.3e} ≤ "
                f"certificate {bound:.3e}")
    check(out["warm"]["touched_frac"] < out["cold"]["touched_frac"],
          f"push: the warm read touched {out['warm']['touched_frac']:.1%}, "
          f"not fewer than the cold {out['cold']['touched_frac']:.1%}")

    jit = make_engine("push", graph=g, activity=act, frontier="jit",
                      frontier_size=128, device="cuda")
    fops = jit.frontier_ops()
    check(all(t.device.type == "cuda" for t in (fops.leaders, fops.deg,
                                                fops.inv_w, fops.mu)),
          "push: a frontier tensor is not on the card")
    t0 = time.perf_counter()
    jit.run(tol=1e-9)
    wall = (time.perf_counter() - t0) * 1e3
    stats = dict(jit.last_run_stats)
    err = float(np.abs(jit.last_psi_host - psi_true).max())
    check(err <= jit.psi_error_bound(), f"push jit: true error {err:.3e} > "
          f"certificate {jit.psi_error_bound()}")
    out["jit"] = dict(wall_ms=wall, rounds=stats["rounds"],
                      jit_rounds=stats["jit_rounds"],
                      jit_share=stats["jit_seconds"] * 1e3 / wall,
                      err=err, err_bound=jit.psi_error_bound())
    say(f"push jit run(tol=1e-9): {wall:.1f} ms, {stats['jit_rounds']} "
        f"device rounds ({stats['jit_seconds'] * 1e3:.1f} ms, "
        f"{out['jit']['jit_share']:.1%} of the wall) then "
        f"{stats['rounds'] - stats['jit_rounds']} host rounds; "
        f"|ψ_host − exact|∞ {err:.3e} ≤ certificate "
        f"{jit.psi_error_bound():.3e}")
    # the device rounds twice from one state: the same rounds and bits
    loop = push.make_frontier_loop(fops, frontier_size=128)
    st = cold_state(jit.host)
    args = [torch.tensor(v.astype(np.float32), device="cuda")
            for v in (st.x, st.r, st.p)]
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(loop(*args, 0.0, 2000))
        runs[-1] += ((time.perf_counter() - t0) * 1e3,)
    (x1, r1, p1, t1, e1, ms1), (x2, r2, p2, t2, e2, ms2) = runs
    check((t1, e1) == (t2, e2) and all(torch.equal(a, b) for a, b in
                                       ((x1, x2), (r1, r2), (p1, p2))),
          "push: two device runs from one state differ")
    say(f"push device rounds twice from the cold state: {t1} rounds, edge "
        f"work {e1}, bitwise equal; {ms1 / t1:.4f} / {ms2 / t2:.4f} ms a "
        f"round")
    out["round_ms"] = min(ms1 / t1, ms2 / t2)
    out["round_busy"], _ = profile_run("push 200 device rounds",
                                       lambda: loop(*args, 0.0, 200))
    # an edge patch: the padded leader table is rebuilt
    src, dst = push_edge(g)
    jit.patch_edges(np.asarray([src]), np.asarray([dst]))
    jit.run(tol=1e-8)
    new = jit.frontier_ops()
    check(new is not fops and dst in new.leaders[src].tolist()
          and dst not in fops.leaders[src].tolist(),
          "push: the frontier table was not rebuilt after an edge patch")
    err = float(np.abs(jit.last_psi_host - _exact(report, "edge")).max())
    check(err <= 1e-6, f"push after edge ({src}→{dst}): |ψ − exact|∞ "
          f"{err:.3e} > 1e-6")
    say(f"push jit after edge {src}→{dst}: frontier rebuilt, "
        f"|ψ_host − exact|∞ {err:.3e}; exact_psi (host LU, worker) "
        + ", ".join(f"{k} {v:.1f} s"
                    for k, v in sorted(report["exact_s"].items())))
    report["push"] = out


# --------------------------------------------------------------------- #
# stream: serve --stream on the card (the service) and the fleet target
# --------------------------------------------------------------------- #
def _quantiles(xs) -> tuple[float, float]:
    """(median, p99) of a list of numbers (nearest rank)."""
    xs = sorted(xs)
    return (xs[len(xs) // 2], xs[min(len(xs) - 1, int(0.99 * len(xs)))])


def _obs_sinks():
    """A fresh registry and convergence tracker for one stream run (so its
    counts are its own); returns what ``obs.restore`` needs afterwards."""
    from repro_torch import obs
    return obs.configure(registry=obs.MetricsRegistry(),
                         tracker=obs.ConvergenceTracker(keep=4096))


def _read_rounds(svc, n: int, *, seed: int) -> float:
    """Host seconds of ``STREAM_READ_ROUNDS`` rounds of ``serve --stream``'s
    reads (``scores_batch`` of 4 users, their ``rank_of``, ``top_k(10)``)."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for _ in range(STREAM_READ_ROUNDS):
        users = rng.integers(0, n, 4)
        svc.scores_batch(users)
        svc.rank_of(users)
        svc.top_k(10)
    return time.perf_counter() - t0


def stream_ingest(graph, log, horizon, device, *, limit=None) -> dict:
    """One cold float64 ``cuda`` service on ``graph`` fed ``log`` (its first
    ``limit`` events) through a ``StreamIngestor`` (coalesce 64, a resolve
    every 1,000 events); returns the service, the ingestor, its report and
    what the run measured: the wall, each flush window's and each
    re-prepare's host ms, the resolves' iterations and host ms (from the
    ``engine.run`` records) and the format builds a tile overflow caused.
    The caller has installed fresh obs sinks."""
    import torch
    from repro_torch.core import RATE_FLOOR, Activity, PsiService
    from repro_torch.obs import convergence
    from repro_torch.stream import FreshnessPolicy, StreamIngestor
    cold = Activity(np.full(graph.n, RATE_FLOOR), np.full(graph.n,
                                                          RATE_FLOOR))
    svc = PsiService(graph, cold, tol=1e-8, backend="cuda",
                     dtype=torch.float64, device=device)
    ing = StreamIngestor(svc, half_life=horizon / 2, topk=10,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=1000))
    out = dict(svc=svc, ing=ing, m0=svc.graph.m, flush_ms=[],
               rebuild_ms=[])
    flush, rebuild = ing.flush, svc._full_rebuild

    def timed_flush():
        busy = ing._buffered > 0
        t0 = time.perf_counter()
        flush()
        if busy:
            out["flush_ms"].append((time.perf_counter() - t0) * 1e3)

    def timed_rebuild(*args, **kw):
        t0 = time.perf_counter()
        rebuild(*args, **kw)
        out["rebuild_ms"].append((time.perf_counter() - t0) * 1e3)

    ing.flush, svc._full_rebuild = timed_flush, timed_rebuild
    t0 = time.perf_counter()
    out["rep"] = ing.ingest(log, limit=limit)
    out["wall_s"] = time.perf_counter() - t0
    recs = [r for r in convergence.get_tracker().series(None)
            if r.backend == "cuda"]
    out["iters"] = [r.iterations for r in recs]
    out["resolve_ms"] = [r.duration_s * 1e3 for r in recs]
    # one build at prepare and one at each re-prepare; the rest were a
    # tile running out of sentinel slots
    out["overflow_builds"] = (svc.engine.format_builds - 1
                              - len(out["rebuild_ms"]))
    return out


def stream_service(report: dict) -> None:
    """Part (a) of the stream path: the twitter stand-in, cold, fed a
    flash crowd of ~100k events (:func:`stream_ingest`), then 200 read
    rounds; counts, edges, ψ and the iteration list held as the module
    docstring says; then the first 10,000 events replayed on two fresh
    services (ψ bitwise, the same iterations)."""
    import json as _json

    import torch
    from repro_torch import obs
    from repro_torch.core import heterogeneous, make_engine
    from repro_torch.kernels.power_step import power_step_call
    from repro_torch.stream import flash_crowd_stream
    g = report["twitter"]
    truth = heterogeneous(g.n, seed=8)
    horizon = STREAM_EVENTS / float(truth.total.sum())
    t0 = time.perf_counter()
    log = flash_crowd_stream(g, truth, horizon, seed=9, new_followers=96,
                             churn=0.3)
    counts = log.counts()
    say(f"stream: {len(log)} events {counts} over {horizon:.3f} s of event "
        f"time made in {time.perf_counter() - t0:.2f} s; celebrity "
        f"{int(np.argmax(g.in_degree))} (in-degree "
        f"{int(g.in_degree.max())})")
    prev = _obs_sinks()
    try:
        before = power_step_call.launches
        run = stream_ingest(g, log, horizon, "cuda")
        svc, ing, rep = run["svc"], run["ing"], run["rep"]
        launched = power_step_call.launches - before
        reg = obs.metrics.get_registry()
        by_kind = {k: int(reg.value("psi_stream_events_total", kind=k) or 0)
                   for k in ("post", "repost", "follow", "unfollow")}
        resolves_metric = int(reg.value("psi_stream_resolves_total") or 0)
        read_s = _read_rounds(svc, g.n, seed=1)
        fam = reg.get("psi_query_seconds")
        reads = {key[0]: (ch.quantile(0.5) * 1e3, ch.quantile(0.99) * 1e3,
                          ch.count) for key, ch in fam.children()}
        dump_path = ROOT / "build" / "stream_obs_dump.json"
        dump_path.parent.mkdir(exist_ok=True)
        obs.dump(str(dump_path), device="cuda", dtype=torch.float64)
        back = _json.loads(dump_path.read_text())
        n_records = len([r for r in obs.convergence.get_tracker().series(
            None) if r.backend == "cuda"])
    finally:
        obs.restore(prev)
    # the funnel's cost: the same cached reads with the plane dark (one
    # branch, no span, no metrics) and lit again
    dark = obs.disable()
    try:
        dark_s = _read_rounds(svc, g.n, seed=2)
    finally:
        obs.restore(dark)
    lit_s = _read_rounds(svc, g.n, seed=2)
    check(rep.events_total == len(log) == ing.events_total,
          f"stream: {rep.events_total} events ingested of {len(log)}")
    want = {k.lower(): v for k, v in counts.items()}
    check(by_kind == {k: want.get(k, 0) for k in by_kind},
          f"stream: psi_stream_events_total {by_kind} != log {counts}")
    check(resolves_metric == rep.resolves == n_records == len(run["iters"]),
          f"stream: resolves metric {resolves_metric}, report "
          f"{rep.resolves}, engine.run records {n_records}")
    check(launched == sum(run["iters"]), f"stream: {launched} power_step "
          f"launches for {sum(run['iters'])} iterations")
    m_want = run["m0"] + counts.get("Follow", 0) - counts.get("Unfollow", 0)
    check(svc.graph.m == m_want, f"stream: {svc.graph.m} edges at the end, "
          f"not {run['m0']} + follows − unfollows = {m_want}")
    check("metrics" in back and "convergence" in back
          and back["fingerprint"]["dtype"] == "float64",
          "stream: obs.dump did not parse back")
    ref = make_engine("reference", graph=svc.graph,
                      activity=svc.engine.activity, dtype=torch.float64,
                      device="cuda").run(tol=1e-12)
    psi = svc.last_result.psi
    check(bool(torch.isfinite(psi).all()) and psi.shape == (g.n,),
          "stream: ψ not finite or of the wrong shape")
    rel = float((psi - ref.psi).abs().sum() / ref.psi.abs().sum())
    top = torch.topk(psi, 10).indices.tolist()
    ref_top = torch.topk(ref.psi, 10).indices.tolist()
    check(rel <= 1e-6 and top == ref_top, f"stream: ψ rel L1 {rel:.3e} "
          f"from the f64 reference (≤ 1e-6), top-10 {top} vs {ref_top}")
    flush_med, flush_p99 = _quantiles(run["flush_ms"])
    res_med, res_p99 = _quantiles(run["resolve_ms"])
    it_med, it_p99 = _quantiles(run["iters"])
    out = dict(events=len(log), ev_per_s=len(log) / run["wall_s"],
               wall_s=run["wall_s"], flushes=len(run["flush_ms"]),
               flush_ms=[flush_med, flush_p99], resolves=rep.resolves,
               resolve_ms=[res_med, res_p99], steps=[it_med, it_p99],
               rebuilds=len(run["rebuild_ms"]),
               rebuild_ms=(_quantiles(run["rebuild_ms"])
                           if run["rebuild_ms"] else None),
               overflow_builds=run["overflow_builds"], rel_l1=rel,
               launches=launched, read_s=read_s,
               read_us=[lit_s / (3 * STREAM_READ_ROUNDS) * 1e6,
                        dark_s / (3 * STREAM_READ_ROUNDS) * 1e6],
               reads={op: [p50, p99] for op, (p50, p99, _) in reads.items()})
    say(f"stream service: {len(log)} events in {run['wall_s']:.2f} s "
        f"({out['ev_per_s']:.0f} ev/s sustained), {rep.resolves} resolves "
        f"({launched} power_step launches), churn history "
        f"{[round(c, 2) for c in ing.churn_history][:12]}...")
    say(f"  flush windows {len(run['flush_ms'])}: {flush_med:.3f} ms median, "
        f"{flush_p99:.3f} ms p99 (host); resolves {res_med:.3f} / "
        f"{res_p99:.3f} ms, steps {it_med} / {it_p99} (median / p99)")
    say(f"  unfollow windows that re-prepared the engine: "
        f"{len(run['rebuild_ms'])}"
        + (f" ({out['rebuild_ms'][0]:.1f} ms median, "
           f"{out['rebuild_ms'][1]:.1f} ms p99)" if run["rebuild_ms"]
           else "")
        + f"; edge-tile format rebuilds after a tile overflow: "
        f"{run['overflow_builds']}; edges {run['m0']} → {svc.graph.m}")
    say(f"  {STREAM_READ_ROUNDS} read rounds in {read_s * 1e3:.1f} ms; "
        "psi_query_seconds p50 / p99 by op: " + ", ".join(
            f"{op} {p50:.4f} / {p99:.4f} ms (x{n})"
            for op, (p50, p99, n) in sorted(reads.items())))
    say(f"  a cached read (host clock, {3 * STREAM_READ_ROUNDS} reads): "
        f"{out['read_us'][0]:.2f} µs with the obs plane lit, "
        f"{out['read_us'][1]:.2f} µs dark")
    say(f"  final ψ vs the f64 reference from scratch: rel L1 {rel:.3e}, "
        f"top-10 identical; obs.dump parsed back "
        f"({len(back['convergence'].get('_default', []))} records)")
    say(f"  per-resolve iterations: {run['iters']}")
    # the busy share of one warm resolve (one user's λ × 1.2, deferred)
    u = int(np.argsort(-svc.scores())[5])
    svc.update_activity(np.asarray([u]),
                        lam=np.asarray([svc.engine.activity.lam[u] * 1.2]),
                        resolve=False)
    out["busy"], out["kernel_share"] = profile_run(
        "stream warm resolve", svc.resolve, "power_step")
    check(run["iters"] == STREAM_ITERS, f"stream: per-resolve iterations "
          f"{run['iters']} != STREAM_ITERS {STREAM_ITERS}")
    # determinism: the first events twice, each on a fresh service
    replays = []
    for _ in range(2):
        prev = _obs_sinks()
        try:
            replays.append(stream_ingest(g, log, horizon, "cuda",
                                         limit=STREAM_REPLAY))
        finally:
            obs.restore(prev)
    (a, b) = replays
    check(a["iters"] == b["iters"]
          and torch.equal(a["svc"].last_result.psi, b["svc"].last_result.psi)
          and torch.equal(a["svc"].last_result.s, b["svc"].last_result.s),
          "stream: two replays of the first events differ")
    say(f"stream replay of the first {STREAM_REPLAY} events, twice: ψ and s "
        f"bitwise equal, iterations {a['iters']} both times "
        f"({a['wall_s']:.2f} / {b['wall_s']:.2f} s)")
    report["stream"] = out


def stream_fleet(report: dict) -> None:
    """Part (b) of the stream path: four dblp tenants (seeds 1-4) admitted
    cold to a ``TenantFleet(backend="auto")`` at f32, fed one interleaved
    log of a burst stream a tenant (20,000 events, 16 users at ×10 in the
    middle third) with a fleet resolve every 2,000 events; events by
    tenant add up and each lane's ψ is held against a solo f64 reference
    solve of that tenant's final activity (top-10 identical, rel L1 ≤
    1e-5)."""
    import torch
    from repro_torch.core import (RATE_FLOOR, Activity, heterogeneous,
                                  make_engine)
    from repro_torch.graphs import load_dataset
    from repro_torch.serving import TenantFleet
    from repro_torch.stream import (FreshnessPolicy, StreamIngestor,
                                    burst_stream, tenant_interleave)
    from repro_torch import obs
    fleet = TenantFleet(backend="auto", tol=1e-8, device="cuda")
    graphs, sources, horizons = {}, {}, []
    for k, seed in enumerate(FLEET_SEEDS):
        tid = f"dblp-{seed}"
        g = graphs[tid] = load_dataset("dblp", seed=seed)
        truth = heterogeneous(g.n, seed=200 + k)
        horizon = STREAM_FLEET_EVENTS / float(truth.total.sum())
        rng = np.random.default_rng(300 + k)
        sources[tid] = burst_stream(truth, horizon, seed=300 + k,
                                    burst_users=rng.integers(0, g.n, 16),
                                    burst_factor=10.0)
        horizons.append(horizon)
        fleet.admit(tid, g, Activity(np.full(g.n, RATE_FLOOR),
                                     np.full(g.n, RATE_FLOOR)))
    log = tenant_interleave(sources)
    ing = StreamIngestor(fleet, half_life=max(horizons) / 2, topk=10,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=2000))
    prev = _obs_sinks()
    try:
        t0 = time.perf_counter()
        rep = ing.ingest(log)
        wall = time.perf_counter() - t0
        lane_iters = {tid: [r.iterations for r in
                            obs.convergence.get_tracker().series(tid)]
                      for tid in graphs}
    finally:
        obs.restore(prev)
    per = {tid: ing.estimator(tid).events for tid in graphs}
    want = {tid: len(src) for tid, src in sources.items()}
    check(per == want and sum(per.values()) == len(log) == rep.events_total,
          f"stream fleet: events by tenant {per} != {want}")
    occ = {str(s): a["regime"] for s, a in fleet.occupancy().items()}
    worst = 0.0
    for tid, g in graphs.items():
        ref = make_engine("reference", graph=fleet._rec(tid).host.graph(),
                          activity=fleet.activity(tid), dtype=torch.float64,
                          device="cuda").run(tol=1e-12)
        psi = torch.as_tensor(fleet.psi(tid), dtype=torch.float64,
                              device="cuda")
        check(bool(torch.isfinite(psi).all()) and psi.shape == ref.psi.shape,
              f"stream fleet {tid}: ψ not finite or of the wrong shape")
        rel = float((psi - ref.psi).abs().sum() / ref.psi.abs().sum())
        top = torch.topk(psi, 10).indices.tolist()
        ref_top = torch.topk(ref.psi, 10).indices.tolist()
        check(rel <= 1e-5 and top == ref_top, f"stream fleet {tid}: rel L1 "
              f"{rel:.3e} (≤ 1e-5), top-10 {top} vs reference {ref_top}")
        worst = max(worst, rel)
    # a lane solve that ran to max_iter sat in an f32 cycle whose gap never
    # reached tol (its ψ is held above all the same)
    capped = sum(i >= fleet.max_iter for v in lane_iters.values() for i in v)
    report["stream_fleet"] = dict(
        events=len(log), ev_per_s=len(log) / wall, resolves=rep.resolves,
        lane_solves=sum(map(len, lane_iters.values())),
        capped=capped, max_rel_l1=worst)
    say(f"stream fleet: {len(log)} events {per} in {wall:.2f} s "
        f"({len(log) / wall:.0f} ev/s), {rep.resolves} fleet resolves, "
        f"buckets {occ}; every lane's ψ within {worst:.3e} rel L1 of its "
        f"f64 reference, top-10 identical")
    say(f"  lane solves {report['stream_fleet']['lane_solves']}, "
        f"{capped} of them ran to max_iter={fleet.max_iter} (f32 gap never "
        f"≤ tol); iterations by tenant: " + "; ".join(
            f"{tid} {v}" for tid, v in lane_iters.items()))


def phase_stream(report: dict) -> None:
    """The ``serve --stream`` path: :func:`stream_service` (``power_step``
    under live event patches) and :func:`stream_fleet`
    (``power_step_lanes`` and ``edge_spmv_lanes`` under per-tenant event
    routing)."""
    t0 = time.perf_counter()
    stream_service(report)
    t1 = time.perf_counter()
    stream_fleet(report)
    say(f"stream: service part {t1 - t0:.1f} s, fleet part "
        f"{time.perf_counter() - t1:.1f} s")


def _rel_top(psi, ref) -> tuple[float, bool]:
    """(rel L1 of ``psi`` from ``ref``, whether their top-10 are equal);
    both node-order vectors, ``ref`` a float64 tensor on the card."""
    import torch
    psi = torch.as_tensor(psi).to(ref.device, torch.float64)
    rel = float((psi - ref).abs().sum() / ref.abs().sum())
    return rel, (torch.topk(psi, 10).indices.tolist()
                 == torch.topk(ref, 10).indices.tolist())


def _hold(tag, psi, ref, out) -> None:
    """Finite ψ of the right shape, top-10 identical and rel L1 ≤ 1e-5
    against the f64 reference; records the rel L1 under ``tag``."""
    import torch
    psi = torch.as_tensor(psi)
    check(bool(torch.isfinite(psi).all()) and psi.shape == ref.shape,
          f"driver {tag}: ψ not finite or of the wrong shape")
    rel, same = _rel_top(psi, ref)
    check(rel <= 1e-5 and same, f"driver {tag}: rel L1 {rel:.3e} from the "
          f"f64 reference (≤ 1e-5), top-10 identical: {same}")
    out["rel_l1"][tag] = rel


def driver_sync(report, g, act, ref, out, tmp) -> None:
    """The sync executor on a world-1 NCCL mesh: the f64 counts against
    DRIVER_ITERS, the f32 run at the CLI's tol, a restart at chunks 1 and
    3 (ψ bitwise the clean run), and PsiService(backend="distributed")
    through an activity patch and a block-local edge insert."""
    import torch
    from repro_torch.core import PsiService
    from repro_torch.core.distributed import DistributedPsi
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import PsiDriver
    mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        t0 = time.perf_counter()
        d64 = DistributedPsi.from_graph(g, act, mesh, dtype=torch.float64)
        rep64 = PsiDriver(d64, chunk_iters=16, ckpt_dir=f"{tmp}/sync64"
                          ).run(tol=DRIVER_TOL_F64)
        out["ms"]["sync_f64"] = (time.perf_counter() - t0) * 1e3
        out["counts"] += [rep64.iterations, rep64.chunks]
        _hold("sync_f64", rep64.psi, ref, out)
        d32 = DistributedPsi.from_graph(g, act, mesh)
        t0 = time.perf_counter()
        clean = PsiDriver(d32, chunk_iters=16, ckpt_dir=f"{tmp}/sync32"
                          ).run(tol=DRIVER_TOL)
        out["ms"]["sync_f32"] = (time.perf_counter() - t0) * 1e3
        out["chunk_ms"] = float(np.median(clean.chunk_durations)) * 1e3
        out["sync_f32"] = [clean.iterations, clean.gap]
        if clean.gap > DRIVER_TOL:
            say(f"driver sync f32: the gap cycles above tol {DRIVER_TOL} "
                f"(gap {clean.gap:.3e} after {clean.iterations}); the f64 "
                "run above is the count held")
        _hold("sync_f32", clean.psi, ref, out)
        t0 = time.perf_counter()
        rep = PsiDriver(d32, chunk_iters=16, ckpt_dir=f"{tmp}/restart").run(
            tol=DRIVER_TOL, fail_hook=lambda c: c in (1, 3))
        out["ms"]["sync_restart"] = (time.perf_counter() - t0) * 1e3
        check(rep.restarts == 2 and np.array_equal(rep.psi, clean.psi),
              f"driver restart: {rep.restarts} restarts, ψ bitwise the "
              f"clean run: {np.array_equal(rep.psi, clean.psi)}")
        say(f"driver sync: f64 {rep64.iterations} iterations in "
            f"{rep64.chunks} chunks ({out['ms']['sync_f64']:.1f} ms with a "
            f"checkpoint a chunk); f32 {clean.iterations} iterations, gap "
            f"{clean.gap:.2e} ({out['ms']['sync_f32']:.1f} ms, a chunk "
            f"{out['chunk_ms']:.3f} ms median); restart at chunks 1 and 3: "
            f"{rep.restarts} restarts, ψ bitwise the clean run "
            f"({out['ms']['sync_restart']:.1f} ms)")
        out["busy"], _ = profile_run(
            "driver sync f32 solve",
            lambda: PsiDriver(d32, chunk_iters=16).run(tol=DRIVER_TOL))
        # the service on the distributed backend: a patch of each kind
        t0 = time.perf_counter()
        svc = PsiService(g, act, tol=DRIVER_TOL, backend="distributed",
                         engine_opts=dict(mesh=mesh), device="cuda")
        svc.scores()
        cold_it = svc.last_iterations()
        u = int(np.argsort(-svc.scores())[3])
        svc.update_activity(np.asarray([u]), lam=np.asarray(
            [svc.engine.activity.lam[u] * 5.0]))
        act_it = svc.last_iterations()
        from repro_torch.core import make_engine
        ref_a = make_engine("reference", graph=svc.graph,
                            activity=svc.engine.activity,
                            dtype=torch.float64, device="cuda").run(tol=1e-12)
        _hold("service_activity", svc.scores(), ref_a.psi, out)
        e_max = int(svc.engine.dist.part.e_max)
        rng = np.random.default_rng(11)
        src = rng.integers(0, g.n, 8).astype(np.int32)
        dst = np.full(8, u, np.int32)
        svc.add_edges(src, dst)
        check(int(svc.engine.dist.part.e_max) == e_max,
              "driver service: the edge insert regrew the partition")
        ref_e = make_engine("reference", graph=svc.graph,
                            activity=svc.engine.activity,
                            dtype=torch.float64, device="cuda").run(tol=1e-12)
        _hold("service_edges", svc.scores(), ref_e.psi, out)
        out["ms"]["service"] = (time.perf_counter() - t0) * 1e3
        out["service_iters"] = [cold_it, act_it, svc.last_iterations()]
        say(f"driver service (backend=distributed, f32): cold "
            f"{cold_it} iterations, activity patch {act_it} warm, block-"
            f"local insert of {svc.graph.m - g.m} edges (e_max {e_max} "
            f"kept) {svc.last_iterations()} warm; each held against the "
            f"f64 reference ({out['ms']['service']:.1f} ms)")
    finally:
        mesh.close()


def driver_async(report, g, act, ref, out, tmp) -> None:
    """The async executor: τ = 0 at f64 against DRIVER_ITERS, τ = 2 with a
    straggler, a checkpoint restart, a warm rechunk(6)."""
    import torch
    from repro_torch.asyncexec import AsyncPsiDriver
    t0 = time.perf_counter()
    r0 = AsyncPsiDriver(g, act, num_chunks=4, tau=0, dtype=torch.float64,
                        device="cuda").run(tol=DRIVER_TOL_F64)
    out["ms"]["async_tau0_f64"] = (time.perf_counter() - t0) * 1e3
    out["counts"] += [r0.iterations, r0.chunks, r0.sync_sweeps]
    check(r0.converged, "driver async τ=0: not converged")
    _hold("async_tau0_f64", r0.psi, ref, out)
    t0 = time.perf_counter()
    r2 = AsyncPsiDriver(g, act, num_chunks=4, tau=2, device="cuda",
                        delay_hook=lambda k, e: 0.002 if k == 1 else 0.0
                        ).run(tol=DRIVER_TOL)
    out["ms"]["async_tau2"] = (time.perf_counter() - t0) * 1e3
    # a chunk is dispatched only within τ epochs of the slowest, so every
    # read is ≤ τ stale; the spread after its publish is at most τ + 1
    check(r2.converged and r2.sync_sweeps >= 1 and r2.max_staleness <= 3,
          f"driver async τ=2: converged {r2.converged}, sweeps "
          f"{r2.sync_sweeps}, max_staleness {r2.max_staleness} (≤ τ + 1)")
    _hold("async_tau2", r2.psi, ref, out)
    out["async_tau2"] = dict(epochs=r2.iterations, steps=r2.chunks,
                             max_staleness=r2.max_staleness,
                             overlap=r2.overlap_efficiency,
                             step_ms=float(np.median(r2.chunk_durations)) * 1e3)
    t0 = time.perf_counter()
    rr = AsyncPsiDriver(g, act, num_chunks=4, tau=1, ckpt_dir=f"{tmp}/async",
                        ckpt_every=2, device="cuda").run(
        tol=DRIVER_TOL, fail_hook=lambda t: t in (3, 6))
    out["ms"]["async_restart"] = (time.perf_counter() - t0) * 1e3
    check(rr.restarts == 2 and rr.converged, f"driver async restart: "
          f"{rr.restarts} restarts, converged {rr.converged}")
    _hold("async_restart", rr.psi, ref, out)
    t0 = time.perf_counter()
    part = AsyncPsiDriver(g, act, num_chunks=4, tau=2, device="cuda")
    part.run(tol=1e-3)
    warm = part.rechunk(6).run(tol=DRIVER_TOL)
    cold = AsyncPsiDriver(g, act, num_chunks=6, tau=2, device="cuda"
                          ).run(tol=DRIVER_TOL)
    out["ms"]["async_rechunk"] = (time.perf_counter() - t0) * 1e3
    check(warm.iterations < cold.iterations, f"driver rechunk: warm "
          f"{warm.iterations} epochs, cold {cold.iterations}")
    _hold("async_rechunk", warm.psi, ref, out)
    out["rechunk"] = [warm.iterations, cold.iterations]
    say(f"driver async: τ=0 f64 {r0.iterations} epochs, {r0.chunks} chunk "
        f"steps, {r0.sync_sweeps} sweep ({out['ms']['async_tau0_f64']:.1f} "
        f"ms); τ=2 with a 2 ms straggler on chunk 1: {r2.iterations} epochs, "
        f"max_staleness {r2.max_staleness}, overlap efficiency "
        f"{r2.overlap_efficiency:.2f}x, a step "
        f"{out['async_tau2']['step_ms']:.3f} ms median "
        f"({out['ms']['async_tau2']:.1f} ms); restart at ticks 3 and 6: "
        f"{rr.restarts} restarts ({out['ms']['async_restart']:.1f} ms); "
        f"rechunk(6) warm {warm.iterations} epochs against cold "
        f"{cold.iterations}")


def driver_stream(report, g, act, out) -> None:
    """A StreamIngestor on the AsyncPsiDriver target: ~10k burst events,
    a resolve every 2,500; the final ψ against the f64 reference."""
    import torch
    from repro_torch.asyncexec import AsyncPsiDriver
    from repro_torch.core import make_engine
    from repro_torch.stream import (FreshnessPolicy, StreamIngestor,
                                    burst_stream)
    horizon = DRIVER_STREAM_EVENTS / float(act.total.sum())
    rng = np.random.default_rng(12)
    log = burst_stream(act, horizon, seed=12,
                       burst_users=rng.integers(0, g.n, 16),
                       burst_factor=10.0)
    drv = AsyncPsiDriver(g, act, num_chunks=4, tau=2, device="cuda")
    ing = StreamIngestor(drv, half_life=horizon / 2, topk=10,
                         policy=FreshnessPolicy(coalesce=64,
                                                resolve_every=2500),
                         resolve_opts=dict(tol=DRIVER_TOL))
    t0 = time.perf_counter()
    rep = ing.ingest(log)
    wall = time.perf_counter() - t0
    ref = make_engine("reference", graph=drv.host.graph(),
                      activity=drv.host.activity(), dtype=torch.float64,
                      device="cuda").run(tol=1e-12)
    check(rep.events_total == len(log) and rep.resolves >= 3,
          f"driver stream: {rep.events_total} of {len(log)} events, "
          f"{rep.resolves} resolves")
    _hold("stream", ing.psi(), ref.psi, out)
    out["ms"]["stream"] = wall * 1e3
    out["stream"] = dict(events=len(log), resolves=rep.resolves,
                         ev_per_s=len(log) / wall)
    say(f"driver stream: {len(log)} burst events into the AsyncPsiDriver "
        f"target in {wall:.2f} s ({len(log) / wall:.0f} ev/s), "
        f"{rep.resolves} resolves; ψ held against the f64 reference")


def driver_cli(out) -> None:
    """``serve --executor sync`` and ``--executor async`` on the card, one
    subprocess each, side by side; both must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {ex: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "psi-score", "--executor", ex, "--device", "cuda"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for ex in ("sync", "async")}
    for ex, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        check(proc.returncode == 0, f"serve --executor {ex} exited "
              f"{proc.returncode}: {stderr[-2000:]}")
        first = next(ln for ln in stdout.splitlines()
                     if ln.startswith("[serve] executor="))
        say(f"cli: {first}")
    out["ms"]["cli"] = (time.perf_counter() - t0) * 1e3


def phase_driver(report: dict) -> None:
    """The fault-tolerant driver path (``serve --executor sync|async``) on
    the twitter stand-in at Table II's size: :func:`driver_sync`,
    :func:`driver_async`, :func:`driver_stream` and :func:`driver_cli`. No
    kernel of the port runs on it (the sums are ``torch.segment_reduce``,
    the collectives NCCL's at world size 1)."""
    import tempfile

    import torch
    from repro_torch.core import heterogeneous, make_engine
    g = report["twitter"]
    act = heterogeneous(g.n, seed=6)
    t_all = time.perf_counter()
    ref = make_engine("reference", graph=g, activity=act,
                      dtype=torch.float64, device="cuda").run(tol=1e-12).psi
    out = dict(counts=[], ms={}, rel_l1={})
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        driver_sync(report, g, act, ref, out, tmp)
        driver_async(report, g, act, ref, out, tmp)
    driver_stream(report, g, act, out)
    driver_cli(out)
    check(out["counts"] == DRIVER_ITERS, f"driver counts {out['counts']} "
          f"!= DRIVER_ITERS {DRIVER_ITERS}")
    out["ms"]["path"] = (time.perf_counter() - t_all) * 1e3
    say(f"driver: counts {out['counts']} == DRIVER_ITERS; host ms by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["ms"].items())
        + "; worst rel L1 from the f64 reference "
        f"{max(out['rel_l1'].values()):.3e}")
    report["driver"] = out


# --------------------------------------------------------------------- #
# The resilience path (serve --chaos) and the rest of obs
# --------------------------------------------------------------------- #
def _chaos_gate(tag, out, **kw) -> dict:
    """``run_chaos`` at float64 on the card; its own assertions (parity,
    every fault class injected, none unsurvived) become smoke failures."""
    import torch
    from repro_torch.resilience.check import run_chaos
    t0 = time.perf_counter()
    try:
        report, metrics = run_chaos(dtype=torch.float64, device="cuda", **kw)
    except AssertionError as exc:
        raise SmokeFailure(f"chaos {tag}: {exc}") from exc
    wall = time.perf_counter() - t0
    missing = [k for k in CHAOS_FAULTS if not report.injected.get(k)]
    check(metrics["parity_err"] <= 1e-12 and not report.unsurvived
          and not missing, f"chaos {tag}: parity {metrics['parity_err']:.3e}"
          f" (limit 1e-12), unsurvived {report.unsurvived}, never injected "
          f"{missing}")
    say(f"chaos {tag}: n={metrics['n']} m={metrics['m']} "
        f"{metrics['events']} events, solver tol {metrics['solver_tol']:g}, "
        f"max|dpsi| {metrics['parity_err']:.3e} (limit 1e-12), recovered at "
        f"offset {metrics['offset']} (step {metrics['recovered_step']}), "
        f"{metrics['restarts']} restarts; oracle {metrics['oracle_wall_s']:.2f}"
        f" s (ingest {metrics['oracle_ingest_s']:.2f} s), chaos "
        f"{metrics['chaos_wall_s']:.2f} s, overhead "
        f"{metrics['recovery_overhead']:.2f}x, mttr "
        f"{metrics['mttr_s'] * 1e3:.1f} ms, ladder deadline "
        f"{metrics['ladder_deadline_s']:.3f} s (hang "
        f"{metrics['ladder_hang_s']:.3f} s); injected "
        f"{dict(sorted(report.injected.items()))}; {wall:.1f} s in all")
    out[tag] = dict(metrics, wall_s=wall)
    return metrics


def chaos_guard(report, out, tmp) -> None:
    """``ServiceGuard`` over a float32 ``cuda`` service on the twitter
    stand-in: a healthy patch checkpointed, a NaN patch rejected at the
    wall (state untouched), an α-raising patch rolled back to ψ bit for bit
    a fresh service's cold solve with the checkpointed rates, in as many
    iterations."""
    import torch
    from repro_torch.core import Activity, PsiService, heterogeneous
    from repro_torch.resilience import Sentinels, ServiceGuard
    g = report["twitter"]
    act = heterogeneous(g.n, seed=6)
    svc = PsiService(g, act, tol=1e-8, max_iter=400, backend="cuda",
                     device="cuda")
    guard = ServiceGuard(svc, tmp, sentinels=Sentinels(alpha_max=0.999))
    u = 17
    check(guard.update_activity(np.asarray([u]),
                                lam=np.asarray([act.lam[u] * 1.3])),
          "chaos guard: the healthy patch was refused")
    good = guard.scores().copy()
    rates = svc.engine.activity
    check(not guard.update_activity(np.asarray([u]),
                                    lam=np.asarray([np.nan]))
          and guard.rejected_patches == 1, "chaos guard: NaN patch accepted")
    now = svc.engine.activity
    check(np.array_equal(guard.scores(), good)
          and np.array_equal(now.lam, rates.lam)
          and np.array_equal(now.mu, rates.mu),
          "chaos guard: the rejected patch moved the service")
    rolls = []
    rollback = guard.rollback

    def timed_rollback():
        t0 = time.perf_counter()
        rollback()
        torch.cuda.synchronize()
        rolls.append(time.perf_counter() - t0)

    guard.rollback = timed_rollback
    hub = int(np.argmax(g.in_degree))
    t0 = time.perf_counter()
    accepted = guard.update_activity(np.asarray([hub]), mu=np.asarray([1e12]))
    poisoned_s = time.perf_counter() - t0
    trip = guard.sentinels.trips[-1] if guard.sentinels.trips else None
    check(not accepted and guard.rollbacks == 1 and trip is not None,
          f"chaos guard: α patch accepted {accepted}, rollbacks "
          f"{guard.rollbacks}")
    cold = PsiService(g, Activity(rates.lam, rates.mu), tol=1e-8,
                      max_iter=400, backend="cuda", device="cuda")
    want = cold.scores()
    its, want_its = svc.last_result.iterations, cold.last_result.iterations
    check(np.array_equal(guard.scores(), want) and its == want_its,
          f"chaos guard: rolled-back ψ not bitwise a cold solve with the "
          f"checkpointed rates ({int((guard.scores() != want).sum())} "
          f"entries differ; {its} vs {want_its} iterations)")
    out["guard"] = dict(rollback_s=rolls[0], poisoned_update_s=poisoned_s,
                        iterations=its)
    say(f"chaos guard: healthy patch checkpointed; NaN patch rejected, "
        f"state untouched; α patch on user {hub} tripped {trip}, rolled back "
        f"in {rolls[0] * 1e3:.1f} ms ({poisoned_s * 1e3:.1f} ms for the whole "
        f"poisoned update), ψ bitwise a cold solve in {its} iterations")
    del svc, cold


def chaos_quarantine(report, out) -> None:
    """``LaneQuarantine`` over the ``fleet`` phase's ``TenantFleet("auto")``
    against a deep copy of it taken first: a NaN patch on one tenant is
    rejected and its lane serves its last ψ bit for bit; an α patch on
    another is reverted and frozen; every other kernel-regime lane takes the
    same healthy patch in both fleets, re-solves, and is bitwise the copy's
    lane, in as many iterations."""
    import copy
    from repro_torch.resilience import FaultPlan, LaneQuarantine, Sentinels
    fleet = report["fleet"]
    # the copy shares the batched loops (stateless but for a retrace count)
    twin = copy.deepcopy(fleet, {id(fleet._machinery): fleet._machinery})
    quar = LaneQuarantine(fleet, sentinels=Sentinels(alpha_max=0.999))
    lanes = [t for t in fleet.tenant_ids
             if fleet.occupancy()[fleet.spec_of(t)]["regime"] == "cuda"]
    nan_t, alpha_t = lanes[0], lanes[-1]
    last = fleet.psi(nan_t).copy()
    host = fleet._rec(nan_t).host
    users = np.arange(4)
    clock = FaultPlan(seed=9, poison_kind="nan").clock()
    pu, pl, pm = clock.poison_patch(users, host.lam[users], host.mu[users])
    check(not quar.patch_activity(nan_t, pu, lam=pl, mu=pm)
          and quar.is_frozen(nan_t), f"chaos quarantine: NaN patch on "
          f"{nan_t} accepted")
    rng = np.random.default_rng(11)
    patched = [t for t in lanes if t not in (nan_t, alpha_t)]
    for t in patched:
        u = int(rng.integers(0, fleet.stats(t)["n"]))
        lam = np.asarray([fleet._rec(t).host.lam[u] * 1.5])
        check(quar.patch_activity(t, np.asarray([u]), lam=lam),
              f"chaos quarantine: healthy patch on {t} refused")
        twin.patch_activity(t, np.asarray([u]), lam=lam)
    hub = int(np.argmax(np.bincount(fleet._rec(alpha_t).host.dst_by_dst)))
    check(not quar.patch_activity(alpha_t, np.asarray([hub]),
                                  mu=np.asarray([1e12]))
          and quar.is_frozen(alpha_t) and quar.reverted_patches == 1,
          f"chaos quarantine: α patch on {alpha_t} not reverted and frozen")
    frozen = quar.psi(alpha_t)
    fleet.solve()
    twin.solve()
    check(np.array_equal(quar.psi(nan_t), last)
          and np.array_equal(quar.psi(alpha_t), frozen)
          and not quar.patch_activity(nan_t, np.asarray([0]),
                                      lam=np.asarray([0.5])),
          "chaos quarantine: a frozen lane moved or took a patch")
    for t in fleet.tenant_ids:
        if t in (nan_t, alpha_t):
            continue
        check(np.array_equal(quar.psi(t), twin.psi(t))
              and fleet.stats(t)["iterations"] == twin.stats(t)["iterations"],
              f"chaos quarantine: lane {t} differs from the fleet without "
              f"the quarantine")
    rev = fleet.stats(alpha_t)
    out["quarantine"] = dict(frozen=list(quar.frozen), patched=len(patched),
                             reverted_iterations=rev["iterations"])
    say(f"chaos quarantine: {nan_t} frozen by a NaN patch (ψ bitwise its "
        f"last), {alpha_t} reverted and frozen by an α patch (its re-solve "
        f"on the reverted rates: {rev['iterations']} iterations, gap "
        f"{rev['gap']:.3e}); {len(patched)} kernel lanes patched and "
        f"re-solved, every other lane of the {len(fleet.tenant_ids)} bitwise "
        f"the fleet without the quarantine")
    del twin


def chaos_cli_start(tmp) -> dict:
    """Start ``serve --stream burst --chaos --slo --watch --profile-out``
    and ``obs.check --device cuda`` on the card, side by side, in the
    background (:func:`chaos_cli_finish` collects them)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    folded = Path(tmp) / "profile.folded"
    cmds = {"serve": ["-m", "repro_torch.launch.serve", "--arch", "psi-score",
                      "--stream", "burst", "--chaos", "--slo", "--watch",
                      "--profile-out", str(folded), "--device", "cuda"],
            "obs.check": ["-m", "repro_torch.obs.check", "--device", "cuda",
                          "--out-dir", str(Path(tmp) / "obs_check")]}
    procs = {k: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in cmds.items()}
    return dict(procs=procs, folded=folded, t0=time.perf_counter())


def chaos_cli_finish(cli, out) -> None:
    """Both subprocesses exit 0; the drill prints the watch's pre-emption
    (no sentinel trip), at least one SLO verdict and a non-empty
    folded-stacks file."""
    stdout = {}
    for k, proc in cli["procs"].items():
        try:
            stdout[k], stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        check(proc.returncode == 0, f"chaos cli {k} exited "
              f"{proc.returncode}: {stdout[k][-2000:]} {stderr[-2000:]}")
    lines = stdout["serve"].splitlines()
    pre = [ln for ln in lines if "supervisor pre-empted" in ln]
    slo = [ln for ln in lines if ln.startswith("[slo] ")
           and "catalog armed" not in ln]
    check(len(pre) == 1 and "sentinel trips in watched arm: none" in pre[0],
          f"chaos cli: no clean pre-emption line in {pre}")
    check(len(slo) >= 1, "chaos cli: no [slo] verdict printed")
    folded = cli["folded"]
    check(folded.exists() and folded.stat().st_size > 0,
          "chaos cli: the folded-stacks file is missing or empty")
    out["cli_s"] = time.perf_counter() - cli["t0"]
    for ln in (next(ln for ln in lines if "chaos drill" in ln), pre[0],
               *slo, stdout["obs.check"].splitlines()[-1]):
        say(f"chaos cli: {ln}")
    say(f"chaos cli: both subprocesses done {out['cli_s']:.1f} s after "
        f"their start")


def phase_chaos(report: dict) -> None:
    """The resilience path (``serve --chaos``) and the rest of obs on the
    card: (a) the JAX package's f64 chaos gate (n = 200) on the
    ``AsyncPsiDriver`` stack, (b) the same gate at the twitter stand-in's
    size through ``run_chaos``'s own ``powerlaw_configuration``, the
    horizon cut to ~``CHAOS_EVENTS`` events, (c) :func:`chaos_guard`, (d)
    :func:`chaos_quarantine`, (e) the CLI drill and ``obs.check`` as two
    subprocesses, started first and collected last. Parts (c) and (d) run
    ``power_step``, ``edge_spmv`` and the lane kernels; (a) and (b) push
    with ``torch.segment_reduce`` (the async chunk step)."""
    import tempfile
    from repro_torch.core import heterogeneous
    t_all = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cli_tmp:
        cli = chaos_cli_start(cli_tmp)
        try:
            _chaos_gate("gate", out, n=200, m=1200, horizon=3)
            n, m = CHAOS_SIZE
            horizon = CHAOS_EVENTS / float(
                heterogeneous(n, seed=51).total.sum())
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                _chaos_gate("twitter-size", out, n=n, m=m, horizon=horizon,
                            solver_tol=CHAOS_SOLVER_TOL, workdir=tmp)
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                chaos_guard(report, out, tmp)
            chaos_quarantine(report, out)
            chaos_cli_finish(cli, out)
        finally:
            for proc in cli["procs"].values():
                proc.kill()
    out["path_s"] = time.perf_counter() - t_all
    say(f"chaos: path {out['path_s']:.1f} s")
    report["chaos"] = out


# --------------------------------------------------------------------- #
# The LM family: training, prefill and decode at full width
# --------------------------------------------------------------------- #
def _lm_cfg(arch: str, **kw):
    """The full config of ``arch`` with the fields in ``kw`` replaced."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).config(), **kw)


def _lm_batch(vocab: int, batch: int, seq: int, seed: int, dev) -> dict:
    """A ``TokenPipeline`` batch (step 0 of ``seed``) on ``dev``."""
    import torch
    from repro_torch.data import TokenPipeline
    b = TokenPipeline(vocab=vocab, seq_len=seq, global_batch=batch,
                      seed=seed).batch(0)
    return {k: torch.from_numpy(v).to(dev, torch.long) for k, v in b.items()}


def _timed(fn):
    """(result, ms) of one call of ``fn`` by CUDA events."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _cast(params, dtype):
    """A copy of ``params`` in ``dtype``, without autograd."""
    from repro_torch.train.optim import tree_map
    return tree_map(lambda t: t.detach().to(dtype), params)


def _hold_logits(tag, got, want, out) -> None:
    """``got`` within LM_LOGIT_TOL of ``want`` (the JAX test's rtol = atol);
    the worst share of the limit kept in ``out``."""
    err, share = _compare(tag, got, want, *LM_LOGIT_TOL)
    out["logit_share"] = max(out.get("logit_share", 0.0), share)
    out["logit_err"] = max(out.get("logit_err", 0.0), err)


def lm_train(out: dict, dev: str = "cuda") -> None:
    """(a) ``tinyllama-1.1b`` at full width and depth: the trainer CLI at
    ``train_4k`` (seq 4,096, batch cut to 8, 4 microbatches a step), then
    LM_FIXED_STEPS steps on one fixed batch at LM_FIXED_LR (the loss must
    fall; the last step under the profiler), then one step's loss and
    gradients at f32 against f64 and the bf16 loss of the same batch
    against the f32 one."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models.transformer import (init_params, loss_fn,
                                                make_train_step)
    from repro_torch.models.transformer.model import _value_and_grad
    from repro_torch.train.optim import adamw, constant_schedule, tree_leaves
    _free()
    run = train.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                      "--steps", str(LM_CLI_STEPS), "--device", dev])
    check(all(np.isfinite(run["losses"])),
          f"lm train_4k: a loss is not finite: {run['losses']}")
    ms = float(np.median(run["step_ms"][1:]))
    out["train_4k"] = dict(losses=run["losses"], step_ms=ms,
                           tokens_s=run["tokens"] / ms * 1e3,
                           peak_gib=_peak_gib())
    say(f"lm train_4k: {run['tokens']} tokens a step, median step "
        f"{ms:.1f} ms ({run['tokens'] / ms * 1e3:.0f} tokens/s), peak "
        f"{_peak_gib():.2f} GiB; losses {run['losses']}")
    del run
    _free()

    cfg = _lm_cfg("tinyllama-1.1b")
    batch, seq = LM_FIXED
    params = init_params(cfg, 1, device=dev)
    opt = adamw(constant_schedule(LM_FIXED_LR))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    b = _lm_batch(cfg.vocab, batch, seq, 1, dev)
    losses, times = [], []

    def one():
        nonlocal params, state
        params, state, loss = step(params, state, b)
        losses.append(float(loss))

    for _ in range(LM_FIXED_STEPS - 1):
        times.append(_timed(one)[1])
    busy, _ = profile_run("lm fixed-batch step", one)   # float(loss) syncs
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"lm fixed batch: the loss did not fall: {losses}")
    ms = float(np.median(times[1:]))
    out["fixed"] = dict(losses=losses, step_ms=ms, busy=busy,
                        tokens_s=batch * seq / ms * 1e3,
                        peak_gib=_peak_gib())
    say(f"lm fixed batch {batch} x {seq}: losses {losses}; step {ms:.1f} "
        f"ms ({batch * seq / ms * 1e3:.0f} tokens/s), busy "
        f"{(busy or 0):.1%}, peak {_peak_gib():.2f} GiB")
    del params, state, step, opt
    _free()

    cfg32 = _lm_cfg("tinyllama-1.1b", dtype=torch.float32,
                    param_dtype=torch.float32)
    cfg64 = _lm_cfg("tinyllama-1.1b", dtype=torch.float64,
                    param_dtype=torch.float64)
    p32 = init_params(cfg32, 2, device=dev)
    p64 = _cast(p32, torch.float64)
    for t in tree_leaves(p64):
        t.requires_grad_()
    b = _lm_batch(cfg.vocab, *LM_F64, 2, dev)
    l32, g32 = _value_and_grad(p32, b, cfg32)
    l64, g64 = _value_and_grad(p64, b, cfg64)
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    grad_rel = max(float((a.double() - c).norm() / c.norm().clamp(min=1e-30))
                   for a, c in zip(tree_leaves(g32), tree_leaves(g64)))
    del p64, g32, g64
    with torch.no_grad():
        l16 = float(loss_fn(_cast(p32, torch.bfloat16), b, cfg))
    bf16_rel = abs(l16 - float(l32)) / abs(float(l32))
    out.update(f64_loss_rel=loss_rel, f64_grad_rel=grad_rel,
               bf16_loss_rel=bf16_rel)
    say(f"lm f32 step vs f64 (batch {LM_F64[0]} x {LM_F64[1]}): loss "
        f"{float(l32):.6f} vs {float(l64):.6f} (rel {loss_rel:.2e}), worst "
        f"gradient leaf rel L2 {grad_rel:.2e}; bf16 loss {l16:.6f} (rel "
        f"{bf16_rel:.2e})")
    check(loss_rel <= LM_LOSS_RTOL, f"lm f32 loss vs f64: {loss_rel:.3e}")
    check(grad_rel <= LM_GRAD_REL_L2, f"lm f32 grads vs f64: {grad_rel:.3e}")
    check(bf16_rel <= LM_BF16_LOSS_RTOL,
          f"lm bf16 loss vs f32: {bf16_rel:.3e}")
    del p32
    _free()


def lm_serve(out: dict, dev: str = "cuda") -> None:
    """(b) ``tinyllama-1.1b`` at full width and depth through the serving
    CLI, ``--shape prefill_32k``: a bf16 prefill of 1 × LM_PREFILL tokens
    (batch cut from 32) and LM_DECODE_STEPS greedy decode steps on its
    cache, then one more decode step on that cache under the profiler; at
    f32 the prefill of 1 × LM_CHECK_PROMPT and LM_DECODE_STEPS decode steps
    (teacher-forced) against ``forward`` over LM_CHECK_FORWARD tokens (the
    blocked schedule; causal, so the tail beyond the decoded positions does
    not reach them)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import (forward, init_params,
                                                make_decode_step,
                                                make_prefill)
    cfg = _lm_cfg("tinyllama-1.1b")
    _free()
    run = serve.main(["--arch", "tinyllama-1.1b", "--shape", "prefill_32k",
                      "--gen-len", str(LM_DECODE_STEPS + 1), "--requests",
                      "1", "--device", dev])
    cache, logits = run["cache"], run["logits"]
    check(bool(torch.isfinite(logits).all()), "lm prefill_32k: non-finite "
          "logits")
    check(run["tokens"][0].shape == (1, LM_DECODE_STEPS + 1)
          and cache["t"] == LM_PREFILL + LM_DECODE_STEPS,
          f"lm prefill_32k: generated {run['tokens'][0].shape}, cache at "
          f"{cache['t']}")
    decode = make_decode_step(run["cfg"])
    busy, _ = profile_run("lm decode step", lambda: (
        decode(run["params"], cache, torch.argmax(logits, -1)),
        torch.cuda.synchronize()))
    pre_ms, dec_ms = run["prefill_ms"][0], run["decode_ms"][0]
    out["prefill_32k"] = dict(prefill_ms=pre_ms,
                              tokens_s=LM_PREFILL / pre_ms * 1e3,
                              decode_ms=dec_ms, decode_busy=busy,
                              cache_mb=run["cache_bytes"] / 1e6,
                              peak_gib=_peak_gib())
    say(f"lm prefill_32k (serve CLI): prefill 1 x {LM_PREFILL} {pre_ms:.1f} "
        f"ms ({LM_PREFILL / pre_ms * 1e3:.0f} tokens/s); decode {dec_ms:.2f}"
        f" ms a token (busy {(busy or 0):.1%}), cache "
        f"{run['cache_bytes'] / 1e6:.1f} MB, peak {_peak_gib():.2f} GiB; "
        f"generated {run['tokens'][0][0].tolist()[:8]}...")
    del run, cache, logits
    _free()

    cfg32 = _lm_cfg("tinyllama-1.1b", dtype=torch.float32,
                    param_dtype=torch.float32)
    p32 = init_params(cfg32, 3, device=dev)
    rng = np.random.default_rng(3)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_CHECK_FORWARD))
                           ).to(dev)
    n = LM_CHECK_PROMPT
    with torch.no_grad():
        full = forward(p32, seq, cfg32)
    prefill = make_prefill(cfg32, max_len=n + LM_DECODE_STEPS)
    decode = make_decode_step(cfg32)
    cache, lg = prefill(p32, seq[:, :n])
    _hold_logits("lm prefill f32", lg, full[:, n - 1], out)
    for t in range(n, n + LM_DECODE_STEPS):
        cache, lg = decode(p32, cache, seq[:, t])
        _hold_logits(f"lm decode f32 t={t}", lg, full[:, t], out)
    say(f"lm f32 prefill 1 x {n} + {LM_DECODE_STEPS} decode steps against "
        f"forward over {LM_CHECK_FORWARD}: max abs err "
        f"{out['logit_err']:.2e} ({out['logit_share']:.3f} of the limit)")
    del full, cache, p32
    _free()


def lm_moe(out: dict, dev: str = "cuda") -> None:
    """(c) ``mixtral-8x7b`` at full width, depth cut to 2: a bf16 prefill of
    1 × MOE_PREFILL tokens (the banded schedule) with the config's
    capacity factor, each expert's dropped tokens per layer, MOE_DECODE
    greedy steps past the window on the rolling cache; at f32 with capacity
    factor E/K (capacity = tokens: nothing can drop) the prefill and
    MOE_DECODE teacher-forced decode steps against ``forward`` over
    MOE_FORWARD tokens; then one bf16 AdamW step at depth 1, seq
    MOE_TRAIN_SEQ, batch 1."""
    import dataclasses
    import torch
    from repro_torch.models.transformer import (MoECfg, forward, init_params,
                                                make_decode_step,
                                                make_prefill,
                                                make_train_step)
    from repro_torch.train.optim import adamw, cosine_schedule
    cfg = _lm_cfg("mixtral-8x7b", n_layers=2)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                param_dtype=torch.float32)
    p32 = init_params(cfg32, 4, device=dev)
    p16 = _cast(p32, torch.bfloat16)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, MOE_PREFILL))
                            ).to(dev)
    drops: list = []
    prefill = make_prefill(cfg, max_len=MOE_PREFILL + MOE_DECODE + 1,
                           moe_drops=drops)
    decode = make_decode_step(cfg)
    _free()
    (cache, logits), pre_ms = _timed(lambda: prefill(p16, toks))
    dropped = [d.tolist() for d in drops]
    gen = [torch.argmax(logits, -1)]

    def steps():
        nonlocal cache, logits
        for _ in range(MOE_DECODE):
            cache, logits = decode(p16, cache, gen[-1])
            gen.append(torch.argmax(logits, -1))

    _, dec_ms = _timed(steps)
    dec_ms /= MOE_DECODE
    check(bool(torch.isfinite(logits).all()), "lm mixtral: non-finite logits")
    check(cache["k"].shape[2] == cfg.sliding_window and cache["t"] ==
          MOE_PREFILL + MOE_DECODE, "lm mixtral: not the rolling cache")
    busy, _ = profile_run("lm mixtral prefill", lambda: (
        prefill(p16, toks), torch.cuda.synchronize()))
    drops.clear()
    out["mixtral"] = dict(prefill_ms=pre_ms, tokens_s=MOE_PREFILL / pre_ms
                          * 1e3, prefill_busy=busy, decode_ms=dec_ms,
                          dropped=dropped, peak_gib=_peak_gib())
    say(f"lm mixtral-8x7b (2 layers) prefill 1 x {MOE_PREFILL}: {pre_ms:.1f}"
        f" ms ({MOE_PREFILL / pre_ms * 1e3:.0f} tokens/s, busy "
        f"{(busy or 0):.1%}); decode {dec_ms:.2f} ms a token; dropped "
        f"tokens per layer per expert (capacity factor "
        f"{cfg.moe.capacity_factor}): {dropped}; peak {_peak_gib():.2f} GiB")
    del cache, logits, p16
    _free()

    E, K = cfg.moe.n_experts, cfg.moe.top_k
    cfg32 = dataclasses.replace(cfg32, moe=MoECfg(E, K, E / K))
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, MOE_FORWARD))
                           ).to(dev)
    n = MOE_PREFILL
    fdrops: list = []
    with torch.no_grad():
        full = forward(p32, seq, cfg32, moe_drops=fdrops)
    check(sum(int(d.sum()) for d in fdrops) == 0, "lm mixtral f32: dropped")
    cache, lg = make_prefill(cfg32, max_len=n + MOE_DECODE)(p32, seq[:, :n])
    decode = make_decode_step(cfg32)
    moe = {}
    _hold_logits("lm mixtral prefill f32", lg, full[:, n - 1], moe)
    for t in range(n, n + MOE_DECODE):
        cache, lg = decode(p32, cache, seq[:, t])
        _hold_logits(f"lm mixtral decode f32 t={t}", lg, full[:, t], moe)
    out["mixtral"].update(logit_err=moe["logit_err"],
                          logit_share=moe["logit_share"])
    say(f"lm mixtral f32 prefill 1 x {n} + {MOE_DECODE} decode steps past the"
        f" window against forward over {MOE_FORWARD}: max abs err "
        f"{moe['logit_err']:.2e} ({moe['logit_share']:.3f} of the limit)")
    del full, cache, p32
    _free()

    cfg1 = _lm_cfg("mixtral-8x7b", n_layers=1, accum_steps=1)
    params = init_params(cfg1, 5, device=dev)
    opt = adamw(cosine_schedule(3e-3, 1, 1))
    state = opt.init(params)
    b = _lm_batch(cfg1.vocab, 1, MOE_TRAIN_SEQ, 5, dev)
    (_, _, loss), ms = _timed(lambda: make_train_step(cfg1, opt)(
        params, state, b))
    check(bool(np.isfinite(float(loss))), "lm mixtral train step: loss")
    out["mixtral"].update(train_ms=ms, train_loss=float(loss),
                          train_peak_gib=_peak_gib())
    say(f"lm mixtral-8x7b (1 layer) AdamW step, batch 1 x {MOE_TRAIN_SEQ}: "
        f"loss {float(loss):.4f}, {ms:.1f} ms, peak {_peak_gib():.2f} GiB")
    del params, state, opt
    _free()


def lm_widths(out: dict, dev: str = "cuda") -> None:
    """(d) ``yi-9b``, ``nemotron-4-340b`` and ``mixtral-8x22b`` at full
    width, one layer each: a bf16 prefill of 1 × LM_WIDE_PROMPT and one
    decode step; finite logits, peak memory."""
    import torch
    from repro_torch.models.transformer import (init_params,
                                                make_decode_step,
                                                make_prefill)
    out["widths"] = {}
    for arch in LM_WIDE_ARCHS:
        _free()
        cfg = _lm_cfg(arch, n_layers=1)
        params = init_params(cfg, 6, device=dev)
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab, (1, LM_WIDE_PROMPT))).to(dev)
        (cache, logits), pre_ms = _timed(lambda: make_prefill(
            cfg, max_len=LM_WIDE_PROMPT + 1)(params, toks))
        (cache, logits2), dec_ms = _timed(lambda: make_decode_step(cfg)(
            params, cache, torch.argmax(logits, -1)))
        check(bool(torch.isfinite(logits).all())
              and bool(torch.isfinite(logits2).all()),
              f"lm {arch}: non-finite logits")
        out["widths"][arch] = dict(prefill_ms=pre_ms, decode_ms=dec_ms,
                                   peak_gib=_peak_gib())
        say(f"lm {arch} (1 layer, d {cfg.d_model}, vocab {cfg.vocab}): "
            f"prefill 1 x {LM_WIDE_PROMPT} {pre_ms:.1f} ms, a decode step "
            f"{dec_ms:.1f} ms, peak {_peak_gib():.2f} GiB")
        del params, cache, logits, logits2
    _free()


def phase_lm(report: dict) -> None:
    """The LM family on the card (no kernel of the port runs on it):
    :func:`lm_train`, :func:`lm_serve`, :func:`lm_moe`, :func:`lm_widths`."""
    t0 = time.perf_counter()
    out: dict = {}
    _free()
    lm_train(out)
    lm_serve(out)
    lm_moe(out)
    lm_widths(out)
    out["path_s"] = time.perf_counter() - t0
    say(f"lm: path {out['path_s']:.1f} s")
    report["lm"] = out


# --------------------------------------------------------------------- #
# The recsys family: MIND training, serving and retrieval at full width
# --------------------------------------------------------------------- #
def _tensor_rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp(min=1e-300))


def recsys_train(out: dict, dev: str = "cuda") -> None:
    """(a) ``repro_torch.launch.train --arch mind --shape train_batch`` for
    RECSYS_CLI_STEPS steps (every loss finite; the median step of 2 on),
    then one more step of the run under the profiler. (b) One step on the
    first RECSYS_SLICE users of the run's last batch at f32 against f64 on
    the card, both through seg_mm: loss rel RECSYS_LOSS_RTOL, each gradient
    leaf rel L2 RECSYS_GRAD_REL_L2, ``b_init``'s gradient 0. (c)
    RECSYS_FIXED_STEPS steps on that slice at a constant RECSYS_FIXED_LR:
    the loss must fall."""
    import dataclasses
    import torch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import train
    from repro_torch.models.recsys import mind
    from repro_torch.train.optim import adamw, constant_schedule
    _free()
    run = train.main(["--arch", "mind", "--shape", "train_batch", "--steps",
                      str(RECSYS_CLI_STEPS), "--device", dev])
    check(all(np.isfinite(run["losses"])),
          f"recsys train_batch: a loss is not finite: {run['losses']}")
    cfg, users = run["cfg"], run["users"]
    ms = float(np.median(run["step_ms"][1:]))
    peak = _peak_gib()
    params, state, batch = run["params"], run["state"], run["batch"]
    before = seg_mm_call.launches
    busy, share = profile_run("recsys train_batch step", lambda: float(
        train.recsys_step(params, state, batch, cfg, run["opt"])[2]),
        kernel="seg_mm")
    check(seg_mm_call.launches > before, "recsys: the profiled step "
          "launched no seg_mm")
    out["train_batch"] = dict(losses=run["losses"], step_ms=ms,
                              users_s=users / ms * 1e3, busy=busy,
                              seg_mm_share=share, peak_gib=peak,
                              per_step=(seg_mm_call.launches - before))
    say(f"recsys train_batch (CLI): {users} users a step, median step "
        f"{ms:.1f} ms ({users / ms * 1e3:.0f} users/s), busy "
        f"{(busy or 0):.1%}, seg_mm {(share or 0):.2%} of device time, "
        f"peak {peak:.2f} GiB; losses {run['losses']}")
    host = train.slice_users(run["host"], 0, RECSYS_SLICE)
    del run, params, state, batch
    _free()

    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    p32 = mind.init_params(cfg, 1, device=dev)
    p64 = {k: v.detach().double().requires_grad_() for k, v in p32.items()}
    b = train.recsys_device_batch(host, cfg, dev)
    l32, g32 = mind.loss_and_grads(p32, b, cfg)
    l64, g64 = mind.loss_and_grads(p64, b, cfg64)
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    rels = {k: _tensor_rel_l2(g32[k], g64[k]) for k in g32
            if k != "b_init"}
    check(not g32["b_init"].any() and not g64["b_init"].any(),
          "recsys: b_init has a gradient")
    out.update(f64_loss_rel=loss_rel, f64_grad_rel=max(rels.values()))
    say(f"recsys f32 step vs f64 ({RECSYS_SLICE} users, full tables): loss "
        f"{float(l32):.6f} vs {float(l64):.6f} (rel {loss_rel:.2e}); "
        f"gradient rel L2 {', '.join(f'{k} {v:.2e}' for k, v in rels.items())}"
        f"; b_init 0")
    check(loss_rel <= RECSYS_LOSS_RTOL, f"recsys f32 loss vs f64: "
          f"{loss_rel:.3e}")
    check(max(rels.values()) <= RECSYS_GRAD_REL_L2,
          f"recsys f32 grads vs f64: {rels}")
    del p64, g32, g64
    _free()

    opt = adamw(constant_schedule(RECSYS_FIXED_LR))
    state = opt.init(p32)
    losses, times = [], []

    def one():
        nonlocal p32, state
        p32, state, loss = train.recsys_step(p32, state, b, cfg, opt)
        losses.append(float(loss))

    for _ in range(RECSYS_FIXED_STEPS):
        times.append(_timed(one)[1])
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"recsys fixed batch: the loss did not fall: {losses}")
    out["fixed"] = dict(losses=losses, step_ms=float(np.median(times[1:])))
    say(f"recsys fixed batch ({RECSYS_SLICE} users, lr {RECSYS_FIXED_LR}): "
        f"losses {[round(x, 4) for x in losses]}; step "
        f"{out['fixed']['step_ms']:.1f} ms")
    del p32, state, opt, b
    _free()


def _interests_f64(run, users, cfg) -> object:
    """The f64 interests of the first ``users`` users of a serve run's last
    batch, from its parameters cast to f64 on the card."""
    import dataclasses
    import torch
    from repro_torch.models.recsys import mind
    b = run["batch"]
    p64 = _cast(run["params"], torch.float64)
    n = int(torch.searchsorted(b["profile_bags"], torch.tensor(
        users, device=b["profile_bags"].device)))
    with torch.no_grad():
        return mind.user_interests(
            p64, b["hist_ids"][:users], b["hist_mask"][:users],
            b["profile_ids"][:n], b["profile_bags"][:n],
            dataclasses.replace(cfg, dtype=torch.float64))


def recsys_serve(out: dict, dev: str = "cuda") -> None:
    """(d) ``repro_torch.launch.serve --arch mind --shape serve_p99`` and
    ``serve_bulk`` (RECSYS_SERVE_REQUESTS requests each): the first
    RECSYS_CHECK_USERS users' interests against f64 (max abs
    RECSYS_INTEREST_TOL). (e) ``--shape retrieval_cand``: the scores of the
    10⁶ candidates against the max of the per-interest products and the
    top-5 against a sort."""
    import torch
    from repro_torch.launch import serve
    for shape in ("serve_p99", "serve_bulk"):
        _free()
        run = serve.main(["--arch", "mind", "--shape", shape, "--requests",
                          str(RECSYS_SERVE_REQUESTS), "--device", dev])
        peak = _peak_gib()
        u = run["interests"]
        check(bool(torch.isfinite(u).all()) and u.shape == (
            run["users"], run["cfg"].n_interests, run["cfg"].embed_dim),
            f"recsys {shape}: interests {tuple(u.shape)} not finite")
        err = float((u[:RECSYS_CHECK_USERS].double() - _interests_f64(
            run, RECSYS_CHECK_USERS, run["cfg"])).abs().max())
        ms = float(np.median(run["ms"][1:]))
        out[shape] = dict(ms=ms, max_ms=max(run["ms"][1:]),
                          users_s=run["users"] / ms * 1e3,
                          prep_ms=float(np.median(run["prep_ms"][1:])),
                          f64_err=err, peak_gib=peak)
        say(f"recsys {shape} (serve CLI): {run['users']} users, interests "
            f"median {ms:.3f} ms (max {out[shape]['max_ms']:.3f}; "
            f"{out[shape]['users_s']:.0f} users/s), batch prepared in "
            f"{out[shape]['prep_ms']:.1f} ms, peak {peak:.2f} GiB; "
            f"{RECSYS_CHECK_USERS} users vs f64 max abs err {err:.2e}")
        check(err <= RECSYS_INTEREST_TOL, f"recsys {shape}: interests vs "
              f"f64 {err:.3e}")
        del run, u
    _free()
    run = serve.main(["--arch", "mind", "--shape", "retrieval_cand",
                      "--requests", str(RECSYS_SERVE_REQUESTS), "--device",
                      dev])
    scores, u = run["scores"], run["interests"][0]
    with torch.no_grad():
        per = run["params"]["item_emb"].index_select(
            0, run["cand_ids"]) @ u.T
    want = per.amax(dim=-1)
    err = float((scores - want).abs().max())
    _compare("recsys retrieval_cand scores", scores, want, RECSYS_SCORE_TOL,
             RECSYS_SCORE_TOL)
    best = torch.sort(scores, descending=True).values[:5]
    check(torch.equal(scores[torch.as_tensor(run["top"], device=dev)], best),
          "recsys retrieval_cand: the top-5 differs from a sort")
    ms = float(np.median(run["ms"][1:]))
    out["retrieval_cand"] = dict(ms=ms, max_ms=max(run["ms"][1:]),
                                 err=err)
    say(f"recsys retrieval_cand (serve CLI): {scores.numel()} candidates "
        f"scored in {ms:.3f} ms median (max {max(run['ms'][1:]):.3f}); "
        f"max abs err vs the per-interest max {err:.2e}; top-5 "
        f"{run['top'].tolist()} as a sort")
    del run, scores, per, want
    _free()


def phase_recsys(report: dict) -> None:
    """The recsys family on the card: :func:`recsys_train`,
    :func:`recsys_serve`; every bag sum through ``seg_mm``."""
    t0 = time.perf_counter()
    out: dict = {}
    recsys_train(out)
    recsys_serve(out)
    out["path_s"] = time.perf_counter() - t0
    say(f"recsys: path {out['path_s']:.1f} s")
    report["recsys"] = out


# --------------------------------------------------------------------- #
# The dry run of the production meshes
# --------------------------------------------------------------------- #
def start_dryrun_job(out_dir: Path) -> subprocess.Popen:
    """Part 1, started: the fake-mode dry run of every cell on both
    production meshes (``repro_torch.launch.dryrun --all --device cpu``:
    traced on FakeTensors, nothing on the card) with DRYRUN_WORKERS
    tracing workers at the lowest CPU priority (``nice`` 19), beside parts
    2 and 3; → its Popen handle."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(out_dir / "dryrun.log", "w")
    job = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--device", "cpu", "--jobs", str(DRYRUN_WORKERS),
         "--out", str(out_dir / "records")],
        env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
        preexec_fn=lambda: os.nice(19), start_new_session=True)
    job.log = log
    return job


def dryrun_real(out: dict) -> None:
    """Part 2: DRYRUN_REAL as rank 0 of the 16 x 16 mesh on the fake
    backend: traced on fake CUDA tensors (``seg_mm``'s registered fake),
    then made real on the card and run once; the measured peak within
    DRYRUN_MEM_RTOL of the estimate; the real run's ``seg_mm`` launches
    (a GNN cell's must be some)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.seg_mm import seg_mm_call
    from repro_torch.launch import dryrun, specs
    out["real"] = {}
    with dryrun.production_mesh(False, "cuda") as mesh:
        for arch, shape in DRYRUN_REAL:
            _free()
            entry = get_arch(arch)
            cell = specs.build_cell(entry, entry.shape(shape), mesh)
            before = seg_mm_call.launches
            rec = dryrun.run_cell(cell, mesh, "pod16x16", device="cuda")
            check(rec["ok"], f"dryrun {arch} {shape}: {rec.get('error')}")
            launches = seg_mm_call.launches - before
            est = rec["memory"]["peak_bytes"]
            got = rec["memory"]["measured_peak_bytes"]
            gap = (est - got) / got
            out["real"][f"{arch}/{shape}"] = dict(
                estimate=est, measured=got, gap=gap,
                device_ms=rec["device_ms"], trace_s=rec["trace_s"],
                flops=rec["cost"]["flops"], seg_mm_launches=launches,
                layout=rec["layout"],
                collectives={k: v["count"] for k, v in
                             rec["collectives"].items() if v["count"]})
            say(f"dryrun {arch} {shape} (rank 0 of 16x16): estimated peak "
                f"{est / 2**30:.3f} GiB, measured {got / 2**30:.3f} GiB "
                f"({gap:+.1%}); step {rec['device_ms']:.1f} ms on the card "
                f"(compute only); traced in {rec['trace_s']:.1f} s; flops "
                f"{rec['cost']['flops']:.4e}; seg_mm launches {launches}; "
                f"collectives "
                f"{out['real'][f'{arch}/{shape}']['collectives']}")
            if entry.family == "gnn":
                check(launches > 0, f"dryrun {arch} {shape}: no seg_mm "
                      "launch in the rank-0 step")
            check(abs(gap) <= DRYRUN_MEM_RTOL, f"dryrun {arch} {shape}: "
                  f"estimate {est} vs measured {got} ({gap:+.1%})")


def dryrun_bitwise(out: dict) -> None:
    """Part 3: at world 1 on the card a (1, 1) mesh gives the bits of
    mesh=None: TinyLlama at full width, DRYRUN_BITWISE layers x batch x
    seq, float32 — a train step (loss and every parameter after AdamW) and
    a prefill (logits and cache); PNA's full_graph_sm cell at full width —
    a train step (loss and every parameter), under deterministic
    algorithms (its gathers' backward adds with atomics otherwise, and two
    runs of one step differ)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import adamw, constant_schedule, tree_leaves
    layers, b, s = DRYRUN_BITWISE
    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").config(),
                              n_layers=layers, accum_steps=1,
                              dtype=torch.float32, param_dtype=torch.float32)
    gen = torch.Generator("cuda").manual_seed(3)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    batch = dict(tokens=tok, labels=torch.roll(tok, -1, 1))
    mesh = make_mesh((1, 1), device="cuda")
    try:
        runs = {}
        for name, m in (("none", None), ("mesh", mesh)):
            params = T.init_params(cfg, 0, device="cuda", mesh=m)
            opt = adamw(constant_schedule(1e-4))
            state = opt.init(params)
            params, state, loss = T.make_train_step(cfg, opt, m)(
                params, state, batch)
            cache, logits = T.make_prefill(cfg, m)(params, tok)
            runs[name] = [loss, logits, cache["k"], cache["v"]] + [
                p.detach() for p in tree_leaves(params)]
            # the GNN step's gathers add their cotangents with atomics
            # (index_add_): deterministic algorithms make each run
            # reproducible, so that the two runs can be compared bitwise
            entry = get_arch("pna")
            cell = specs.build_gnn_cell(entry, entry.shape("full_graph_sm"),
                                        m)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                gp, gs, gl = cell.step(*cell.make_args(torch.device("cuda")))
            finally:
                torch.use_deterministic_algorithms(False)
            runs[name] += [gl] + [p.detach() for p in tree_leaves(gp)]
        same = all(torch.equal(x, y) for x, y in zip(runs["none"],
                                                       runs["mesh"]))
    finally:
        mesh.close()
    out["bitwise"] = same
    say(f"dryrun: mesh (1, 1) vs mesh=None, a TinyLlama train step and a "
        f"prefill ({layers} layers, {b} x {s}, f32) and a PNA full_graph_sm "
        f"step: bitwise {same}")
    check(same, "mesh (1, 1) differs from mesh=None")


def dryrun_records(out: dict, job, out_dir: Path) -> None:
    """Part 1, finished: wait for the fake-mode run; every record ok and
    with the JAX record's keys, DRYRUN_RECORDS of them."""
    t0 = time.perf_counter()
    rc = job.wait()
    job.log.close()
    out["wait_s"] = time.perf_counter() - t0
    tail = (out_dir / "dryrun.log").read_text()[-2000:]
    check(rc == 0, f"dryrun CLI exited {rc}: {tail}")
    recs = [json.loads(p.read_text())
            for p in sorted((out_dir / "records").glob("*.json"))]
    skips = sum(1 for r in recs if r.get("skipped"))
    traced = [r for r in recs if not r.get("skipped")]
    keys = {"ok", "trace_s", "cost", "memory", "collectives", "meta"}
    for r in traced:
        check(r["ok"] and keys <= set(r), f"dryrun record {r['arch']} "
              f"{r['shape']} {r['mesh']}: {r.get('error')}")
    got = (len(recs), len(traced), skips)
    out["records"] = got
    out["trace_s"] = sum(r["trace_s"] for r in traced)
    top = max(traced, key=lambda r: r["trace_s"])
    say(f"dryrun: {got[0]} records ({got[1]} traced ok, {got[2]} skips) on "
        f"16x16 and 2x16x16, {out['trace_s']:.1f} s of tracing in "
        f"{DRYRUN_WORKERS} workers (the longest record {top['arch']} "
        f"{top['shape']} {top['mesh']}, {top['trace_s']:.1f} s), waited "
        f"{out['wait_s']:.1f} s after parts 2 and 3")
    check(got == DRYRUN_RECORDS, f"dryrun records {got} != {DRYRUN_RECORDS}")


def phase_dryrun(report: dict) -> None:
    """The dry run (``repro_torch.launch.dryrun``): part 1 started
    (:func:`start_dryrun_job`), :func:`dryrun_real` and
    :func:`dryrun_bitwise` beside it, then :func:`dryrun_records`; the
    path's seconds count the wait."""
    import os
    import signal
    import tempfile
    t0 = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        job = start_dryrun_job(Path(tmp))
        try:
            dryrun_real(out)
            _free()
            dryrun_bitwise(out)
            dryrun_records(out, job, Path(tmp))
        finally:
            if job.poll() is None:              # the CLI and its workers
                os.killpg(job.pid, signal.SIGKILL)
            job.wait()
            job.log.close()
    out["path_s"] = time.perf_counter() - t0
    say(f"dryrun: path {out['path_s']:.1f} s")
    report["dryrun"] = out


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
    kw = dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
    ms, dev_ms = both_ms(lambda: power_step_call(*args, **kw), 200)
    plain_ms = time_ms(lambda: power_step_plain(*args[:4], *args[6:],
                                                tile=fmt.tile), 200)
    csr = push_csr(eng.graph, torch.float32)
    x = s_pre[0, :fmt.n, None].contiguous()
    lib_ms, lib_dev_ms = both_ms(lambda: torch.sparse.mm(csr, x), 200)
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
        library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms))
    say(f"power_step (twitter, f32): {ms:.4f} ms/launch by CUDA events "
        f"({dev_ms:.4f} ms of device time), "
        f"{report['edge_tile_cold_launches']} launches per cold resolve, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB a step at 3.35 TB/s, "
        f"{real} real slots of {fmt.src_idx.numel()}; "
        f"the step's working set fits the 50 MB L2, so the loop runs warm "
        f"and is timed warm), plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm CSR push {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms of "
        f"device time)")
    del csr, x
    # power_step at the autotuner's other edge tiles, same graph and dtype
    by_tile = {256: (ms, dev_ms)}
    for tile in (128, 512):
        _, fmt_t, args_t = edge_tile_inputs(eng.graph, torch.float32,
                                            tile=tile)
        by_tile[tile] = both_ms(lambda: power_step_call(
            *args_t, n=fmt_t.n, tile=tile, tile_order=fmt_t.tile_order), 200)
    report["power_step_ms_by_tile"] = {t: v[0] for t, v in by_tile.items()}
    report["power_step_device_ms_by_tile"] = {t: v[1]
                                              for t, v in by_tile.items()}
    say("power_step (twitter, f32) ms/launch by tile, CUDA events (device "
        "time): " + ", ".join(f"{t}: {v[0]:.4f} ({v[1]:.4f})"
                              for t, v in sorted(by_tile.items())))
    del fmt_t, args_t
    # the tail of the in-degree skew, in device time: the same step with
    # every tile's slots dealt in order over its rows
    args_d = args[:2] + (deal_rows(fmt).dst_local,) + args[3:]
    dealt_ms = device_ms(lambda: power_step_call(*args_d, **kw), 200)
    report["skew_tail_device_ms"] = {"power_step_t256": dev_ms - dealt_ms}
    longest = (int(fmt.tile_num_blocks.max()) * fmt.src_idx[0].numel()
               // fmt.tile)
    say(f"power_step (twitter, t256, f32) with every tile's slots dealt in "
        f"order over its rows (no row longer than {longest} slots; the "
        f"largest in-degree is {int(eng.graph.in_degree.max())}): "
        f"{dealt_ms:.4f} ms/launch of device time; the skew's tail "
        f"{dev_ms - dealt_ms:.4f} ms")
    del args_d

    # bsr_spmv and bsr_step at the bsr service's shapes: clustered graph,
    # float32, one-byte tiles (33.5 MB: they fit the 50 MB L2, so back-to-
    # back launches run warm; cold_ms times one launch after an L2 flush)
    from repro_torch.kernels.bsr_spmv import bsr_step_call, bsr_step_plain
    eng = report["bsr_service"].engine
    fmt = eng.fmt
    s = report["bsr_service"].last_result.s
    s_pad = fmt.pad_source(s * eng.ops.inv_w)
    args = (s_pad, fmt.tiles, fmt.src_tile, fmt.dst_tile,
            fmt.dst_first_block, fmt.dst_num_blocks)
    kw = dict(num_dst_tiles=fmt.num_dst_tiles)
    ms, dev_ms = both_ms(lambda: bsr_spmv_call(*args, **kw), 200)
    cold = cold_ms(lambda: bsr_spmv_call(*args, **kw))
    plain_ms = time_ms(lambda: bsr_spmv_plain(*args[:4], **kw), 20)
    csr = push_csr(eng.graph, torch.float32)
    x = s_pad[0, :fmt.n, None].contiguous()
    lib_ms, lib_dev_ms = both_ms(lambda: torch.sparse.mm(csr, x), 200)
    elt = s.element_size()
    cells = int(fmt.tiles.numel())
    tables = (fmt.src_tile.nbytes + fmt.dst_first_block.nbytes
              + fmt.dst_num_blocks.nbytes)
    vecs = elt * (fmt.n_src_pad + fmt.num_dst_tiles * fmt.td)

    def floor_ms(nbytes, flops):
        return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3

    # the floor of the storage this run used (each tile cell read once in
    # one byte), beside the floor of f32 dense tiles and the floor
    # of a format that keeps only the nonzeros of the 0/1 matrix (their
    # int32 source ids, n + 1 row offsets, s_pre in and t out)
    nbytes = fmt.tiles.nbytes + tables + vecs
    bound = floor_ms(nbytes, 2 * cells)
    f32_bound = floor_ms(4 * cells + tables + vecs, 2 * cells)
    m = eng.graph.m
    nz_bytes = 4 * m + 4 * (fmt.n + 1) + 2 * elt * fmt.n
    nz_bound = nz_bytes / HBM_BYTES_PER_S * 1e3
    report["bsr_bounds_ms"] = dict(storage=bound, f32_tiles=f32_bound,
                                   nonzero=nz_bound)
    report["bsr_spmv_ms"] = dict(events=ms, device=dev_ms, cold=cold[0],
                                 library_device=lib_dev_ms)
    rows.append(dict(
        name="bsr_spmv", route="cuda",
        source="src/repro_torch/kernels/csrc/bsr_spmv.cu",
        replaces="src/repro/kernels/bsr_spmv.py:39",
        launches=report["launches"]["auto_microbench"]["bsr_spmv"],
        max_abs_err=report["max_abs_err"]["bsr_spmv"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= 2 * cells / F32_FLOP_PER_S else "operations"),
        library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms,
        cold_device_ms=cold[0]))
    say(f"bsr_spmv (clustered, f32, {fmt.tiles.dtype} tiles): {ms:.4f} "
        f"ms/launch by CUDA events ({dev_ms:.4f} ms of device time, warm: "
        f"the {fmt.tiles.nbytes / 1e6:.1f} MB of tiles fit the 50 MB L2), "
        f"one launch after an L2 flush min {cold[0]:.4f} / median "
        f"{cold[1]:.4f} ms; {rows[-1]['launches']} launches on the auto "
        f"--microbench path; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s, one byte a cell), f32 dense-tile floor {f32_bound:.4f} "
        f"ms, nonzero floor {nz_bound:.4f} ms ({nz_bytes / 1e6:.1f} MB); "
        f"plain {plain_ms:.4f} ms, torch.sparse.mm CSR push {lib_ms:.4f} ms "
        f"({lib_dev_ms:.4f} ms of device time)")
    del csr, x
    # the fused step, and the six-launch composition it replaced
    step = (s, eng.ops.inv_w, eng.ops.mu, eng.ops.c)
    skw = dict(n_src_pad=fmt.n_src_pad, **kw)
    tbl = (fmt.src_tile, fmt.dst_tile, fmt.dst_first_block,
           fmt.dst_num_blocks)
    ms_s, dev_s = both_ms(lambda: bsr_step_call(*step, fmt.tiles, *tbl,
                                                **skw), 200)
    plain_s = time_ms(lambda: bsr_step_plain(*step, fmt.tiles, *tbl[:2],
                                             **skw), 20)

    def unfused():
        t = bsr_spmv_call(fmt.pad_source(s * eng.ops.inv_w), fmt.tiles,
                          *tbl, **kw)[0, :fmt.n]
        s_new = eng.ops.mu * t + eng.ops.c
        return s_new, torch.sum(torch.abs(s_new - s))
    ms_u, dev_u = both_ms(unfused, 200)
    # the tiles and tables; s, 1/w, mu, c read and s_new written once (the
    # step stages s * 1/w itself and writes no padded t); the partials
    step_bytes = (fmt.tiles.nbytes + tables
                  + elt * (5 * fmt.n + fmt.num_dst_tiles))
    step_flops = 2 * cells + 5 * fmt.n
    bound_s = floor_ms(step_bytes, step_flops)
    report["bsr_step_ms"] = dict(events=ms_s, device=dev_s,
                                 unfused_events=ms_u, unfused_device=dev_u)
    rows.append(dict(
        name="bsr_step", route="cuda",
        source="src/repro_torch/kernels/csrc/bsr_spmv.cu",
        replaces="src/repro/kernels/bsr_spmv.py:39",
        launches=report["launches"]["bsr"]["bsr_step"],
        max_abs_err=report["max_abs_err"]["bsr_step"], ms=ms_s,
        plain_ms=plain_s, bound_ms=bound_s,
        bound_by=("bytes" if step_bytes / HBM_BYTES_PER_S
                  >= step_flops / F32_FLOP_PER_S else "operations"),
        library_ms=None, device_ms=dev_s, library_device_ms=None))
    say(f"bsr_step (clustered, f32): {ms_s:.4f} ms/launch by CUDA events "
        f"({dev_s:.4f} ms of device time), {report['bsr_cold_launches']} "
        f"launches per cold resolve, bound {bound_s:.4f} ms "
        f"({step_bytes / 1e6:.1f} MB: tiles, tables, s, 1/w, mu, c, "
        f"s_new, partials); the unfused composition (x 1/w, pad, push, mu *, + c, "
        f"gap) {ms_u:.4f} ms by events ({dev_u:.4f} ms of device time); "
        f"plain {plain_s:.4f} ms; no single library call")

    # edge_spmv at every autotuner tile, unweighted, f32, on the twitter
    # stand-in (the shapes the auto --microbench path times); its row is
    # tile 512, the tile the cost model picks
    from repro_torch.kernels.edge_spmv import edge_spmv_call, edge_spmv_plain
    from repro_torch.kernels.formats import build_edge_tiles
    from repro_torch.kernels.ops import DeviceEdgeTiles
    g = report["twitter"]
    s = torch.as_tensor(np.random.default_rng(0).random(g.n),
                        dtype=torch.float32, device="cuda")
    by_tile, tails = {}, report["skew_tail_device_ms"]
    for tile in (128, 256, 512):
        fmt = DeviceEdgeTiles.from_format(build_edge_tiles(g, tile=tile),
                                          "cuda")
        s_pre = fmt.pad_gather_source(s)
        args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
                fmt.tile_first_block, fmt.tile_num_blocks)
        kw = dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
        ms, dev_ms = by_tile[tile] = both_ms(
            lambda: edge_spmv_call(*args, **kw), 200)
        args_d = args[:2] + (deal_rows(fmt).dst_local,) + args[3:]
        tails[f"edge_spmv_t{tile}"] = dev_ms - device_ms(
            lambda: edge_spmv_call(*args_d, **kw), 200)
        del args_d
    report["edge_spmv_ms_by_tile"] = {t: v[0] for t, v in by_tile.items()}
    report["edge_spmv_device_ms_by_tile"] = {t: v[1]
                                             for t, v in by_tile.items()}
    say("edge_spmv (twitter, f32) ms/launch by tile, CUDA events (device "
        "time): " + ", ".join(f"{t}: {v[0]:.4f} ({v[1]:.4f})"
                              for t, v in sorted(by_tile.items()))
        + "; the skew's tail (device ms/launch less that with every tile's "
        "slots dealt in order over its rows): " + ", ".join(
            f"{k} {v:.4f}" for k, v in tails.items()))
    plain_ms = time_ms(lambda: edge_spmv_plain(
        *args[:4], tile=fmt.tile, num_tiles=fmt.num_tiles), 200)
    csr = push_csr(g, torch.float32)
    x = s_pre[0, :fmt.n, None].contiguous()
    lib_ms, lib_dev_ms = both_ms(lambda: torch.sparse.mm(csr, x), 200)
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
        library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms))
    say(f"edge_spmv (twitter, tile 512, f32): {ms:.4f} ms/launch by CUDA "
        f"events ({dev_ms:.4f} ms of device time), "
        f"{rows[-1]['launches']} launches on the auto --microbench path, "
        f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s, {real} "
        f"real slots of {fmt.src_idx.numel()}), plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm CSR push {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms of "
        f"device time)")
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
        kernel = "power_step" if tag == "edge_tile" else "bsr_kernel"
        report[f"{tag}_busy"], report[f"{tag}_kernel_share"] = profile_run(
            f"{tag} resolve", lambda: float(eng.run(tol=1e-8).psi.sum()),
            kernel)
    rows += seg_mm_times(report)
    rows += fleet_times(report)
    return rows


def seg_mm_times(report: dict) -> list[dict]:
    """seg_mm at the trainers' shapes — the fixed minibatch_lg sample's
    format, layer 1 (d = 602) and layer 2 (d = 128), and the molecule
    batch's format at EquiformerV2's d = 6,272, f32 — beside its plain
    version, the library's CSR sum of the same real rows and its bound; then
    one GraphSAGE train step under the profiler."""
    import torch
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    from repro_torch.launch import train
    params, state, batch, cfg, opt = report.pop("gnn_step")
    gen = torch.Generator("cuda").manual_seed(3)
    rows = []
    launches = {k: report["launches"][k]["seg_mm"]
                for k in ("gnn_train", "gnn_families", "recsys", "dryrun")}
    # the GraphSAGE cell's two layers, then EquiformerV2's aggregation
    for d, b in ((602, batch), (128, batch),
                 (6272, report.pop("gnn_families_batch"))):
        agg, fmt = b.agg, b.agg.fmt
        e_real = agg.edge_ids.numel()
        crow = torch.zeros(b.n + 1, dtype=torch.int64, device="cuda")
        crow[1:] = torch.cumsum(agg.in_degree, 0)
        # receivers' rows of the real edges, in slot (= dst) order: CSR of
        # ones
        csr = torch.sparse_csr_tensor(
            crow, torch.arange(e_real, device="cuda"),
            torch.ones(e_real, device="cuda"), size=(b.n, e_real),
            check_invariants=True)
        x = torch.randn(b.n + 1, d, generator=gen, device="cuda")
        x[b.n] = 0.0
        msgs = x.index_select(0, fmt.src_idx.reshape(-1)).reshape(
            fmt.src_idx.shape[0], -1, d)
        args = (msgs, fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
                fmt.tile_num_blocks)
        skw = dict(tile=fmt.tile, tile_span=agg.tile_span)
        ms, dev_ms = both_ms(lambda: seg_mm_call(*args, **skw), 50)
        plain_ms = time_ms(lambda: seg_mm_plain(
            msgs, fmt.dst_local, fmt.block_tile, tile=fmt.tile,
            num_tiles=fmt.num_tiles), 20)
        real = msgs.reshape(-1, d).index_select(0, agg.slots)
        lib_ms, lib_dev_ms = both_ms(lambda: torch.sparse.mm(csr, real), 50)
        elt = msgs.element_size()
        # the real message rows and their dst_local (the kernel reads no
        # padding past the tile spans), the block ranges and spans, the
        # output once; one add per real edge and column. The padded count
        # (every slot's row, as read without spans) is printed beside it.
        out_bytes = elt * fmt.num_tiles * fmt.tile * d
        ranges = 3 * fmt.tile_first_block.nbytes
        nbytes = elt * e_real * d + 4 * e_real + ranges + out_bytes
        padded = msgs.nbytes + fmt.dst_local.nbytes + ranges + out_bytes
        flops = e_real * d
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        padded_bound = padded / HBM_BYTES_PER_S * 1e3
        name = {602: "seg_mm", 128: "seg_mm_d128", 6272: "seg_mm_d6272"}[d]
        rows.append(dict(
            name="seg_mm", d=d, route="cuda",
            source="src/repro_torch/kernels/csrc/seg_mm.cu",
            replaces="src/repro/kernels/seg_mm.py:43",
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=report["max_abs_err"][name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / F32_FLOP_PER_S else "operations"),
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, padded_bound_ms=padded_bound))
        per_step = (report["gnn"]["per_step"] if d != 6272 else
                    report["gnn_families"]["equiformer-v2"]["per_step"])
        say(f"seg_mm ({'molecule' if d == 6272 else 'minibatch_lg'}, d={d}, "
            f"f32): {ms:.4f} ms/launch "
            f"({dev_ms:.4f} ms of device time), "
            f"{per_step:g} launches a train step, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s: {e_real} "
            f"real message rows and the output), with every padded slot's "
            f"row {padded_bound:.4f} ms ({padded / 1e6:.1f} MB, "
            f"{fmt.src_idx.numel()} slots), plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm CSR sum {lib_ms:.4f} ms ({lib_dev_ms:.4f} ms "
            f"of device time)")
        del x, msgs, args, real, csr
    # the new kernel at the trainer's other aggregation tiles (d = 602,
    # device time): the tile moves no bit, only the padding and the grid
    from repro_torch.models.gnn.common import edge_agg
    src_h, dst_h = batch.src.cpu().numpy(), batch.dst.cpu().numpy()
    x = torch.randn(batch.n + 1, 602, generator=gen, device="cuda")
    x[batch.n] = 0.0
    cases = {}
    for tile in (256, 512, 1024):
        a = edge_agg(src_h, dst_h, batch.n, tiles=(tile, 2, 128),
                     device="cuda")
        m = x.index_select(0, a.fmt.src_idx.reshape(-1)).reshape(
            a.fmt.src_idx.shape[0], -1, 602)
        cases[tile] = (m, a.fmt, a.tile_span)
    by_tile = {t: [] for t in cases}
    for tile in (256, 512, 1024, 1024, 512, 256):    # in turns, twice
        m, f, span = cases[tile]
        by_tile[tile].append(device_ms(lambda: seg_mm_call(
            m, f.dst_local, f.block_tile, f.tile_first_block,
            f.tile_num_blocks, tile=f.tile, tile_span=span), 50))
    report["seg_mm_device_ms_by_tile"] = {t: min(v)
                                          for t, v in by_tile.items()}
    say("seg_mm (minibatch_lg, d=602, f32) device ms by aggregation tile "
        "(e1 2, e2 128; two readings each, in turns): " + ", ".join(
            f"{t}: {v[0]:.4f} / {v[1]:.4f}" for t, v in by_tile.items()))
    del cases, m, f, span
    del x
    report["seg_mm_ms"] = {r["d"]: r["ms"] for r in rows}
    report["seg_mm_device_ms"] = {r["d"]: r["device_ms"] for r in rows}
    rows.append(recsys_bag_times(report, launches))
    # the train step (fixed minibatch, full width) under the profiler
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        params, state, loss = train.train_step(params, state, batch, cfg, opt)
        float(loss)
        walls.append((time.perf_counter() - t0) * 1e3)
    say(f"gnn train step (fixed minibatch, device part): {sorted(walls)} ms")
    report["gnn_step_ms"] = min(walls)
    report["gnn_busy"], _ = profile_run("gnn train step", lambda: float(
        train.train_step(params, state, batch, cfg, opt)[2]))
    return rows


def recsys_bag_times(report: dict, launches: dict) -> dict:
    """The recsys path's bag sum at the train_batch cell's profile layout
    (:func:`recsys_bag_case`, 524,288 ids, f32, d = RECSYS_BAG_D): the
    port's ``embedding_bag(mode="sum")`` (the rows gathered into the
    layout's slots, then ``seg_mm``) beside ``seg_mm`` alone on those
    slots, the same with the plain version, its bound and
    ``torch.nn.functional.embedding_bag(mode="sum")`` on the valid ids."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.seg_mm import seg_mm_call, seg_mm_plain
    from repro_torch.models.recsys.embedding import bag_layout, embedding_bag
    t0 = time.perf_counter()
    ids, bags, n_bags, vocab = report["bag_case"]
    gen = torch.Generator("cuda").manual_seed(4)
    d = RECSYS_BAG_D
    table = torch.randn(vocab, d, generator=gen, device="cuda")
    ids_t = torch.as_tensor(ids, device="cuda")
    bags_t = torch.as_tensor(bags, device="cuda")
    lay = bag_layout(ids, bags, n_bags, vocab, device="cuda")
    fmt = lay.fmt
    ms, dev_ms = both_ms(lambda: embedding_bag(
        table, ids_t, bags_t, n_bags, mode="sum", layout=lay), 50)
    rows = table.index_select(0, ids_t.index_select(0, lay.edge_ids))
    msgs = rows.new_zeros(lay.num_slots, d).index_copy(0, lay.slots, rows)
    msgs = msgs.reshape(fmt.src_idx.shape[0], -1, d)
    kargs = (msgs, fmt.dst_local, fmt.block_tile, fmt.tile_first_block,
             fmt.tile_num_blocks)
    k_ms, k_dev_ms = both_ms(lambda: seg_mm_call(
        *kargs, tile=fmt.tile, tile_span=lay.tile_span), 50)

    def plain():
        r = table.index_select(0, ids_t.index_select(0, lay.edge_ids))
        m = r.new_zeros(lay.num_slots, d).index_copy(0, lay.slots, r)
        return seg_mm_plain(m.reshape(msgs.shape), fmt.dst_local,
                            fmt.block_tile, tile=fmt.tile,
                            num_tiles=fmt.num_tiles)[:n_bags]

    plain_ms = time_ms(plain, 20)
    valid = ids < vocab
    lib_ids = torch.as_tensor(ids[valid], device="cuda")
    offsets = torch.as_tensor(np.concatenate(
        [[0], np.cumsum(np.bincount(bags[valid], minlength=n_bags))[:-1]]),
        device="cuda")
    lib_ms, lib_dev_ms = both_ms(lambda: F.embedding_bag(
        lib_ids, table, offsets, mode="sum"), 50)
    got = embedding_bag(table, ids_t, bags_t, n_bags, mode="sum", layout=lay)
    lib = F.embedding_bag(lib_ids, table, offsets, mode="sum")
    _compare("recsys bag sum vs F.embedding_bag", got, lib, 1e-5, 1e-6)
    # the function's bytes, each input once: the ids (int64) and the bag
    # offsets, the rows of the distinct valid ids, the output; one add per
    # valid id and column
    n_valid = int(valid.sum())
    distinct = np.unique(ids[valid]).size
    nbytes = 8 * ids.size + 8 * n_bags + 4 * d * (distinct + n_bags)
    flops = n_valid * d
    bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
    report["recsys_bag"] = dict(ms=ms, device_ms=dev_ms, seg_mm_ms=k_ms,
                                seg_mm_device_ms=k_dev_ms, plain_ms=plain_ms,
                                bound_ms=bound, library_ms=lib_ms,
                                library_device_ms=lib_dev_ms)
    say(f"seg_mm on the profile bags (train_batch: {ids.size} ids, "
        f"{n_valid} valid, {distinct} distinct, {n_bags} bags, d={d}, f32): "
        f"the bag sum (gather + seg_mm) {ms:.4f} ms ({dev_ms:.4f} ms of "
        f"device time), seg_mm alone {k_ms:.4f} ms ({k_dev_ms:.4f}), "
        f"{report['recsys']['train_batch']['per_step']:g} launches a train "
        f"step; bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s), "
        f"plain {plain_ms:.4f} ms, F.embedding_bag(mode='sum') {lib_ms:.4f} "
        f"ms ({lib_dev_ms:.4f} ms of device time); "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(
        name="seg_mm", d=d, route="cuda",
        source="src/repro_torch/kernels/csrc/seg_mm.cu",
        replaces="src/repro/kernels/seg_mm.py:43",
        launches=sum(launches.values()), launches_by_path=launches,
        max_abs_err=report["max_abs_err"]["seg_mm_d64"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                  >= flops / F32_FLOP_PER_S else "operations"),
        library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms,
        seg_mm_ms=k_ms, seg_mm_device_ms=k_dev_ms)


def fleet_times(report: dict) -> list[dict]:
    """The fleet's lane-batched kernels: first held against their plain
    versions at every cuda bucket's shapes (f32 and f64, from each bucket's
    cold state s = c: ``power_step_lanes`` at POWER_TOL, its gap per lane
    within GAP_RTOL, ``edge_spmv_lanes`` bitwise, both bitwise run to run);
    then each bucket's cold solve (host clock, min of 3, and the busy share
    of one more under the profiler); then, at the facebook and the dblp
    buckets, both kernels by CUDA events and device time beside L
    single-lane launches, their bound (the bytes of all lanes at 3.35
    TB/s), the plain version and one ``torch.sparse.mm`` over the
    block-diagonal CSR of all lanes (:func:`_lane_times`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.edge_spmv import (edge_spmv_lanes_call,
                                               edge_spmv_lanes_plain)
    from repro_torch.kernels.power_step import (power_step_lanes_call,
                                                power_step_lanes_plain)
    fleet = report["fleet"]
    cuda = {spec: b for spec, b in sorted(fleet._buckets.items())
            if b.regime == "cuda"}
    errs = {}
    for spec, bucket in cuda.items():
        fmt, inv_w_g, mu, c = bucket.args
        kw = dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).removeprefix("torch.")
            rtol, atol = POWER_TOL[dname]
            s = c.to(dtype)
            s_pre = F.pad(s, (0, fmt.n_gather - fmt.n_pad)) * inv_w_g.to(dtype)
            args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
                    fmt.tile_first_block, fmt.tile_num_blocks, mu.to(dtype),
                    c.to(dtype), s)
            tag = f"fleet {spec} {dname}"
            s1, gap1 = power_step_lanes_call(*args, **kw)
            s2, gap2 = power_step_lanes_call(*args, **kw)
            t1 = edge_spmv_lanes_call(*args[:6], **kw)
            t2 = edge_spmv_lanes_call(*args[:6], **kw)
            torch.cuda.synchronize()
            check(torch.equal(s1, s2) and torch.equal(gap1, gap2)
                  and torch.equal(t1, t2), f"{tag}: two runs differ")
            host = [a.cpu() for a in args]
            sp, gapp = power_step_lanes_plain(*host[:4], *host[6:],
                                              tile=fmt.tile)
            err, share = _compare(f"power_step_lanes {tag}", s1.cpu(), sp,
                                  rtol, atol)
            gap_rel = float(((gap1.cpu() - gapp).abs()
                             / gapp.abs().clamp_min(1e-30)).max())
            check(gap_rel <= GAP_RTOL[dname], f"power_step_lanes {tag}: gap "
                  f"rel err {gap_rel:.3e} > {GAP_RTOL[dname]}")
            tp = edge_spmv_lanes_plain(*host[:4], tile=fmt.tile,
                                       num_tiles=fmt.num_tiles)
            check(torch.equal(t1.cpu(), tp), f"edge_spmv_lanes {tag}: differs "
                  f"from the plain version (max abs err "
                  f"{float((t1.cpu() - tp).abs().max()):.3e})")
            say(f"lane kernels {tag}: {fmt.src_idx.shape[0]} lanes x "
                f"{fmt.src_idx.shape[1]} blocks, tile {fmt.tile}; "
                f"power_step_lanes max abs err {err:.3e} (worst element at "
                f"{share:.3g} of its limit), gap rel err {gap_rel:.3e}; "
                f"edge_spmv_lanes bitwise the plain version; both bitwise "
                f"run to run")
            if dname == "float32" and spec.e_pad == 1_048_576:
                errs = dict(power_step_lanes=err, edge_spmv_lanes=0.0)
            del args, host, sp, tp
    # each bucket's cold solve
    resolve = {}
    for spec, bucket in sorted(fleet._buckets.items()):
        walls = []
        for _ in range(3):
            _cold_bucket(fleet, spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.solve()
            walls.append((time.perf_counter() - t0) * 1e3)
        _cold_bucket(fleet, spec)
        busy, share = profile_run(f"fleet {spec} cold solve", fleet.solve,
                                  "power_step" if bucket.regime == "cuda"
                                  else None)
        iters = max(fleet.stats(t)["iterations"] for t in bucket.order)
        resolve[str(spec)] = dict(regime=bucket.regime,
                                  lanes=len(bucket.order), steps=iters,
                                  ms=min(walls), busy=busy,
                                  kernel_share=share)
        say(f"fleet {spec} ({bucket.regime}, {len(bucket.order)} lanes) cold "
            f"solve: {iters} steps, {sorted(walls)} ms (min "
            f"{min(walls):.3f}), busy {busy if busy is None else f'{busy:.1%}'}")
    report["fleet_resolve"] = resolve
    # the lane-batched kernels, f32, at the facebook bucket (its times are
    # the kernels line's) and at the dblp bucket (the shape of the stream
    # and chaos phases' fleets, where most lane launches are)
    rows, times = [], {}
    for bname, e_pad in (("facebook", 1_048_576), ("dblp", 65_536)):
        spec = next(s for s in cuda if s.e_pad == e_pad)
        rows += _lane_times(report, fleet, cuda[spec], spec, bname, errs,
                            times)
    report["fleet_lane_ms"] = times
    return rows


def _lane_times(report, fleet, bucket, spec, bname, errs, times) -> list:
    """One cuda bucket's lane kernels by CUDA events and device time beside
    L single-lane launches, their bound, the plain version and one
    ``torch.sparse.mm`` over the block-diagonal CSR of all lanes, into
    ``times`` under ``"<kernel> <bname>"``; the kernels line's rows when
    ``bname`` is facebook."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.graphs import Graph
    from repro_torch.kernels.edge_spmv import (edge_spmv_call,
                                               edge_spmv_lanes_call,
                                               edge_spmv_lanes_plain)
    from repro_torch.kernels.power_step import (power_step_call,
                                                power_step_lanes_call,
                                                power_step_lanes_plain)
    fmt, inv_w_g, mu, c = bucket.args
    lanes = fmt.src_idx.shape[0]
    s = bucket.s
    s_pre = F.pad(s, (0, fmt.n_gather - fmt.n_pad)) * inv_w_g
    args = (s_pre, fmt.src_idx, fmt.dst_local, fmt.block_tile,
            fmt.tile_first_block, fmt.tile_num_blocks, mu, c, s)
    kw = dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order)
    one = [dict(n=fmt.n, tile=fmt.tile, tile_order=fmt.tile_order[i])
           for i in range(lanes)]
    elt = s.element_size()
    real = int((fmt.src_idx < fmt.n).sum())
    tables = fmt.tile_first_block.nbytes + fmt.tile_num_blocks.nbytes
    # every lane: every slot's src_idx, dst_local of the real slots, its
    # block ranges, s_pre's n entries, then mu, c, s_old in and s_new out
    # (power_step) or the output once (edge_spmv), and the gaps
    step_bytes = (fmt.src_idx.nbytes + 4 * real + tables
                  + elt * lanes * (fmt.n + 4 * fmt.n_pad + 1))
    step_flops = 2 * real + 4 * lanes * fmt.n_pad
    push_bytes = (fmt.src_idx.nbytes + 4 * real + tables
                  + elt * lanes * (fmt.n + fmt.n_pad))
    cases = {
        "power_step_lanes": (
            lambda: power_step_lanes_call(*args, **kw),
            lambda: [power_step_call(*(a[i] for a in args), **one[i])
                     for i in range(lanes)],
            lambda: power_step_lanes_plain(*args[:4], *args[6:],
                                           tile=fmt.tile),
            step_bytes, step_flops, "power_step.cu",
            "src/repro/kernels/power_step.py:66"),
        "edge_spmv_lanes": (
            lambda: edge_spmv_lanes_call(*args[:6], **kw),
            lambda: [edge_spmv_call(*(a[i] for a in args[:6]), **one[i])
                     for i in range(lanes)],
            lambda: edge_spmv_lanes_plain(*args[:4], tile=fmt.tile,
                                          num_tiles=fmt.num_tiles),
            push_bytes, real, "edge_spmv.cu",
            "src/repro/kernels/edge_spmv.py:64")}
    # the library call: one CSR product over the block-diagonal matrix of
    # every lane's edges
    hosts = [fleet._rec(t).host for t in bucket.order]
    block = Graph(lanes * fmt.n,
                  np.concatenate([h.src_by_dst + i * fmt.n
                                  for i, h in enumerate(hosts)]),
                  np.concatenate([h.dst_by_dst + i * fmt.n
                                  for i, h in enumerate(hosts)]))
    csr = push_csr(block, s.dtype)
    x = s_pre[:, 0, :fmt.n].reshape(-1, 1).contiguous()
    lib_ms, lib_dev_ms = both_ms(lambda: torch.sparse.mm(csr, x), 200)
    rows = []
    for name, (lane_fn, single_fn, plain_fn, nbytes, flops, src,
               replaces) in cases.items():
        ms, dev_ms = both_ms(lane_fn, 200)
        one_ms, one_dev_ms = both_ms(single_fn, 50)
        plain_ms = time_ms(plain_fn, 20)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        times[f"{name} {bname}"] = dict(
                           events=ms, device=dev_ms, single_events=one_ms,
                           single_device=one_dev_ms, bound=bound,
                           plain=plain_ms, library=lib_ms,
                           library_device=lib_dev_ms)
        row = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=report["launches"]["fleet"][name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / F32_FLOP_PER_S else "operations"),
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        if bname == "facebook":
            rows.append(row)
        say(f"{name} (fleet {spec}, {lanes} {bname} lanes, tile "
            f"{fmt.tile}, f32): {ms:.4f} ms/launch by CUDA events "
            f"({dev_ms:.4f} ms of device time); {lanes} single-lane launches "
            f"{one_ms:.4f} ms ({one_dev_ms:.4f} ms of device time); "
            f"{row['launches']} launches on the fleet path; bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s, {real} real "
            f"slots of {fmt.src_idx.numel()}); plain {plain_ms:.4f} ms; "
            f"torch.sparse.mm over the block-diagonal CSR of all lanes "
            f"{lib_ms:.4f} ms ({lib_dev_ms:.4f} ms of device time)")
    del csr, x, args
    return rows


def profile_run(tag, fn, kernel=None) -> tuple[float | None, float | None]:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel.
    Returns the device's busy share of the call's wall time and the share
    of the device time spent in kernels whose name holds ``kernel`` (both
    None when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
        return None, None
    say(f"{tag} profile: device busy {busy_us:.1f} us of {wall_us:.1f} us "
        f"wall ({busy_us / wall_us:.1%}); by kernel:")
    for dev_us, count, key in rows[:8]:
        say(f"  {dev_us:10.1f} us  x{count:<4d} {key[:90]}")
    share = (sum(us for us, _, key in rows if kernel in key) / busy_us
             if kernel else None)
    return busy_us / wall_us, share


def summary(report: dict) -> str:
    """The run's main facts on one line, for readers of the output's tail:
    iterations and rel L1 error of each fixed point (edge_tile, bsr, then
    the auto runs), the worst kernel element's share of its limit, min cold
    resolve ms and the profiled busy share of each regime, bsr_spmv's
    floors (one-byte storage, f32 dense tiles, nonzeros) and its and
    bsr_step's ms, edge_spmv's worst error against its plain version (0:
    bitwise), the auto plans and the microbench's picks on the clustered
    graph in its stability check, the plain and accelerated f64 mat-vecs,
    power_step's and edge_spmv's ms (CUDA events) and device ms at each edge
    tile and the in-degree skew's tail in their device time; for
    the GraphSAGE cell the first and last loss of the trainer's run and of
    the fixed minibatch, seg_mm
    launches a step, slots per real edge, the median step split, the f32
    step's error against f64, the step's ms and busy share and seg_mm's ms
    (events and device) at d = 602, 128 and 6,272 and device ms by tile;
    for the other GNN families each arch's step ms, busy share, seg_mm
    launches a step, peak GiB, first and last CLI loss and the f32 step's
    shares of its limits, the rotation errors, the sharded forward's and
    the two optimizer updates' errors and the path's seconds; for the
    fleet its lanes' counts, the largest rel L1 of a lane's ψ from the solo
    cuda engine's, each bucket's cold solve (steps, ms, busy share) and the
    lane-batched kernels' times at the facebook bucket; for the paper
    phase the rel L2 of full-N Power-NF and of Power-ψ from exact ψ,
    PageRank's max error from homogeneous ψ and each solver's wall ms,
    device ms and mat-vecs at tol 1e-9; for the push phase the cold and
    warm certified reads (ms, rounds, edge work, touched share, bound),
    the jit run (ms, rounds, device rounds and their share of the wall)
    and the device round's ms; for the chaos path each gate's parity,
    oracle and chaos walls, overhead, MTTR, ladder deadline and restarts,
    the guard's rollback ms and the path's seconds; for the lm path its
    steps', prefills' and decodes' ms, tokens/s, busy shares, peaks, the
    f32-vs-f64 and logit errors and the dropped tokens; for the recsys
    path its train step's ms, users/s, busy share, peak and losses, the
    f32-vs-f64 errors, the fixed batch's losses, the serve cells' ms,
    users/s and errors against f64, the retrieval's ms and error, and the
    bag sum's ms beside seg_mm's, the plain version's, its bound and
    F.embedding_bag's."""
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
        "kernel_share": {k: g(report[f"{k}_kernel_share"])
                         for k in ("edge_tile", "bsr")},
        **{key: {k: g(v) for k, v in report[key].items()} for key in (
            "bsr_bounds_ms", "bsr_spmv_ms", "bsr_step_ms")},
        "edge_spmv_max_abs_err": g(report["edge_spmv_worst_err"]),
        "auto_plans": report["auto_plans"],
        "microbench_picks": report["microbench_stability"][0],
        "accelerate_matvecs": report["accelerate_matvecs"],
        **{key: {k: g(v) for k, v in report[key].items()} for key in (
            "power_step_ms_by_tile", "power_step_device_ms_by_tile",
            "edge_spmv_ms_by_tile", "edge_spmv_device_ms_by_tile",
            "skew_tail_device_ms")},
        "gnn": {"losses": [g(x) for x in report["gnn"]["losses"][::9]],
                "fixed_batch_losses": [g(x) for x in
                                       report["gnn"]["fixed"][::9]],
                "seg_mm_launches_per_step": report["gnn"]["per_step"],
                "slots_per_edge": g(report["gnn"]["padding"]),
                "split_ms": {k: g(v * 1e3) for k, v in
                             report["gnn"]["splits"].items()},
                "f64_loss_rel": g(report["gnn"]["loss_rel"]),
                "f64_grad_rel_l2": g(report["gnn"]["grad_rel"]),
                "step_ms": g(report["gnn_step_ms"]),
                "busy": g(report["gnn_busy"]),
                **{key: {k: g(v) for k, v in report[key].items()}
                   for key in ("seg_mm_ms", "seg_mm_device_ms",
                               "seg_mm_device_ms_by_tile")}},
        "gnn_families": {
            **{a: {k: (g(v) if isinstance(v, float) else v) for k, v in (
                ("step_ms", report["gnn_families"][a]["step_ms"]),
                ("busy", report["gnn_families"][a]["busy"]),
                ("seg_mm_per_step", report["gnn_families"][a]["per_step"]),
                ("peak_gib", report["gnn_families"][a]["peak_gib"]),
                ("loss", [g(report["gnn_families"][a]["losses"][0]),
                          g(report["gnn_families"][a]["losses"][-1])]),
                ("share_of_limits", [g(x) for x in
                                     report["gnn_families"][a]["share"]]))}
               for a, _, _ in GNN_FAMILY_RUNS},
            **{k: g(v) for k, v in report["gnn_families"].items()
               if isinstance(v, float)}},
        "fleet": {"iters": [i for i, _ in report["fixed_points"]
                            [len(FIXED_POINT_ITERS):]],
                  "max_rel_solo": g(max(report["fleet_rel_solo"])),
                  "resolve": {k: {kk: (g(vv) if isinstance(vv, float)
                                       else vv) for kk, vv in v.items()}
                              for k, v in report["fleet_resolve"].items()},
                  "lane_ms": {k: {kk: g(vv) for kk, vv in v.items()}
                              for k, v in report["fleet_lane_ms"].items()}},
        "paper": {"rel_l2": [g(report["paper"]["rel_nf"]),
                             g(report["paper"]["rel_psi"])],
                  "pagerank_err": g(report["paper"]["pr_err"]),
                  "tol_1e-9": {k: [g(v["wall_ms"]), g(v["device_ms"]),
                                   v["matvecs"]]
                               for k, v in report["paper"]["times"].items()}},
        "push": {k: ({kk: g(vv) if isinstance(vv, float) else vv
                      for kk, vv in v.items()} if isinstance(v, dict)
                     else g(v)) for k, v in report["push"].items()},
        "stream": {k: ([g(x) for x in v] if isinstance(v, (list, tuple))
                       else g(v) if isinstance(v, float) else v)
                   for k, v in report["stream"].items() if k != "reads"},
        "stream_reads_ms": {op: [g(x) for x in v] for op, v in
                            report["stream"]["reads"].items()},
        "stream_fleet": {k: g(v) if isinstance(v, float) else v
                         for k, v in report["stream_fleet"].items()},
        "driver": {"counts": report["driver"]["counts"],
                   "ms": {k: g(v) for k, v in report["driver"]["ms"].items()},
                   "chunk_ms": g(report["driver"]["chunk_ms"]),
                   "busy": g(report["driver"]["busy"]),
                   "max_rel_l1": g(max(report["driver"]["rel_l1"].values())),
                   "async_tau2": {k: g(v) if isinstance(v, float) else v
                                  for k, v in
                                  report["driver"]["async_tau2"].items()}},
        "chaos": {**{tag: {k: g(report["chaos"][tag][k]) for k in (
                      "parity_err", "oracle_wall_s", "chaos_wall_s",
                      "recovery_overhead", "mttr_s", "ladder_deadline_s")}
                     | {"restarts": report["chaos"][tag]["restarts"]}
                     for tag in ("gate", "twitter-size")},
                  "rollback_ms": g(report["chaos"]["guard"]["rollback_s"]
                                   * 1e3),
                  "path_s": g(report["chaos"]["path_s"])},
        "lm": _lm_summary(report["lm"], g),
        "recsys": _lm_summary(report["recsys"], g),
        "recsys_bag_ms": _lm_summary(report["recsys_bag"], g),
        "dryrun": {"real": {k: {kk: g(vv) for kk, vv in v.items()
                                if kk in ("estimate", "measured", "gap",
                                          "device_ms", "seg_mm_launches")}
                            for k, v in report["dryrun"]["real"].items()},
                   "bitwise": report["dryrun"]["bitwise"],
                   "records": report["dryrun"]["records"],
                   "path_s": g(report["dryrun"]["path_s"])}})


def _lm_summary(lm: dict, g) -> dict:
    """The lm (or recsys) path's numbers, rounded by ``g`` (lists of
    numbers rounded too; the dropped-token counts kept as they are)."""
    def r(v):
        if isinstance(v, dict):
            return {k: r(x) for k, x in v.items()}
        if isinstance(v, float):
            return g(v)
        if isinstance(v, list) and v and isinstance(v[0], float):
            return [g(x) for x in v]
        return v
    return r(lm)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.bsr_spmv import bsr_spmv_call, bsr_step_call
    from repro_torch.kernels.edge_spmv import (edge_spmv_call,
                                               edge_spmv_lanes_call)
    from repro_torch.kernels.power_step import (power_step_call,
                                                power_step_lanes_call)
    from repro_torch.kernels.seg_mm import seg_mm_call
    # float32 products and convolutions in full float32 on the card (the
    # references the checks compare with are float32 or float64)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report: dict = {}
    counters = {"power_step": power_step_call, "bsr_spmv": bsr_spmv_call,
                "bsr_step": bsr_step_call, "edge_spmv": edge_spmv_call,
                "seg_mm": seg_mm_call,
                "power_step_lanes": power_step_lanes_call,
                "edge_spmv_lanes": edge_spmv_lanes_call}
    # each main path and the kernels it must launch; the microbench path
    # times every candidate's bare push (edge_spmv, bsr_spmv on the
    # clustered graph) and then solves with the step of each plan it picks
    def picked(report):
        return tuple("power_step" if label.startswith("edge_tile")
                     else "bsr_step" for key, label in
                     report["auto_plans"].items()
                     if key.startswith("microbench/"))
    paths = [("edge_tile", phase_edge_tile, ("power_step", "edge_spmv")),
             ("bsr", phase_bsr, ("bsr_step",)),
             ("auto_model", lambda r: phase_auto(r, False), ("power_step",)),
             ("auto_microbench", lambda r: phase_auto(r, True),
              lambda r: ("edge_spmv", "bsr_spmv") + picked(r)),
             ("accelerate", phase_accelerate, ("power_step",)),
             ("gnn_train", phase_gnn_train, ("seg_mm",)),
             ("gnn_families", phase_gnn_families, ("seg_mm",)),
             ("fleet", phase_fleet, ("power_step_lanes", "edge_spmv_lanes")),
             ("paper", phase_paper, ("power_step",)),
             ("push", phase_push, ()),
             ("stream", phase_stream,
              ("power_step", "power_step_lanes", "edge_spmv_lanes")),
             ("driver", phase_driver, ()),
             ("chaos", phase_chaos, ("power_step", "edge_spmv",
                                     "power_step_lanes", "edge_spmv_lanes")),
             ("lm", phase_lm, ()),
             ("recsys", phase_recsys, ("seg_mm",)),
             ("dryrun", phase_dryrun, ("seg_mm",))]
    pool = None
    try:
        phase_device(report)
        # the paper and push phases' exact solves (host LU, tens of seconds
        # each) run in worker processes while the card works
        pool = multiprocessing.get_context("spawn").Pool(3)
        report["exact_jobs"] = {kind: pool.apply_async(exact_job, (kind,))
                                for kind in ("paper", "push", "edge")}
        phase_kernels(report)
        report["launches"] = {}
        for path, run, needs in paths:
            for fn in counters.values():
                fn.launches = 0                  # this main path starts here
            t_path = time.perf_counter()
            run(report)
            got = {k: fn.launches for k, fn in counters.items()}
            report["launches"][path] = got
            say(f"main path {path}: launches {got} "
                f"({time.perf_counter() - t_path:.1f} s)")
            for k in (needs(report) if callable(needs) else needs):
                check(got[k] > 0, f"kernel {k} never launched on the main "
                      f"path {path}")
        iters = [i for i, _ in report["fixed_points"]]
        check(iters == FIXED_POINT_ITERS + FLEET_ITERS, f"fixed-point "
              f"iterations {iters} != {FIXED_POINT_ITERS + FLEET_ITERS}")
        rows = phase_times(report)
    except SmokeFailure as exc:
        print(f"[smoke] FAIL: {exc}", file=sys.stderr)
        return 1
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    say(f"run took {time.perf_counter() - t_start:.1f} s (kernel build "
        f"included)")
    say(f"summary: {summary(report)}")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
