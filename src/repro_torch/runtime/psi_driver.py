"""Fault-tolerant distributed Power-ψ drivers — shared machinery + the
synchronous bulk-chunk driver.

The fixed point s* is the *entire* algorithm state (O(N) floats) and the
iteration is a contraction, which yields unusually strong resilience
properties, all exercised here:

  * **checkpoint/restart** — s is checkpointed every chunk; restart resumes
    the contraction exactly (no approximation, no lost work beyond the
    current chunk). Across ranks, every rank gathers s in the src layout
    ``[d, mo·q]``, rank 0 writes it (the JAX package's file, key for key)
    and every rank waits at a barrier; a restore reads it on every rank
    after a barrier and keeps its own row.
  * **elastic re-mesh** — s converts between meshes through the host layout
    (`Partition2D.from_src_layout` → new `to_src_layout`); a job can change
    its mesh shape over the same ranks between chunks and continue warm.
  * **straggler mitigation** — per-chunk deadline tracking flags slow
    chunks with the measured duration and the deadline it exceeded.

Because ρ(A) < 1 the iteration also tolerates bounded-stale partials:
:class:`repro_torch.asyncexec.AsyncPsiDriver` shares the checkpoint +
deadline machinery of :class:`PsiDriverBase` below but replaces the
bulk-synchronous chunk barrier with the overlapped bounded-staleness
scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ckpt import checkpoint
from ..core.distributed import DistributedPsi
from ..core.engine import ChunkExtrapolator
from ..core.incremental import RankingCache
from ..obs import convergence as obs_convergence
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

__all__ = ["PsiDriver", "PsiDriverBase", "DriverReport", "SlowChunk"]


@dataclasses.dataclass(frozen=True)
class SlowChunk:
    """One deadline violation: which chunk, how slow, against what."""

    chunk: int           # chunk index (sync) / chunk-step index (async)
    duration: float      # measured wall seconds of the offending chunk
    deadline: float      # the deadline it exceeded (factor × running median)


@dataclasses.dataclass
class DriverReport:
    iterations: int
    gap: float
    chunks: int
    restarts: int
    slow_chunks: list[int]
    psi: np.ndarray      # node order, on the host
    # straggler forensics: not just *which* chunks were slow but how slow,
    # and the deadline that tripped
    chunk_durations: list[float] = dataclasses.field(default_factory=list)
    slow_chunk_events: list[SlowChunk] = dataclasses.field(
        default_factory=list)

    def queries(self) -> RankingCache:
        """Batched query layer over the converged ψ (shared with PsiService)."""
        return RankingCache(torch.as_tensor(self.psi))


class PsiDriverBase:
    """Checkpoint + straggler-deadline machinery shared by the synchronous
    :class:`PsiDriver` and the asynchronous
    :class:`repro_torch.asyncexec.AsyncPsiDriver`.

    Subclasses call :meth:`_note_duration` once per chunk (or chunk-step)
    and the :meth:`_ckpt_save` / :meth:`_ckpt_restore_latest` pair around
    their own state trees — what that state *is* (a src-layout vector vs
    a board + epoch vector) stays backend-specific.
    """

    def __init__(self, *, ckpt_dir: str | None = None,
                 deadline_factor: float = 3.0):
        self.ckpt_dir = ckpt_dir
        self.deadline_factor = deadline_factor
        self._reset_tracking()

    # -- straggler deadlines -------------------------------------------- #
    def _reset_tracking(self) -> None:
        self._durations: list[float] = []
        self._slow: list[int] = []
        self._slow_events: list[SlowChunk] = []

    def _note_duration(self, idx: int, dt: float) -> bool:
        """Record one chunk duration; returns True (and logs a
        :class:`SlowChunk`) when it exceeded ``deadline_factor`` × the
        running median.

        ``dt`` comes off the shared span clock (a
        :class:`repro_torch.obs.trace.Span` around the chunk) so the
        :class:`SlowChunk` event, the ``psi_chunk_seconds`` histogram and
        the trace span all describe one measurement.
        """
        slow = False
        if self._durations:
            deadline = self.deadline_factor * float(
                np.median(self._durations))
            if dt > deadline:
                slow = True
                self._slow.append(int(idx))
                self._slow_events.append(
                    SlowChunk(int(idx), float(dt), float(deadline)))
                obs_metrics.counter(
                    "psi_slow_chunks_total",
                    "chunks exceeding deadline_factor x running median"
                ).inc()
        self._durations.append(float(dt))
        obs_metrics.histogram("psi_chunk_seconds",
                              "driver chunk wall seconds").observe(dt)
        return slow

    # -- checkpoints ----------------------------------------------------- #
    def _ckpt_save(self, step: int, tree: dict) -> None:
        if self.ckpt_dir:
            checkpoint.save(self.ckpt_dir, step, tree)

    def _ckpt_restore_latest(self, template: dict) -> dict | None:
        if not self.ckpt_dir:
            return None
        # restore_latest (not latest_step + restore): it skips corrupt /
        # torn steps and tolerates a concurrent save(keep=…) GC pruning the
        # step between listing and load
        return checkpoint.restore_latest(self.ckpt_dir, template)


class PsiDriver(PsiDriverBase):
    """Bulk-synchronous chunk driver over :class:`DistributedPsi` (one rank's
    part; every rank of the mesh runs it)."""

    def __init__(self, dist: DistributedPsi, *, ckpt_dir: str | None = None,
                 chunk_iters: int = 16, deadline_factor: float = 3.0,
                 accelerate: bool = False):
        super().__init__(ckpt_dir=ckpt_dir, deadline_factor=deadline_factor)
        self.dist = dist
        self.chunk_iters = chunk_iters
        self.accelerate = accelerate         # chunk-level Aitken jumps
        self._warm_s = None                  # set by remesh(): elastic resume

    @classmethod
    def from_engine(cls, engine, **kw) -> "PsiDriver":
        """Build a driver from a prepared ``distributed`` PsiEngine
        (inherits the engine's ``accelerate`` setting)."""
        if getattr(engine, "dist", None) is None:
            raise ValueError("engine has no distributed state; "
                             "use make_engine('distributed', graph=..., ...)")
        kw.setdefault("accelerate", getattr(engine, "accelerate", False))
        return cls(engine.dist, chunk_iters=engine.chunk_iters, **kw)

    # -- checkpoints of the sharded iterate ------------------------------ #
    def _save_s(self, step: int, s: torch.Tensor) -> None:
        if not self.ckpt_dir:
            return
        full = self.dist.gather_src(s)          # [d, mo·q] on every rank
        if self.dist.mesh.rank == 0:
            self._ckpt_save(step, dict(s=full, it=np.int64(step)))
        self.dist.mesh.barrier()                # the file exists for all

    def _restore_s(self):
        """``(s_row, it)`` of the newest complete checkpoint, or None."""
        if not self.ckpt_dir:
            return None
        self.dist.mesh.barrier()
        p = self.dist.part
        data = self._ckpt_restore_latest(dict(
            s=np.zeros((p.d, p.mo * p.q), np.float32), it=np.int64(0)))
        if data is None:
            return None
        return self.dist.local_src(data["s"]), int(data["it"])

    def run(self, *, tol: float = 1e-8, max_iter: int = 2000,
            fail_hook: Callable[[int], bool] | None = None) -> DriverReport:
        """Iterate to convergence with checkpoint/restart.

        ``fail_hook(chunk_idx) → True`` injects a simulated failure: the
        driver drops its in-memory state and restores from the last
        checkpoint, exactly like a restarted job would. Every rank must
        get the same answer from it.
        """
        dist = self.dist
        run_chunk = dist.make_run(chunk_iters=self.chunk_iters)
        # consume the elastic-remesh warm vector when present: the re-meshed
        # job resumes the contraction instead of restarting from c (one-shot —
        # later runs must resume their own progress, not this stale snapshot)
        s = dist.arrays.c_src if self._warm_s is None else self._warm_s
        self._warm_s = None
        extrap = (ChunkExtrapolator(tol, l1=dist.l1) if self.accelerate
                  else None)
        it = 0
        chunk_idx = 0
        restarts = 0
        gap = float("inf")
        self._reset_tracking()
        self._save_s(0, s)
        rec = obs_convergence.begin("driver")
        while it < max_iter and gap > tol:
            # one measurement on the shared span clock: the SlowChunk
            # deadline check, chunk_durations, and the trace span all see
            # this span's duration (sync() waits on the chunk's stream)
            with obs_trace.span("driver.chunk", chunk=chunk_idx) as sp:
                s_new, gap_dev = run_chunk(s, dist.arrays)
                sp.sync(s_new)
            self._note_duration(chunk_idx, sp.duration_s)

            if fail_hook is not None and fail_hook(chunk_idx):
                restarts += 1
                got = self._restore_s()
                if got is not None:
                    s, it = got
                if extrap is not None:
                    extrap.reset()       # restored s breaks the Δ history
                chunk_idx += 1
                continue

            gap = float(gap_dev)
            it += self.chunk_iters
            obs_convergence.record_gap(it, certified=gap)
            # chunk-level Aitken jump (verified by the next chunk's plain
            # steps — Eq. 19 semantics preserved, see ChunkExtrapolator)
            s = extrap.advance(s, s_new, gap) if extrap else s_new
            chunk_idx += 1
            self._save_s(it, s)
        psi = dist.gather_psi(dist.make_epilogue()(s, dist.arrays))
        obs_convergence.finish(rec, iterations=it, gap=gap,
                               converged=gap <= tol,
                               duration_s=float(sum(self._durations)))
        return DriverReport(iterations=it, gap=gap, chunks=chunk_idx,
                            restarts=restarts, slow_chunks=self._slow,
                            psi=psi, chunk_durations=self._durations,
                            slow_chunk_events=self._slow_events)

    # ------------------------------------------------------------------ #
    def remesh(self, new_mesh, graph, activity, s_current) -> "PsiDriver":
        """Elastic re-mesh: carry s across a mesh change over the same
        ranks (warm restart). ``s_current`` is this rank's row on the old
        mesh."""
        old = self.dist
        s_host = old.part.from_src_layout(old.gather_src(s_current))
        new_dist = DistributedPsi.from_graph(graph, activity, new_mesh,
                                             dtype=old.dtype)
        driver = PsiDriver(new_dist, ckpt_dir=self.ckpt_dir,
                           chunk_iters=self.chunk_iters)
        driver._warm_s = new_dist.local_src(new_dist.part.to_src_layout(s_host))
        return driver
