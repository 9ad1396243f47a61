"""`AsyncPsiDriver` — the fault-tolerant front end of the bounded-staleness
scheduler, with the same checkpoint/restart + elastic contract as the
synchronous :class:`~repro_torch.runtime.psi_driver.PsiDriver`.

The one structural difference from the sync driver: async state is not just
the board — it is the board *plus the per-chunk epoch vector*. Checkpoints
carry both, so a restart resumes the skewed pipeline exactly where it was
(straggler lag and all) instead of collapsing it to a synchronous snapshot;
the only lost work is whatever was in flight when the failure hit.

The elastic analogue of ``PsiDriver.remesh`` is :meth:`AsyncPsiDriver.rechunk`:
the board converts through node order into a new chunk decomposition and the
new pipeline warm-starts from it (epochs restart at a uniform zero — an
epoch vector is meaningless across a chunk-count change, the contraction
progress lives entirely in the board).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.operators import HostOperators
from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from ..obs import convergence as obs_convergence
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime.psi_driver import DriverReport, PsiDriverBase
from .scheduler import AsyncChunkScheduler, ChunkedOperators
from .staleness import StalenessBound

__all__ = ["AsyncPsiDriver", "AsyncDriverReport"]


@dataclasses.dataclass
class AsyncDriverReport(DriverReport):
    """`DriverReport` plus the async-only observability fields."""

    max_staleness: int = 0            # max observed epoch spread
    overlap_efficiency: float = 0.0   # Σ worker busy time / wall (>1 ⇒ overlap)
    sync_sweeps: int = 0              # synchronous verification sweeps run
    rejected_certificates: int = 0    # under-tol gaps refused for τ-violation
    epochs: np.ndarray | None = None  # final per-chunk epoch vector
    tau: int = 0
    converged: bool = True            # certified + sync-verified under tol


class AsyncPsiDriver(PsiDriverBase):
    """Overlapped Power-ψ execution with bounded-staleness certificates.

    Same call surface as :class:`~repro_torch.runtime.psi_driver.PsiDriver`:
    ``run(tol=..., max_iter=..., fail_hook=...)`` → a report, plus the
    elastic :meth:`rechunk`. Runs on ``device`` (``"cuda"`` by default;
    raises without a card unless ``device="cpu"``).

    **Hook semantics:**

    * ``fail_hook(tick) -> bool`` — polled once per *epoch-floor advance*
      (the async analogue of the sync driver's per-chunk index; it is NOT
      called once per chunk step, so under heavy skew several chunk steps
      share one tick). Returning True simulates a whole-process crash: the
      in-memory board and epoch vector are dropped and restored from the
      last complete checkpoint (``ckpt_dir`` required for the restore to
      find anything; without it the restart silently resumes cold). The
      hook runs on the scheduling thread — keep it cheap.
    * ``delay_hook(chunk, epoch) -> seconds`` — a *straggler*: the chunk's
      worker sleeps that long before computing, holding its slice at the
      old epoch. The staleness bound τ then throttles the rest of the
      pipeline.
    * ``read_hook(reader, neighbor, epochs) -> lag`` — forces ``reader``'s
      next step to consume ``neighbor``'s slice from ``lag`` epochs ago,
      served from the epoch-tagged history ring (lag is clamped to
      ``[0, τ]``). Production runs leave it None: reads are
      latest-snapshot and their staleness arises only from genuine
      pipeline skew.

    ``host=`` shares an existing :class:`HostOperators` mirror instead of
    building one from (graph, activity) — :meth:`rechunk` uses it so the
    successor sees bit-identical w/row_lam accumulators (a rebuild from the
    re-exported graph would re-sum them in a different order and drift by
    ulps, breaking fixed-point parity).
    """

    def __init__(self, graph: Graph | None = None, activity=None, *,
                 num_chunks: int = 4,
                 tau: int = 2, ckpt_dir: str | None = None,
                 ckpt_every: int = 8, deadline_factor: float = 3.0,
                 dtype: torch.dtype = torch.float32,
                 max_workers: int | None = None,
                 delay_hook: Callable[[int, int], float] | None = None,
                 read_hook=None, host: HostOperators | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(ckpt_dir=ckpt_dir, deadline_factor=deadline_factor)
        if host is None and (graph is None or activity is None):
            raise ValueError("AsyncPsiDriver needs (graph, activity) "
                             "or host=")
        self.device = resolve_device(device)
        self.num_chunks = int(num_chunks)
        self.tau = int(tau)
        self.ckpt_every = int(ckpt_every)
        self.dtype = dtype
        self.max_workers = max_workers
        self.delay_hook = delay_hook
        self.read_hook = read_hook
        self.host = (host if host is not None
                     else HostOperators.from_graph(graph, activity))
        self.ops = self.host.to_device(dtype, self.device)
        self.chunked = ChunkedOperators(self.host, num_chunks, dtype=dtype,
                                        device=self.device)
        self.sched = AsyncChunkScheduler(
            self.chunked, bound=StalenessBound(tau), max_workers=max_workers,
            delay_hook=delay_hook, read_hook=read_hook)
        self._warm_s: torch.Tensor | None = None   # node order, by rechunk

    @classmethod
    def from_engine(cls, engine, **kw) -> "AsyncPsiDriver":
        """Build a driver from a prepared ``async`` PsiEngine (inherits its
        chunk count, staleness bound, dtype and device)."""
        if getattr(engine, "sched", None) is None:
            raise ValueError("engine has no async scheduler state; "
                             "use make_engine('async', graph=..., ...)")
        kw.setdefault("num_chunks", engine.num_chunks)
        kw.setdefault("tau", engine.tau)
        kw.setdefault("dtype", engine.dtype)
        kw.setdefault("device", engine.device)
        kw.setdefault("max_workers", engine.max_workers)
        kw.setdefault("delay_hook", engine.delay_hook)
        kw.setdefault("read_hook", engine.read_hook)
        return cls(engine.graph, engine.activity, **kw)

    # -- mutations between runs (O(Δ), reuse the scheduler's hooks) ------ #
    def patch_activity(self, users, lam=None, mu=None) -> None:
        self.host.patch_activity(users, lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        self.sched.patch_node_arrays()

    def patch_edges(self, src, dst) -> None:
        src, dst = self.host.patch_edges(src, dst)
        self.ops = self.host.to_device(self.dtype, self.device)
        if src.size:
            self.sched.patch_edges(src, dst)

    def remove_edges(self, src, dst) -> None:
        """Unfollow tombstones: delete from the host mirror and rebuild the
        touched chunks (same generation-guarded path as an insert)."""
        src, dst = self.host.remove_edges(src, dst)
        if src.size:
            self.ops = self.host.to_device(self.dtype, self.device)
            self.sched.patch_edges(src, dst)

    # -- execution ------------------------------------------------------- #
    def run(self, *, tol: float = 1e-8, max_iter: int = 2000,
            fail_hook: Callable[[int], bool] | None = None,
            epoch_hook: Callable[[int], None] | None = None,
            warm: bool = False) -> AsyncDriverReport:
        """Drive the pipeline to a certified + sync-verified ``tol``.

        The gap convention matches ``PsiDriver.run``: raw l1 (no ‖B‖
        scaling). ``max_iter`` bounds per-chunk epochs — comparable to the
        sync driver's iteration budget since one epoch of every chunk is
        one global iteration's worth of work.

        ``epoch_hook(min_epoch)`` fires on every epoch-floor advance and
        may call the driver's generation-guarded patch hooks
        (``patch_activity`` / ``patch_edges`` / ``remove_edges``) while the
        pipeline is live — the streaming ingestor's mid-flight entry point
        (:mod:`repro_torch.stream`): a patch marks in-flight gap records
        untrusted, so termination is always certified on the *patched*
        operators.

        ``warm=True`` restarts the pipeline from the current board instead
        of the cold s₀ = c — the serving re-resolve path after O(Δ)
        patches (a ``rechunk`` warm carry, when staged, takes precedence).
        """
        sched = self.sched
        self._reset_tracking()
        if self._warm_s is not None:
            sched.reset(s0=self._warm_s)     # one-shot, like PsiDriver
            self._warm_s = None
        elif warm:
            # serving re-resolve: restart the pipeline from the current
            # board (≈ the previous fixed point after an O(Δ) patch). The
            # first run's board is still the cold s₀ = c, so warm=True is
            # always safe.
            sched.reset(s0=self.chunked.node_order(sched.board))
        else:
            sched.reset()
        restarts = 0
        tick = 0
        last_ckpt = 0
        np_dtype = numpy_dtype(self.dtype)
        self._ckpt_save(0, dict(**sched.export_state(), it=np.int64(0)))

        def on_epoch(s: AsyncChunkScheduler, min_epoch: int) -> None:
            nonlocal restarts, tick, last_ckpt
            tick += 1
            if epoch_hook is not None:
                epoch_hook(min_epoch)
            if self.ckpt_dir and min_epoch >= last_ckpt + self.ckpt_every:
                self._ckpt_save(min_epoch, dict(**s.export_state(),
                                                it=np.int64(min_epoch)))
                last_ckpt = min_epoch
            if fail_hook is not None and fail_hook(tick):
                restarts += 1
                data = self._ckpt_restore_latest(dict(
                    s=np.zeros(self.chunked.n_pad, np_dtype),
                    epochs=np.zeros(self.num_chunks, np.int64),
                    it=np.int64(0)))
                if data is not None:
                    # the epoch vector rides in the checkpoint: the restart
                    # resumes the *skewed* pipeline, not a sync collapse
                    s.request_restore(data["s"], data["epochs"])
                    last_ckpt = int(data["it"])

        rec = obs_convergence.begin("async_driver")
        with obs_trace.span("async.run", tau=self.tau,
                            num_chunks=self.num_chunks) as sp:
            out = sched.run(tol=tol, max_epochs=max_iter, scale=1.0,
                            epoch_callback=on_epoch)
            sp.sync(out.s)
        obs_convergence.finish(rec, iterations=int(out.epochs.max()),
                               gap=out.gap, converged=bool(out.converged),
                               duration_s=sp.duration_s)
        obs_metrics.gauge(
            "psi_async_overlap_efficiency",
            "sum of worker busy seconds / wall seconds (>1 means overlap)"
        ).set(out.overlap_efficiency)
        obs_metrics.gauge("psi_async_max_staleness",
                          "max epoch spread seen by the last async run"
                          ).set(out.max_staleness)
        # step_log is per-run (cleared at run entry) and includes drained
        # steps; sync verification sweeps run on the scheduling thread and
        # are reported via sync_sweeps, not per-step durations
        for chunk, _epoch, dur in sched.step_log:
            self._note_duration(chunk, dur)
        psi = self.ops.psi_epilogue(self.chunked.node_order(out.s))
        return AsyncDriverReport(
            iterations=int(out.epochs.max()), gap=out.gap,
            chunks=out.total_steps, restarts=restarts,
            slow_chunks=self._slow, psi=psi.cpu().numpy(),
            chunk_durations=self._durations,
            slow_chunk_events=self._slow_events,
            max_staleness=out.max_staleness,
            overlap_efficiency=out.overlap_efficiency,
            sync_sweeps=out.sync_sweeps,
            rejected_certificates=out.rejected_certificates,
            epochs=out.epochs, tau=self.tau, converged=bool(out.converged))

    # ------------------------------------------------------------------ #
    def rechunk(self, num_chunks: int, *, tau: int | None = None
                ) -> "AsyncPsiDriver":
        """Elastic re-chunk: carry the board across a chunk-count change
        (the async analogue of ``PsiDriver.remesh``). The next ``run``
        warm-starts the new pipeline from the converted board."""
        s_node = self.chunked.node_order(self.sched.board)
        # host= (not graph()/activity() re-export): the successor inherits
        # the same accumulator state, so the fixed point is bit-identical
        driver = AsyncPsiDriver(
            host=self.host,
            num_chunks=num_chunks, tau=self.tau if tau is None else tau,
            ckpt_dir=self.ckpt_dir, ckpt_every=self.ckpt_every,
            deadline_factor=self.deadline_factor, dtype=self.dtype,
            max_workers=self.max_workers, delay_hook=self.delay_hook,
            read_hook=self.read_hook, device=self.device)
        driver._warm_s = s_node.clone()
        return driver
