"""Bounded-staleness chunk scheduler for Power-ψ.

The global Alg. 2 iteration ``s' = μ ⊙ ((s ⊙ 1/w) P) + c`` decomposes by
*destination* rows into C chunks: chunk k owns the contiguous node range
``[k·q, (k+1)·q)`` and its update reads the whole board (every chunk's
latest published slice) but writes only its own slice. Run synchronously,
one sweep of all chunks *is* one global iteration (the per-chunk segment
sums partition the edge set, so the chunk l1 gaps sum to the global l1 gap
up to the order of the final additions).

:class:`AsyncChunkScheduler` removes the barrier between those chunk steps:

* **epoch tags + a fresh board per publish** — every chunk carries an
  epoch counter; its step output is published into a *new* board tensor
  (never written in place: in-flight readers hold snapshots up to τ epochs
  old) tagged with the new epoch.
* **overlapped dispatch** — the scheduling thread submits every eligible
  chunk to a worker pool and never waits on a device value: each worker
  forces its own result (the gap read), on its own CUDA stream on a card.
* **straggler absorption** — a chunk may be dispatched while up to
  ``tau`` epochs behind the fastest chunk (:class:`StalenessBound`); a slow
  worker therefore stalls the pipeline only when someone would otherwise
  run more than ``tau`` ahead, instead of stalling every epoch the way a
  bulk-synchronous barrier does. ``tau = 0`` recovers exactly the
  barriered schedule.
* **mid-flight patches** — ``patch_node_arrays`` / ``patch_edges`` swap the
  affected chunks' operator args between that chunk's epochs without
  draining the pipeline; a generation counter marks pre-patch gap records
  untrusted so the certificate never terminates on stale operators.

Streams on a card: the scheduling thread publishes on its current stream
and records an event at each dispatch; the worker's stream waits on that
event before it reads the board, and the published ``s_new`` is marked as
used by the publishing stream (``record_stream``), so the caching allocator
never hands memory one stream still reads to another.

Termination: per-chunk gaps are assembled into a
:class:`~repro_torch.asyncexec.staleness.GapCertificate`; when the
certificate *accepts* (within-τ spread, certified ρ-inflated gap ≤ tol) the
scheduler drains in-flight work and runs one synchronous verification
sweep — the final convergence decision is always a true same-epoch Eq. 19
gap.

The segment sums are ``torch.segment_reduce`` over each chunk's dst-sorted
edge runs, whose lengths are counted on the host when a chunk is built or
patched (no atomics, no per-step ``bincount``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable

import numpy as np
import torch

from ..core.operators import HostOperators
from ..device import numpy_dtype, resolve_device
from ..obs import convergence as obs_convergence
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .staleness import (GapCertificate, RhoEstimator, StalenessBound,
                        certify_gap)

__all__ = ["ChunkArgs", "ChunkedOperators", "AsyncChunkScheduler",
           "SchedulerRun", "make_chunk_step"]


@dataclasses.dataclass(frozen=True)
class ChunkArgs:
    """Device args of one chunk's step (shapes uniform across chunks)."""

    src: torch.Tensor      # i64[e_max] board index of edge src; sentinel n_pad
    lengths: torch.Tensor  # i64[q+1] dst run lengths; the sentinel run last
    mu: torch.Tensor       # f[q]
    c: torch.Tensor        # f[q]
    inv_w: torch.Tensor    # f[n_pad] — shared (same tensor every chunk)
    start: int             # board offset k·q


def make_chunk_step(q: int):
    """The pure per-chunk step ``(ChunkArgs, board) -> (s_k_new, raw_gap_k)``.

    Identical math to one dst-row block of the reference iteration: gather
    the board through 1/w, segment sum over the chunk's dst-sorted runs
    onto its q nodes, μ/c epilogue, l1 delta against the chunk's current
    board slice.
    """

    def chunk_step(args: ChunkArgs, board: torch.Tensor):
        s_pre = torch.cat([board * args.inv_w, board.new_zeros(1)])
        t = torch.segment_reduce(s_pre[args.src], "sum",
                                 lengths=args.lengths, unsafe=True)[:q]
        s_new = args.mu * t + args.c
        s_old = board[args.start:args.start + q]
        return s_new, torch.sum(torch.abs(s_new - s_old))

    return chunk_step


class ChunkedOperators:
    """Host-buildable, incrementally patchable chunk decomposition.

    Built from the same mutable :class:`HostOperators` mirror the engines
    patch, so the O(Δ) serving hooks compose: an activity patch refreshes
    only the O(N) node vectors; an edge patch rebuilds only the touched
    chunks' edge arrays (the dst-sorted host view makes each chunk's edges
    one contiguous slice). ``e_max`` is lane-padded with sentinel slots;
    only a genuine chunk overflow regrows it.
    """

    def __init__(self, host: HostOperators, num_chunks: int, *,
                 dtype: torch.dtype = torch.float32, lane_pad: int = 128,
                 device: str | torch.device = "cuda"):
        if num_chunks < 1:
            raise ValueError(f"num_chunks must be >= 1; got {num_chunks}")
        self.host = host
        self.num_chunks = int(num_chunks)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.lane_pad = int(lane_pad)
        self.n = host.n
        self.q = -(-host.n // self.num_chunks)
        self.n_pad = self.q * self.num_chunks
        self._np_dtype = numpy_dtype(dtype)
        self.e_max = 0
        self.args: list[ChunkArgs] = [None] * self.num_chunks
        self._refresh_node_pads()
        self.refresh_edges()

    # -- layout converters ---------------------------------------------- #
    def _pad(self, v: np.ndarray) -> torch.Tensor:
        out = np.zeros(self.n_pad, self._np_dtype)
        out[: self.n] = np.asarray(v).astype(self._np_dtype)
        return torch.as_tensor(out, device=self.device)

    def board_from_node_order(self, s) -> torch.Tensor:
        out = torch.zeros(self.n_pad, dtype=self.dtype, device=self.device)
        out[: self.n] = torch.as_tensor(s).to(self.device, self.dtype)
        return out

    def node_order(self, board: torch.Tensor) -> torch.Tensor:
        return board[: self.n]

    @property
    def board0(self) -> torch.Tensor:
        """Cold start s₀ = c (pad nodes at 0, where μ = c = 0 keeps them)."""
        c, _ = self.host.cd()
        return self._pad(c)

    # -- (re)builds ------------------------------------------------------ #
    def _refresh_node_pads(self) -> None:
        c, _ = self.host.cd()
        self._inv_w_pad = self._pad(self.host.inv_w)
        self._mu_pad = self._pad(self.host.mu)
        self._c_pad = self._pad(c)

    def _chunk_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        edges = np.arange(self.num_chunks + 1, dtype=np.int64) * self.q
        cut = np.searchsorted(self.host.dst_by_dst, edges, side="left")
        return cut[:-1], cut[1:]

    def _build_chunk(self, k: int, lo: int, hi: int) -> ChunkArgs:
        cnt = hi - lo
        src = np.full(self.e_max, self.n_pad, np.int64)
        dstl = np.full(self.e_max, self.q, np.int64)
        src[:cnt] = self.host.src_by_dst[lo:hi]
        dstl[:cnt] = self.host.dst_by_dst[lo:hi] - k * self.q
        sl = slice(k * self.q, (k + 1) * self.q)
        dev = self.device
        return ChunkArgs(
            src=torch.as_tensor(src, device=dev),
            lengths=torch.as_tensor(np.bincount(dstl, minlength=self.q + 1),
                                    device=dev),
            mu=self._mu_pad[sl], c=self._c_pad[sl], inv_w=self._inv_w_pad,
            start=k * self.q)

    def refresh_edges(self, touched_chunks=None) -> bool:
        """Rebuild the edge arrays of ``touched_chunks`` (all when None)
        from the host mirror. Returns True when ``e_max`` grew (every
        chunk's shape changed)."""
        lo, hi = self._chunk_bounds()
        need = int((hi - lo).max()) if self.num_chunks else 0
        grew = need > self.e_max
        if grew or self.e_max == 0:
            self.e_max = max(-(-max(need, 1) // self.lane_pad)
                             * self.lane_pad, self.lane_pad)
            touched_chunks = None            # every chunk's shape changed
        ks = (range(self.num_chunks) if touched_chunks is None
              else sorted(set(int(k) for k in touched_chunks)))
        for k in ks:
            self.args[k] = self._build_chunk(k, int(lo[k]), int(hi[k]))
        return grew

    def refresh_node_arrays(self) -> None:
        """Post-``patch_activity`` refresh: new μ/c slices + the shared
        1/w board vector (one shared device tensor — O(N) once, not
        O(C·N))."""
        self._refresh_node_pads()
        for k in range(self.num_chunks):
            sl = slice(k * self.q, (k + 1) * self.q)
            self.args[k] = dataclasses.replace(
                self.args[k], mu=self._mu_pad[sl], c=self._c_pad[sl],
                inv_w=self._inv_w_pad)

    def chunks_of_nodes(self, nodes) -> np.ndarray:
        return np.unique(np.asarray(nodes, np.int64) // self.q)


@dataclasses.dataclass
class SchedulerRun:
    """Outcome of one :meth:`AsyncChunkScheduler.run`."""

    s: torch.Tensor              # final board (padded layout)
    epochs: np.ndarray           # per-chunk epoch vector at exit
    gap: float                   # true synchronous Eq. 19 gap (scaled)
    converged: bool
    total_steps: int             # chunk-steps consumed (incl. sweeps)
    sync_sweeps: int             # verification sweeps run
    max_staleness: int           # max observed epoch spread
    overlap_efficiency: float    # Σ worker busy time / wall-clock (>1 ⇒ overlap)
    wall_s: float
    rejected_certificates: int   # gaps under tol refused for τ-violation
    certificate: GapCertificate | None


class AsyncChunkScheduler:
    """Overlapped bounded-staleness execution of a :class:`ChunkedOperators`.

    ``delay_hook(chunk, epoch) -> seconds`` injects a simulated straggler
    (slept inside that chunk's worker). ``read_hook(reader, neighbor,
    epochs) -> lag`` forces the reader to consume ``neighbor``'s slice from
    ``lag`` epochs ago (served from the epoch-tagged history ring) — the
    staleness-injection harness the property tests drive; production reads
    take the latest board snapshot and their staleness arises only from
    genuine pipeline skew.
    """

    def __init__(self, chunked: ChunkedOperators, *,
                 bound: StalenessBound | None = None,
                 max_workers: int | None = None,
                 delay_hook: Callable[[int, int], float] | None = None,
                 read_hook: Callable[[int, int, np.ndarray], int]
                 | None = None):
        self.chunked = chunked
        self.bound = bound or StalenessBound()
        self.max_workers = max_workers
        self.delay_hook = delay_hook
        self.read_hook = read_hook
        self._step = make_chunk_step(chunked.q)
        self._streams = threading.local()    # one CUDA stream a worker
        self._rho = RhoEstimator(init=self.bound.rho or 0.9)
        # per-run worker-step forensics, cleared at each run() entry
        self.step_log: list[tuple[int, int, float]] = []   # (chunk, epoch, s)
        self._restore: tuple[np.ndarray, np.ndarray] | None = None
        self._cancelled = False
        self.reset()

    # -- state ----------------------------------------------------------- #
    @property
    def num_chunks(self) -> int:
        return self.chunked.num_chunks

    def reset(self, s0=None, epochs=None) -> None:
        ch = self.chunked
        if s0 is None:
            self.board = ch.board0
        elif tuple(np.shape(s0)) == (ch.n,):
            self.board = ch.board_from_node_order(s0)
        else:
            self.board = torch.as_tensor(s0).to(ch.device, ch.dtype)
        self.epochs = (np.zeros(self.num_chunks, np.int64) if epochs is None
                       else np.asarray(epochs, np.int64).copy())
        self._gaps: list[tuple[float, int, int] | None] = (
            [None] * self.num_chunks)                 # (raw, epoch, gen)
        self._gen = getattr(self, "_gen", 0)
        self._history: list[dict[int, np.ndarray]] = [
            {} for _ in range(self.num_chunks)]
        if self.read_hook is not None:
            self._snapshot_history()
        self._rho.reset()

    def _rho_value(self) -> float:
        """A user-pinned a-priori ρ governs the certificate outright; the
        online estimate only fills in when no bound was given."""
        return self.bound.rho if self.bound.rho is not None \
            else self._rho.value

    def export_state(self) -> dict:
        """Checkpointable async state: the board *and* the epoch vector —
        a restart resumes the skewed pipeline exactly, not an approximation
        of it (in-flight steps are the only lost work)."""
        return dict(s=self.board.cpu().numpy(), epochs=self.epochs.copy())

    def request_restore(self, s: np.ndarray, epochs: np.ndarray) -> None:
        """Ask the run loop to drop in-flight work and resume from a
        checkpointed (board, epoch-vector) pair (callable from
        ``epoch_callback``)."""
        self._restore = (np.asarray(s), np.asarray(epochs, np.int64))

    def cancel(self) -> None:
        """Cooperatively abort the current :meth:`run` — thread-safe, so a
        watchdog can call it while the scheduling thread is inside the
        loop. The run returns its current (unconverged) state at the next
        loop check; hung workers are abandoned to the pool rather than
        joined, so a stuck chunk cannot hold the deadline hostage."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        """True when the last :meth:`run` exited via :meth:`cancel`."""
        return self._cancelled

    # -- mid-flight patches ---------------------------------------------- #
    def patch_node_arrays(self) -> None:
        """Adopt a host-side activity patch without draining the pipeline:
        args swap now, in-flight steps finish against the old operators and
        their gap records are generation-marked so the certificate ignores
        them (their published slices are just one more bounded-stale
        iterate, which the contraction absorbs)."""
        self.chunked.refresh_node_arrays()
        self._gen += 1

    def patch_edges(self, src, dst) -> None:
        """Adopt a host-side edge patch; only the touched dst chunks'
        edge arrays rebuild (O(edges-in-chunk) host work, O(Δ) chunks).
        Node pads refresh first — a new edge (j → i) changed w_j, so the
        shared 1/w board vector must be current before any chunk rebuild."""
        touched = self.chunked.chunks_of_nodes(dst)
        self.chunked.refresh_node_arrays()
        self.chunked.refresh_edges(touched)
        self._gen += 1

    # -- execution -------------------------------------------------------- #
    def _worker_stream(self, device) -> torch.cuda.Stream:
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(device)
        return stream

    def _worker(self, k: int, args: ChunkArgs, board: torch.Tensor,
                delay: float, epoch: int = -1, ready=None):
        # the span both times the step (shared clock — step_log, the
        # psi_chunk_seconds histogram and the trace agree) and runs on the
        # worker's own span stack; (chunk, epoch) name the chunk chain
        with obs_trace.span("async.step", chunk=k, epoch=epoch) as sp:
            if delay and delay > 0:
                time.sleep(float(delay))
            if board.is_cuda:
                stream = self._worker_stream(board.device)
                stream.wait_event(ready)     # the board's publish is done
                with torch.cuda.stream(stream):
                    s_new, gap = self._step(args, board)
                    raw = float(gap)         # waits for this stream only
            else:
                s_new, gap = self._step(args, board)
                raw = float(gap)
        return s_new, raw, sp.duration_s

    def _publish_board(self, board: torch.Tensor, s_new: torch.Tensor,
                       k: int) -> torch.Tensor:
        """A new board: ``board`` with chunk k's slice replaced (the old
        one stays intact for its in-flight readers)."""
        if s_new.is_cuda:
            # s_new came from a worker's stream: this stream reads it now
            s_new.record_stream(torch.cuda.current_stream(s_new.device))
        new = board.clone()
        q = self.chunked.q
        new[k * q:(k + 1) * q] = s_new
        return new

    def _publish(self, k: int, s_new: torch.Tensor) -> None:
        if self.read_hook is not None:
            self._history[k][int(self.epochs[k]) + 1] = s_new.cpu().numpy()
            for e in sorted(self._history[k])[:-(self.bound.tau + 2)]:
                del self._history[k][e]
        self.board = self._publish_board(self.board, s_new, k)
        self.epochs[k] += 1

    def _snapshot_history(self) -> None:
        host = self.board.cpu().numpy()
        q = self.chunked.q
        for k in range(self.num_chunks):
            self._history[k][int(self.epochs[k])] = host[k * q:(k + 1) * q]

    def _compose_read(self, reader: int) -> torch.Tensor:
        """History-served board for the staleness-injection harness."""
        parts = []
        for j in range(self.num_chunks):
            lag = 0 if j == reader else int(
                self.read_hook(reader, j, self.epochs))
            lag = max(0, min(lag, self.bound.tau))
            have = sorted(self._history[j])
            want = int(self.epochs[j]) - lag
            epoch = max([e for e in have if e <= want], default=have[0])
            parts.append(self._history[j][epoch])
        return torch.as_tensor(np.concatenate(parts),
                               device=self.chunked.device)

    def sync_sweep(self, board=None):
        """One *synchronous* global iteration: every chunk steps against the
        same input board. Returns ``(new_board, raw_l1_gap)`` — the exact
        Alg. 2 step + Eq. 19 gap the synchronous backends compute."""
        board = self.board if board is None else board
        outs = [self._step(self.chunked.args[k], board)
                for k in range(self.num_chunks)]
        new = board.clone()
        q = self.chunked.q
        raw = 0.0
        for k, (s_new, g) in enumerate(outs):
            new[k * q:(k + 1) * q] = s_new
            raw += float(g)
        return new, raw

    def _submit(self, pool, k: int, next_epoch: int):
        delay = self.delay_hook(k, next_epoch) if self.delay_hook else 0.0
        board_read = (self._compose_read(k) if self.read_hook is not None
                      else self.board)
        ready = None
        if board_read.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(board_read.device))
        return pool.submit(self._worker, k, self.chunked.args[k], board_read,
                           delay, next_epoch, ready)

    def run(self, *, tol: float, max_epochs: int = 10_000,
            scale: float = 1.0, s0=None,
            epoch_callback: Callable[["AsyncChunkScheduler", int], None]
            | None = None) -> SchedulerRun:
        """Drive the pipeline until a certified + verified Eq. 19 stop.

        ``epoch_callback(scheduler, min_epoch)`` fires whenever the epoch
        *floor* advances — the async analogue of the sync driver's
        between-chunk hook point (checkpointing, failure injection via
        :meth:`request_restore`, elastic decisions).
        """
        C = self.num_chunks
        tau = self.bound.tau
        if s0 is not None:
            self.reset(s0=s0)
        busy = 0.0
        total_steps = 0
        sync_sweeps = 0
        max_stale = 0
        rejected = 0
        cert: GapCertificate | None = None
        converged = False
        gap = float("inf")
        self.step_log.clear()            # per-run forensics (see driver)
        self._cancelled = False          # a prior run's cancel doesn't carry
        t_start = time.perf_counter()
        inflight: dict[int, tuple] = {}
        pool = ThreadPoolExecutor(max_workers=self.max_workers or C)

        def collect(k):
            nonlocal busy, total_steps
            fut, gen = inflight.pop(k)
            s_new, raw, dur = fut.result()
            self._publish(k, s_new)
            self._gaps[k] = (raw, int(self.epochs[k]), gen)
            self.step_log.append((k, int(self.epochs[k]), dur))
            busy += dur
            total_steps += 1

        try:
            while True:
                if self._cancelled:
                    break
                min_e = int(self.epochs.min())
                for k in range(C):
                    if k in inflight or self.epochs[k] >= max_epochs:
                        continue
                    if self.epochs[k] - min_e > tau:
                        continue                      # bounded staleness
                    inflight[k] = (self._submit(pool, k,
                                                int(self.epochs[k]) + 1),
                                   self._gen)
                if not inflight:
                    break                             # epoch budget exhausted
                # bounded wait: a hung worker (fault injection, a wedged
                # device) must not block the cancel check above forever
                wait([f for f, _ in inflight.values()],
                     return_when=FIRST_COMPLETED, timeout=0.2)
                for k in [k for k, (f, _) in inflight.items() if f.done()]:
                    collect(k)
                spread = int(self.epochs.max() - self.epochs.min())
                max_stale = max(max_stale, spread)
                obs_metrics.gauge(
                    "psi_async_epoch_spread",
                    "current max-min per-chunk epoch skew").set(spread)
                new_min = int(self.epochs.min())
                if new_min > min_e and epoch_callback is not None:
                    epoch_callback(self, new_min)
                if self._restore is not None:
                    s, e = self._restore
                    self._restore = None
                    for f, _ in inflight.values():    # discard lost work
                        f.cancel()
                    wait([f for f, _ in inflight.values()])
                    inflight.clear()
                    self.reset(s0=torch.as_tensor(s), epochs=e)
                    continue
                if any(g is None or g[2] != self._gen for g in self._gaps):
                    continue                          # pre-patch / cold gaps
                cert = certify_gap(
                    [g[0] for g in self._gaps], [g[1] for g in self._gaps],
                    bound=self.bound, rho=self._rho_value(), scale=scale)
                if not cert.trusted:
                    # mid-epoch skew is routine (completions land one at a
                    # time); only a gap that would have *certified* on
                    # magnitude but was refused for staleness is a real
                    # rejection event
                    if cert.certified_gap <= tol:
                        rejected += 1
                        obs_metrics.counter(
                            "psi_async_rejected_certificates_total",
                            "stale-refused certificates that passed on "
                            "magnitude").inc()
                    continue
                obs_convergence.record_gap(total_steps, raw=cert.raw_gap,
                                           certified=cert.certified_gap)
                self._rho.update(cert.raw_gap)
                if cert.certified_gap > tol:
                    continue
                # certificate accepted → drain + synchronous verification
                wait([f for f, _ in inflight.values()])
                for k in [k for k, (f, _) in inflight.items() if f.done()]:
                    collect(k)
                board, raw_sync = self.sync_sweep()
                sync_sweeps += 1
                total_steps += C
                gap = scale * raw_sync
                # the sealing sweep's gap is the *verified* Eq. 19 gap
                obs_convergence.record_gap(total_steps, raw=raw_sync,
                                           certified=gap)
                self._rho.update(gap)
                if gap > tol:
                    # a sweep that does not seal the run only measures: its
                    # board is not published. Publishing it would move every
                    # chunk to one epoch, so a chunk behind the others would
                    # skip epochs and its steps would no longer count 1, 2,
                    # ... Its gap becomes each chunk's record at the chunk's
                    # own epoch, so the certificate waits for new steps.
                    self._gaps = [(raw_sync / C, int(self.epochs[k]),
                                   self._gen) for k in range(C)]
                    continue
                self.board = board
                self.epochs[:] = int(self.epochs.max()) + 1
                e_now = int(self.epochs[0])
                self._gaps = [(raw_sync / C, e_now, self._gen)] * C
                if self.read_hook is not None:
                    self._snapshot_history()
                converged = True
                break
        finally:
            if self._cancelled:
                # abandon hung workers: drop queued steps, don't join the
                # running ones — their results are never published (inflight
                # is dead after return) and the threads drain in background
                for f, _ in inflight.values():
                    f.cancel()
                pool.shutdown(wait=False, cancel_futures=True)
            else:
                pool.shutdown(wait=True)
        wall = time.perf_counter() - t_start
        if not converged and gap == float("inf") and self._gaps[0]:
            gap = scale * sum(g[0] for g in self._gaps if g)
        return SchedulerRun(
            s=self.board, epochs=self.epochs.copy(), gap=float(gap),
            converged=converged, total_steps=total_steps,
            sync_sweeps=sync_sweeps, max_staleness=max_stale,
            overlap_efficiency=busy / max(wall, 1e-9), wall_s=wall,
            rejected_certificates=rejected, certificate=cert)
