"""Crash-consistent recovery of the whole serving stack, with exactly-once
event replay.

The async driver's epoch-vector checkpoints give the solver crash
tolerance; the stream's replayable event log gives the platform a durable
source of truth. This module composes the two halves into crash-recovery of
the *whole* serving stack:

* :class:`StackCheckpointer` — one atomic checkpoint of everything the
  stack cannot recompute: the async board + epoch vector, the mutable
  :class:`~repro_torch.core.operators.HostOperators` mirror (rates, both sorted
  edge views, the float64 w/row_lam accumulators — bit-exact, because a
  rebuild from a re-exported graph would re-sum them in a different order),
  the :class:`~repro_torch.stream.estimator.RateEstimator` state, and the event
  **offset**: how many events of the log are already reflected in all of
  the above. Checkpoints are only taken at *flushed* points (the save
  flushes first) so the offset cleanly partitions the log into
  applied-prefix / to-replay-suffix — no event is half-applied.
* :class:`ExactlyOnceReplay` — repairs an at-least-zero transport into
  exactly-once delivery: duplicate sequence numbers are suppressed,
  out-of-order arrivals are held in a reorder buffer, and dropped offsets
  are re-fetched from the authoritative :class:`~repro_torch.stream.events
  .ReplayLog`. The delivered stream is provably ``log[start:]``, verbatim.
* :func:`recover` / :meth:`StackCheckpointer.recover` — rebuild the stack
  from the newest *complete* checkpoint (torn steps fall back, see
  ``ckpt.checkpoint``), replay ``log[offset:]`` through the exactly-once
  layer, and the result reaches the **same fixed point as the fault-free
  run**: the estimator state depends only on the event order (not on
  flush/crash boundaries), so after a :func:`reconcile` sweep the final
  operators agree to ulps and ψ to solver tolerance — the parity the
  chaos acceptance test (f64 ψ err ≤ 1e-12) measures.

The JAX package's ``repro.resilience.recovery`` on the port's driver: the
restored board and the solve run on ``device`` (the card by default; the
CPU only when asked for by name) in a torch ``dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..asyncexec.executor import AsyncPsiDriver
from ..ckpt import checkpoint
from ..core.activity import RATE_FLOOR
from ..core.operators import HostOperators
from ..stream.events import ReplayLog
from ..stream.freshness import FreshnessPolicy
from ..stream.ingest import StreamIngestor

__all__ = ["ExactlyOnceReplay", "StackCheckpointer", "RecoveredStack",
           "recover", "reconcile"]


class ExactlyOnceReplay:
    """Exactly-once delivery of ``log[start:]`` over a faulty (seq, event)
    feed (e.g. a :class:`~repro_torch.resilience.faults.FaultyFeed`).

    Guarantee: iterating yields exactly the events ``log[start:]``, once
    each, in order — regardless of duplication, bounded reordering, or
    drops in the feed. Three mechanisms, one per failure mode:

    * **dedup**: a sequence number below the delivery cursor (or already
      buffered) is a duplicate — suppressed.
    * **reorder buffer**: a sequence number ahead of the cursor is held
      until the gap before it closes.
    * **re-fetch**: when the feed ends (or the buffer is drained) with
      gaps remaining, the missing offsets are read from the authoritative
      log — the "consumer re-reads the partition from its committed
      offset" half of exactly-once semantics. The log is the durable
      source of truth; the feed is just the lossy transport in front.

    Counters (``duplicates_suppressed`` / ``reordered_held`` /
    ``refetched``) are observability, not the correctness argument — the
    chaos check asserts delivery parity directly.
    """

    def __init__(self, log: ReplayLog, feed, *, start: int = 0):
        self.log = log
        self.feed = feed
        self.start = int(start)
        self.duplicates_suppressed = 0
        self.reordered_held = 0
        self.refetched = 0
        self.delivered = 0

    def __iter__(self) -> Iterator:
        cursor = self.start
        pending: dict[int, object] = {}
        for seq, ev in self.feed:
            seq = int(seq)
            if seq < cursor or seq in pending:
                self.duplicates_suppressed += 1
                continue
            if seq > cursor:
                self.reordered_held += 1
                pending[seq] = ev
                continue
            self.delivered += 1
            yield ev
            cursor += 1
            while cursor in pending:
                self.delivered += 1
                yield pending.pop(cursor)
                cursor += 1
        # feed exhausted: anything not delivered was dropped (or stuck
        # behind a drop in the buffer) — re-fetch from the log
        for seq in range(cursor, len(self.log)):
            if seq in pending:
                ev = pending.pop(seq)
            else:
                ev = self.log[seq]
                self.refetched += 1
            self.delivered += 1
            yield ev


@dataclasses.dataclass
class RecoveredStack:
    """What :func:`recover` hands back: a live driver + ingestor pair
    positioned at ``offset``, ready to replay ``log[offset:]``."""

    driver: AsyncPsiDriver
    ingestor: StreamIngestor
    step: int            # checkpoint step restored
    offset: int          # events already reflected in the restored state

    def replay(self, log: ReplayLog, feed=None, *,
               resolve: bool = False) -> ExactlyOnceReplay:
        """Replay the un-applied suffix exactly-once (``feed`` defaults to
        the pristine enumerated log — pass a FaultyFeed to exercise the
        transport-repair path)."""
        if feed is None:
            feed = ((seq, log[seq]) for seq in range(self.offset, len(log)))
        replay = ExactlyOnceReplay(log, feed, start=self.offset)
        for ev in replay:
            self.ingestor.submit(ev)
        self.ingestor.flush()
        if resolve:
            self.ingestor.resolve()
        return replay


class StackCheckpointer:
    """Atomic whole-stack checkpoints over ``ckpt.checkpoint``.

    One checkpoint = one flat array tree holding board + epochs + offset +
    host mirror + estimator state. ``save`` flushes the ingestor first
    (checkpoint-at-quiescence: the offset means "everything before me is
    fully applied, nothing after me is"), then writes atomically (tmp dir
    + fsynced manifest + rename) so a crash mid-save can only ever lose
    the step being written, never corrupt a previous one.
    """

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = int(keep)
        self.saves = 0

    def save(self, step: int, driver: AsyncPsiDriver,
             ingestor: StreamIngestor) -> str:
        ingestor.flush()                 # quiescence: offset is a clean cut
        host = driver.host
        est = ingestor.estimator()
        tree = dict(
            board=driver.chunked.node_order(driver.sched.board).cpu().numpy(),
            epochs=driver.sched.epochs.copy(),
            offset=np.int64(ingestor.offset),
            event_t=np.float64(ingestor._event_t),
            num_chunks=np.int64(driver.num_chunks),
            tau=np.int64(driver.tau),
            host_n=np.int64(host.n),
            host_lam=host.lam.copy(), host_mu=host.mu.copy(),
            host_w=host.w.copy(), host_row_lam=host.row_lam.copy(),
            host_src_by_dst=host.src_by_dst.copy(),
            host_dst_by_dst=host.dst_by_dst.copy(),
            host_src_by_src=host.src_by_src.copy(),
            host_dst_by_src=host.dst_by_src.copy(),
            **{f"est_{k}": v for k, v in est.state_dict().items()},
        )
        path = checkpoint.save(self.directory, step, tree, keep=self.keep)
        self.saves += 1
        return path

    def recover(self, *, dtype: torch.dtype = torch.float32,
                half_life: float = 64.0, floor: float = RATE_FLOOR,
                policy: FreshnessPolicy | None = None,
                resolve_opts: dict | None = None,
                ckpt_dir: str | None = None,
                delay_hook=None, read_hook=None,
                device: str | torch.device = "cuda") -> RecoveredStack:
        return recover(self.directory, dtype=dtype, half_life=half_life,
                       floor=floor, policy=policy,
                       resolve_opts=resolve_opts, ckpt_dir=ckpt_dir,
                       delay_hook=delay_hook, read_hook=read_hook,
                       device=device)


def recover(directory: str, *, dtype: torch.dtype = torch.float32,
            half_life: float = 64.0, floor: float = RATE_FLOOR,
            policy: FreshnessPolicy | None = None,
            resolve_opts: dict | None = None, ckpt_dir: str | None = None,
            delay_hook=None, read_hook=None,
            device: str | torch.device = "cuda") -> RecoveredStack:
    """Rebuild the serving stack from the newest complete checkpoint in
    ``directory`` (corrupt/torn steps are skipped with a warning — the
    hardened ``ckpt.checkpoint`` walkers do the falling back). The
    rebuilt :class:`AsyncPsiDriver` runs on ``device`` (``"cuda"`` by
    default; raises without a card unless ``device="cpu"``).

    Raises FileNotFoundError when no complete checkpoint exists at all —
    there is nothing principled to recover to, and inventing a cold state
    would silently violate the exactly-once contract.
    """
    step = checkpoint.latest_step(directory)
    if step is None:
        raise FileNotFoundError(
            f"no complete stack checkpoint in {directory}")
    data = checkpoint.load_arrays(directory, step)

    host = HostOperators(
        n=int(data["host_n"]),
        lam=np.asarray(data["host_lam"], np.float64),
        mu=np.asarray(data["host_mu"], np.float64),
        src_by_dst=np.asarray(data["host_src_by_dst"], np.int32),
        dst_by_dst=np.asarray(data["host_dst_by_dst"], np.int32),
        src_by_src=np.asarray(data["host_src_by_src"], np.int32),
        dst_by_src=np.asarray(data["host_dst_by_src"], np.int32),
        w=np.asarray(data["host_w"], np.float64),
        row_lam=np.asarray(data["host_row_lam"], np.float64),
    )
    driver = AsyncPsiDriver(
        host=host, num_chunks=int(data["num_chunks"]),
        tau=int(data["tau"]), dtype=dtype, ckpt_dir=ckpt_dir,
        delay_hook=delay_hook, read_hook=read_hook, device=device)
    # resume the *skewed* pipeline exactly: board + per-chunk epoch vector,
    # and stage the board as the next run's one-shot warm start so the
    # first post-recovery resolve continues from it (run() always resets)
    board = np.asarray(data["board"])
    driver.sched.reset(s0=board, epochs=np.asarray(data["epochs"], np.int64))
    driver._warm_s = torch.from_numpy(board)

    offset = int(data["offset"])
    event_t = float(data["event_t"])
    ingestor = StreamIngestor(driver, half_life=half_life, floor=floor,
                              policy=policy, t0=event_t,
                              resolve_opts=resolve_opts or {})
    est = ingestor.estimator()           # creates the lane…
    est.load_state({k.removeprefix("est_"): v
                    for k, v in data.items() if k.startswith("est_")})
    ingestor.fast_forward(offset, event_t=event_t)
    return RecoveredStack(driver=driver, ingestor=ingestor, step=int(step),
                          offset=offset)


def reconcile(driver: AsyncPsiDriver, ingestor: StreamIngestor) -> None:
    """Pin the operators to the estimator's full current rate vector.

    Estimator state is a pure function of the event order, but the
    *drained* rates also depend on when each drain happened — so two runs
    with different flush/crash boundaries hold operators that differ by
    decay-evaluation times even after ingesting identical streams. One
    full-width patch from ``est.activity()`` (both runs evaluate it at the
    same final event time) collapses that path dependence: after
    reconciliation the fault-free and the recovered stack solve the same
    operators, and fixed-point parity is exact rather than approximate.
    """
    est = ingestor.estimator()
    act = est.activity()
    driver.patch_activity(np.arange(driver.host.n), lam=act.lam, mu=act.mu)
