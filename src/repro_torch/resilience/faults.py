"""Deterministic, seeded fault injection for the ψ serving stack.

A :class:`FaultPlan` is a frozen *schedule* of faults; :meth:`FaultPlan.clock`
instantiates it into a :class:`FaultClock` — the stateful harness that
plugs into the stack's existing extension points (nothing here monkeypatches
anything; every injection goes through a hook the production code already
exposes, so the faulted code path IS the production code path):

====================  =====================================================
fault class           injection point
====================  =====================================================
``crash``             ``AsyncPsiDriver.run(fail_hook=clock.fail_hook())`` —
                      drop in-memory state, restore from last checkpoint
``hang``              ``AsyncPsiDriver(delay_hook=clock.delay_hook())`` —
                      one chunk's worker sleeps (straggler / wedged device)
``stale_read``        ``AsyncPsiDriver(read_hook=clock.read_hook())`` —
                      force maximum-τ stale reads of one chunk's slice
``torn_ckpt``         ``clock.tear_checkpoint(dir)`` — truncate the newest
                      step's MANIFEST.json mid-file (torn write)
``poison``            ``clock.poison_patch(users, lam, mu)`` — corrupt a
                      pending activity patch (NaN / Inf / negative / an
                      α≥1-inducing rate blow-up)
``dup``/``reorder``/  ``clock.wrap_source(log)`` — a sequence-numbered feed
``drop``              that duplicates, shuffles (bounded window), and drops
                      events (at-least-zero delivery; the exactly-once
                      replay layer in ``recovery.py`` repairs it)
====================  =====================================================

Determinism: every random choice draws from one ``np.random.default_rng``
seeded by the plan, and every hook's decision depends only on its call
arguments and that stream — two runs of the same plan against the same
workload inject byte-identical fault schedules. The module is the JAX
package's ``repro.resilience.faults`` (pure numpy) up to the package name,
so one plan gives both packages the same schedule, event for event.

Accounting: the clock counts ``injected[kind]``; *survival* is declared by
the verification layer (``note_survived``) once the corresponding defense
is proven to have worked — e.g. stream faults are survived exactly when
the exactly-once replay delivered the pristine log. The pair feeds the
:class:`~repro_torch.resilience.supervisor.ResilienceReport`.
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Iterator

import numpy as np

from ..ckpt import checkpoint
from ..stream.events import ReplayLog

__all__ = ["FaultPlan", "FaultClock", "FaultyFeed", "POISON_KINDS"]

POISON_KINDS = ("nan", "inf", "negative", "alpha")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible fault schedule (all classes optional; 0/None = off).

    Args:
      seed: the one seed behind every random choice the clock makes.
      crash_every: ``fail_hook`` returns True every this-many ticks
        (epoch-floor advances) — simulated process crash + restore.
      hang_chunk / hang_epoch / hang_delay_s: chunk ``hang_chunk`` sleeps
        ``hang_delay_s`` seconds before its step at epoch ``hang_epoch``
        (and every ``hang_epoch`` epochs after, keeping the straggler hot).
      stale_chunk / stale_lag: every reader of ``stale_chunk``'s slice is
        forced ``stale_lag`` epochs behind (clamped to τ by the scheduler).
      torn_after_saves: ``tear_checkpoint`` arms after this many calls —
        the n-th call actually tears (one torn write per plan).
      poison_kind: what :meth:`FaultClock.poison_patch` injects.
      dup_every / reorder_window / drop_every: event-feed corruption — every
        ``dup_every``-th delivered event is delivered twice, delivery order
        is shuffled inside a ``reorder_window``-sized buffer, and every
        ``drop_every``-th event is silently dropped.
    """

    seed: int = 0
    crash_every: int = 0
    hang_chunk: int | None = None
    hang_epoch: int = 5
    hang_delay_s: float = 0.25
    stale_chunk: int | None = None
    stale_lag: int = 8
    torn_after_saves: int = 0
    poison_kind: str = "nan"
    dup_every: int = 0
    reorder_window: int = 0
    drop_every: int = 0

    def __post_init__(self):
        if self.poison_kind not in POISON_KINDS:
            raise ValueError(f"poison_kind must be one of {POISON_KINDS}; "
                             f"got {self.poison_kind!r}")

    def clock(self) -> "FaultClock":
        return FaultClock(self)


class FaultClock:
    """One run's stateful instantiation of a :class:`FaultPlan`."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.injected: Counter = Counter()
        self.survived: Counter = Counter()
        self._saves_seen = 0
        self._torn_done = False

    def note_survived(self, kind: str, n: int = 1) -> None:
        """Credit ``n`` survived faults of ``kind`` — called by the layer
        that *verified* the defense worked, never by the injector itself."""
        self.survived[kind] += int(n)

    # -- async-driver hooks ---------------------------------------------- #
    def fail_hook(self):
        """``fail_hook(tick) -> bool`` for ``AsyncPsiDriver.run``: a crash
        every ``crash_every`` epoch-floor ticks."""
        every = self.plan.crash_every

        def hook(tick: int) -> bool:
            if every and tick % every == 0:
                self.injected["crash"] += 1
                return True
            return False

        return hook

    def delay_hook(self):
        """``delay_hook(chunk, epoch) -> seconds``: a recurring hang of one
        chunk's worker."""
        p = self.plan

        def hook(chunk: int, epoch: int) -> float:
            if (p.hang_chunk is not None and chunk == p.hang_chunk
                    and p.hang_epoch and epoch % p.hang_epoch == 0):
                self.injected["hang"] += 1
                return p.hang_delay_s
            return 0.0

        return hook

    def read_hook(self):
        """``read_hook(reader, neighbor, epochs) -> lag``: force stale
        reads of one chunk's slice (scheduler clamps to τ)."""
        p = self.plan

        def hook(reader: int, neighbor: int, epochs: np.ndarray) -> int:
            if p.stale_chunk is not None and neighbor == p.stale_chunk:
                self.injected["stale_read"] += 1
                return p.stale_lag
            return 0

        return hook

    # -- checkpoint corruption ------------------------------------------- #
    def tear_checkpoint(self, directory: str) -> bool:
        """Tear the *newest* complete step: truncate its MANIFEST.json
        mid-file, as a crash halfway through a non-atomic write would.
        Arms on the ``torn_after_saves``-th call; tears once per plan.
        Returns True when a tear actually happened."""
        if not self.plan.torn_after_saves or self._torn_done:
            return False
        self._saves_seen += 1
        if self._saves_seen < self.plan.torn_after_saves:
            return False
        steps = checkpoint.complete_steps(directory)
        if not steps:
            return False
        mpath = os.path.join(directory, f"step_{steps[-1]:08d}",
                             "MANIFEST.json")
        with open(mpath) as f:
            text = f.read()
        # truncating a JSON object anywhere before its closing brace is
        # guaranteed unparseable — exactly the torn write being simulated
        with open(mpath, "w") as f:
            f.write(text[: max(1, len(text) // 2)])
        self._torn_done = True
        self.injected["torn_ckpt"] += 1
        return True

    # -- patch poisoning -------------------------------------------------- #
    def poison_patch(self, users, lam, mu):
        """Corrupt one entry of a pending activity patch per ``poison_kind``.

        ``nan`` / ``inf`` / ``negative`` must be rejected at the mutation
        boundary (``_validate_rates``); ``alpha`` passes those checks —
        finite, non-negative — but blows a user's μ up enough to push
        α = ‖M‖₁ toward/over 1, the divergence only the post-patch health
        sentinel (:func:`repro_torch.resilience.health.alpha_norm`) can catch.
        """
        users = np.asarray(users, np.int64).reshape(-1).copy()
        lam = np.asarray(lam, np.float64).reshape(-1).copy()
        mu = np.asarray(mu, np.float64).reshape(-1).copy()
        k = int(self.rng.integers(users.size))
        kind = self.plan.poison_kind
        if kind == "nan":
            lam[k] = np.nan
        elif kind == "inf":
            mu[k] = np.inf
        elif kind == "negative":
            lam[k] = -abs(lam[k]) - 1.0
        else:                                    # 'alpha': finite, ≥ 0, huge
            mu[k] = 1e12
        self.injected["poison"] += 1
        return users, lam, mu

    # -- event-feed corruption -------------------------------------------- #
    def wrap_source(self, log: ReplayLog, *, start: int = 0) -> "FaultyFeed":
        """A sequence-numbered feed of ``log[start:]`` with seeded
        duplication, bounded reordering, and drops."""
        return FaultyFeed(log, self, start=start)


class FaultyFeed:
    """Yields ``(seq, event)`` pairs of ``log[start:]`` — corrupted.

    ``seq`` is the event's absolute index in the log (the at-least-once
    transport's offset); downstream, :class:`ExactlyOnceReplay
    <repro_torch.resilience.recovery.ExactlyOnceReplay>` dedups on it, reorders
    through it, and re-fetches dropped offsets from the authoritative log.
    Iterating twice replays the identical corruption (fresh rng from the
    plan seed + a per-feed salt, so multiple feeds of one clock differ
    deterministically).
    """

    def __init__(self, log: ReplayLog, clock: FaultClock, *, start: int = 0):
        self.log = log
        self.clock = clock
        self.start = int(start)
        self._salt = int(clock.rng.integers(2 ** 31))

    def __iter__(self) -> Iterator[tuple]:
        p = self.clock.plan
        rng = np.random.default_rng((p.seed, self._salt))
        buf: list[tuple[int, object]] = []
        emitted = 0
        seen = 0

        def corrupt_emit(item):
            nonlocal emitted
            emitted += 1
            yield item
            if p.dup_every and emitted % p.dup_every == 0:
                self.clock.injected["dup"] += 1
                yield item

        for seq in range(self.start, len(self.log)):
            seen += 1
            if p.drop_every and seen % p.drop_every == 0:
                self.clock.injected["drop"] += 1
                continue
            buf.append((seq, self.log[seq]))
            if len(buf) > max(1, p.reorder_window):
                k = int(rng.integers(len(buf)))
                if buf[k][0] != min(b[0] for b in buf):
                    self.clock.injected["reorder"] += 1
                yield from corrupt_emit(buf.pop(k))
        while buf:
            k = int(rng.integers(len(buf)))
            if buf[k][0] != min(b[0] for b in buf):
                self.clock.injected["reorder"] += 1
            yield from corrupt_emit(buf.pop(k))
