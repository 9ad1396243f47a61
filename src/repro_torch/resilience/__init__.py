"""Fault injection, health sentinels, supervised resolves, and
crash-consistent recovery for the ψ serving stack: the JAX package's
``repro.resilience`` on the port's drivers and services.

Layered like the failures it handles:

* :mod:`~repro_torch.resilience.faults` — the seeded chaos harness
  (:class:`FaultPlan` → :class:`FaultClock` → production hook points).
* :mod:`~repro_torch.resilience.health` — numerical sentinels (non-finite,
  α = ‖M‖₁ ≥ 1, gap growth, certificate storms) + quarantine wrappers.
* :mod:`~repro_torch.resilience.supervisor` — :class:`ResilientResolver`'s
  deadline/retry/escalation ladder ending in tagged degraded serving.
* :mod:`~repro_torch.resilience.recovery` — whole-stack checkpoints + exactly-
  once replay back to the fault-free fixed point.
* :mod:`~repro_torch.resilience.check` — the end-to-end chaos acceptance gate
  (``python -m repro_torch.resilience.check``).
"""
from .faults import POISON_KINDS, FaultClock, FaultPlan, FaultyFeed
from .health import (LaneQuarantine, Sentinels, SentinelTrip, ServiceGuard,
                     alpha_norm, psi_residual_bound)
from .recovery import (ExactlyOnceReplay, RecoveredStack, StackCheckpointer,
                       reconcile, recover)
from .supervisor import (AttemptTimeout, ResilienceReport, ResilientResolver,
                         ResolveFailure, ResolveOutcome, SentinelFailure)

__all__ = [
    "FaultPlan", "FaultClock", "FaultyFeed", "POISON_KINDS",
    "SentinelTrip", "Sentinels", "alpha_norm", "psi_residual_bound",
    "LaneQuarantine", "ServiceGuard",
    "ResilientResolver", "ResolveOutcome", "ResilienceReport",
    "ResolveFailure", "AttemptTimeout", "SentinelFailure",
    "ExactlyOnceReplay", "StackCheckpointer", "RecoveredStack",
    "recover", "reconcile",
]
