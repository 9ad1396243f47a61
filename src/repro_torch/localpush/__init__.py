"""Local residual-push ψ solver with certified top-k early stop.

Sub-modules:
  * :mod:`repro_torch.localpush.push` — Gauss-Southwell forward push on the
    Eq. 19 residual (bucketed frontier, scalar oracle, device rounds) and
    the running certificate ``‖ψ_exact − ψ̂‖ ≤ scale·‖r‖₁``.
  * :mod:`repro_torch.localpush.topk` — rank-separation certificates: stop
    as soon as the k-th and (k+1)-th confidence intervals separate.
  * :mod:`repro_torch.localpush.warm` — O(Δ) residual reseeding under
    activity and edge patches (no mat-vec warm restarts).
  * :mod:`repro_torch.localpush.engine` — the registered ``backend="push"``
    :class:`~repro_torch.core.engine.PsiEngine`.
  * ``python -m repro_torch.localpush.check`` — the smoke gate.
"""
from .engine import PushEngine
from .push import (PushState, a_norm, cert_scale, cold_state, mass_weights,
                   neumann_error_bound, pernode_cert_scale, psi_value,
                   push_round, push_scalar, push_until, reseed_state)
from .topk import TopKCertificate, certify_top_k

__all__ = ["PushEngine", "PushState", "TopKCertificate", "a_norm",
           "cert_scale", "certify_top_k", "cold_state", "mass_weights",
           "neumann_error_bound", "pernode_cert_scale", "psi_value",
           "push_round", "push_scalar", "push_until", "reseed_state"]
