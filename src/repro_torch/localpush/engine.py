"""``backend="push"`` — the local residual-push engine.

A drop-in :class:`~repro_torch.core.engine.PsiEngine`: global tol-driven
solves terminate on the residual form of Eq. 19 (``scale·‖r‖₁/(1 − α) ≤
tol`` implies ``scale·‖Δs‖₁ ≤ tol`` for every further sweep, and bounds the
*distance to the fixed point* rather than one step's movement — strictly
stronger), while :meth:`PushEngine.run_top_k` stops as soon as the residual
confidence intervals separate rank k from k+1
(:mod:`repro_torch.localpush.topk`).

What makes it local:

* **Warm identity handle** — ``run(s0=...)`` with the exact ``s`` object
  the engine last returned (what ``PsiService`` passes) resumes the
  maintained float64 ``(x, r, p)`` state: zero reseed cost. A foreign
  ``s0`` pays one honest host mat-vec
  (:func:`repro_torch.localpush.push.reseed_state`).
* **O(Δ) patch hooks** — ``patch_activity`` / ``patch_edges`` /
  ``unpatch_edges`` route through :mod:`repro_torch.localpush.warm`,
  repairing ``(r, p)`` on the affected subgraph only, so a resolve after a
  flash crowd pushes only where residual was actually created.
* **Honest accounting** — ``matvecs`` reports push edge-work in mat-vec
  equivalents (``⌈edge_work / M⌉`` + reseed/verification sweeps + the
  epilogue slot), the same currency every other backend reports;
  ``last_run_stats`` carries the raw counters (rounds, pushes, edge work,
  touched fraction).

``frontier="jit"`` (the JAX package's name) runs rounds on the engine's
device — a fixed-size ``torch.topk`` frontier and a fixed-order scatter
(:func:`~repro_torch.localpush.push.make_frontier_loop`) — in the engine
dtype, then *always* re-derives ``(r, p)`` from ``x`` on the host in
float64 before emitting a gap or certificate — the verification-sweep
pattern of the async backend. The certificate is never produced from
unverified device state.

The engine takes ``device=`` like every engine of the port (default
``"cuda"``, which raises without a card): the device operators, the
returned ψ and s and the frontier live there; the push state is host
float64 on every device.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core.activity import Activity
from ..core.engine import EngineState, PsiEngine, register_backend
from ..core.power_psi import PsiResult
from ..device import numpy_dtype
from ..graphs.structure import Graph
from ..obs import convergence as obs_convergence
from ..obs import explain as obs_explain
from . import push, warm
from .topk import TopKCertificate, certify_top_k

__all__ = ["PushEngine"]


@register_backend("push")
class PushEngine(PsiEngine):
    """Gauss-Southwell forward-push backend (see module docstring).

    Args:
      frontier: ``"bucket"`` (vectorized host rounds, float64 end to end)
        or ``"jit"`` (fixed-frontier rounds on the engine's device + float64
        host verification tail).
      frontier_size: nodes pushed per device round (clipped to N).
      bucket_ratio: magnitude band of a bucket round — push every node
        with ``|r| ≥ bucket_ratio·max|r|``; 0.5 matches the scalar
        oracle's frexp buckets.
    """

    def __init__(self, *, frontier: str = "bucket", frontier_size: int = 128,
                 bucket_ratio: float = 0.5, **kw):
        super().__init__(**kw)
        if self.criterion.norm != "l1":
            raise ValueError("push backend certifies via the l1 residual "
                             f"bound; got norm={self.criterion.norm!r}")
        if self.accelerate:
            raise ValueError(
                "push backend has no Aitken composition (the residual "
                "decomposition is not a plain iterate sequence); run "
                "accelerate on a sweep backend")
        if frontier not in ("bucket", "jit"):
            raise ValueError(f"frontier must be 'bucket' or 'jit'; "
                             f"got {frontier!r}")
        if not 0.0 < bucket_ratio <= 1.0:
            raise ValueError(f"bucket_ratio must be in (0, 1]; "
                             f"got {bucket_ratio}")
        self.frontier = frontier
        self.frontier_size = int(frontier_size)
        self.bucket_ratio = float(bucket_ratio)
        self._alpha = 0.0
        self._state: push.PushState | None = None
        self._warm_handle = None
        self._fops: push.FrontierOps | None = None
        self._floop = None
        self.last_certificate: float | None = None
        self.last_psi_host: np.ndarray | None = None
        self.last_run_stats: dict = {}

    # -- lifecycle ------------------------------------------------------ #
    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        self._base_prepare(graph, activity)
        self._refresh_norms()
        self._state = None
        self._warm_handle = None
        self._fops = None
        self._floop = None
        self.last_certificate = None
        self.last_run_stats = {}
        return EngineState(s=push.cold_state(self.host))

    def _refresh_norms(self) -> None:
        self._alpha = push.a_norm(self.host)
        if self._alpha >= 1.0:
            raise ValueError(
                "push backend needs α = max_j (w_j − Σλ)/w_j < 1 (some λ "
                "mass in every non-empty feed) for a finite residual "
                f"certificate; got α = {self._alpha}")
        # per-node certificate prefactors depend on (λ, w): O(M) refresh
        # whenever either is patched
        self._pernode = push.pernode_cert_scale(self.host)
        self._beta = push.mass_weights(self.host)

    # -- gap / certificate helpers -------------------------------------- #
    def _scale_host(self) -> float:
        return self.host.b_norm if self.criterion.use_b_norm else 1.0

    def _gap_of(self, state: push.PushState) -> float:
        return self._scale_host() * push.l1(state.r) / (1.0 - self._alpha)

    def psi_error_bound(self) -> float | None:
        """Certified per-node |ψ − ψ̂| bound of the last run's returned ψ
        (None before any run or after a patch invalidated it)."""
        return self.last_certificate

    def step(self, state: EngineState) -> EngineState:
        """One bucketed frontier round with the shared gap rule."""
        st = state.s
        if not isinstance(st, push.PushState):
            raise TypeError("push engine state carries a PushState; pass "
                            "the state returned by prepare()/step()")
        push.push_round(self.host, st, bucket_ratio=self.bucket_ratio)
        return EngineState(s=st, gap=self._gap_of(st), t=state.t + 1)

    # -- solves --------------------------------------------------------- #
    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        state, reseed_mv = self._restart(s0)
        res, _ = self._drive(state, tol=tol, max_iter=max_iter, k=None,
                             reseed_mv=reseed_mv)
        return res

    def run_top_k(self, k: int, *, tol=None, max_iter=None, s0=None
                  ) -> tuple[PsiResult, TopKCertificate]:
        """Solve only far enough to certify the top-k set.

        Stops at rank separation (certificate) or at the global tolerance,
        whichever first; the returned result's ``converged`` stays honest
        (False on a certified-but-early exit — the *set* is exact, the
        scores are only err_bound-accurate).
        """
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        state, reseed_mv = self._restart(s0)
        return self._drive(state, tol=tol, max_iter=max_iter, k=int(k),
                           reseed_mv=reseed_mv)

    def _restart(self, s0) -> tuple[push.PushState, int]:
        if s0 is None:
            return push.cold_state(self.host), 0
        if self._state is not None and s0 is self._warm_handle:
            return self._state, 0          # maintained state: O(Δ) restart
        if isinstance(s0, torch.Tensor):
            s0 = s0.detach().cpu().numpy()
        return push.reseed_state(self.host, np.asarray(s0, np.float64)), 1

    def _drive(self, state: push.PushState, *, tol: float, max_iter: int,
               k: int | None, reseed_mv: int
               ) -> tuple[PsiResult, TopKCertificate | None]:
        host = self.host
        scale = self._scale_host()
        denom = 1.0 - self._alpha
        rounds = pushes = ew = cew = 0
        extra_mv = reseed_mv
        touched = np.zeros(host.n, bool)
        cert: TopKCertificate | None = None
        j_rounds, j_wall = 0, 0.0

        if self.frontier == "jit" and host.m > 0 and scale > 0:
            t0 = time.perf_counter()
            j_rounds, j_ew = self._jit_phase(state, tol * denom / scale,
                                             max_iter)
            j_wall = time.perf_counter() - t0
            rounds += j_rounds
            ew += j_ew
            if j_rounds:
                extra_mv += 1              # float64 host verification sweep

        # Certificate checks cost two support-local mat-vecs, so they run
        # on a geometric cadence: first chance, then only once ‖r‖₁ has
        # halved since the last check — O(log) checks per run, and the
        # radii shrink ∝ residual mass so nothing can be missed for long.
        next_check_mass = np.inf
        while True:
            l1r = push.l1(state.r)
            gap = scale * l1r / denom
            if gap <= tol:
                break
            if (k is not None and rounds % self.check_every == 0
                    and l1r <= next_check_mass):
                radii, cert_ew = push.neumann_error_bound(
                    host, state.r, alpha=self._alpha,
                    pernode=self._pernode, beta=self._beta)
                ew += cert_ew              # certificate work is real work
                cew += cert_ew
                cert = certify_top_k(push.psi_value(host, state), k, radii)
                if cert.certified:
                    break
                next_check_mass = 0.5 * l1r
            if rounds >= max_iter:
                break
            nodes, e = push.push_round(host, state,
                                       bucket_ratio=self.bucket_ratio)
            if nodes.size == 0:
                break                      # residual exactly zero
            touched[nodes] = True
            pushes += int(nodes.size)
            ew += e
            rounds += 1

        psi_host = push.psi_value(host, state)
        radii, cert_ew = push.neumann_error_bound(
            host, state.r, alpha=self._alpha, pernode=self._pernode,
            beta=self._beta)
        ew += cert_ew
        cew += cert_ew
        err = float(radii.max(initial=0.0))
        self.last_certificate = err if np.isfinite(err) else None
        if k is not None:
            cert = certify_top_k(psi_host, k, radii)
        np_dtype = numpy_dtype(self.dtype)
        res = self._result(
            torch.tensor(psi_host.astype(np_dtype), device=self.device),
            torch.tensor(state.x.astype(np_dtype), device=self.device),
            gap, rounds, tol)
        m = max(1, host.m)
        res = dataclasses.replace(res, matvecs=-(-ew // m) + extra_mv + 1)
        self._state = state
        self._warm_handle = res.s
        # float64 host ψ — what the certificate actually covers (the device
        # copy adds a dtype-cast error outside the bound's scope)
        self.last_psi_host = psi_host
        self.last_run_stats = dict(
            rounds=rounds, pushes=pushes, edge_work=ew, cert_edge_work=cew,
            reseed_matvecs=extra_mv, nodes_touched=int(touched.sum()),
            touched_frac=float(touched.mean()) if host.n else 0.0,
            certified=bool(cert.certified) if cert is not None else None)
        if self.frontier == "jit":
            # the device phase's share of the run (its rounds, and its wall
            # time with the upload and the f64 re-verification)
            self.last_run_stats.update(jit_rounds=j_rounds,
                                       jit_seconds=j_wall)
        obs_convergence.record_push(edge_work=ew, cert_edge_work=cew)
        if k is not None:
            # the early-stop outcome belongs in the decision trail: what a
            # certified exit saved (or failed to save) vs exhausting to tol
            certified = bool(cert.certified) if cert is not None else False
            sweeps_eq = float(-(-ew // m))     # edge-work in sweep units
            obs_explain.record_decision(
                "early_stop", "PushEngine.run_top_k",
                inputs=dict(n=host.n, m=host.m, k=int(k), tol=tol),
                chosen=("certified_early_stop" if certified
                        else "exhausted_to_tol"),
                candidates=[
                    obs_explain.Candidate(
                        "certified_early_stop", est=float(ew), unit="edges",
                        chosen=certified,
                        detail=dict(rounds=rounds,
                                    sweep_equiv=round(sweeps_eq, 2))),
                    obs_explain.Candidate(
                        "exhausted_to_tol", est=None, chosen=not certified,
                        detail=dict(gap=f"{gap:.3g}")),
                ],
                note=f"touched_frac={self.last_run_stats['touched_frac']:.3g}"
                     f" cert_edge_work={cew}")
        return res, cert

    # -- device frontier phase ------------------------------------------ #
    def frontier_ops(self) -> push.FrontierOps:
        """The device frontier table and its round loop, built on first use
        and dropped by every patch (its 1/w, μ and leader lists move)."""
        if self._fops is None:
            self._fops = push.build_frontier_ops(
                self.host, dtype=self.dtype, device=self.device)
            self._floop = push.make_frontier_loop(
                self._fops,
                frontier_size=min(self.frontier_size, max(1, self.host.n)))
        return self._fops

    def _jit_phase(self, state: push.PushState, tol_r: float,
                   max_rounds: int) -> tuple[int, int]:
        """Run device rounds toward ``tol_r`` (floored at the device dtype's
        resolution), then restore the float64 invariant from x."""
        np_dtype = numpy_dtype(self.dtype)
        eps = float(np.finfo(np_dtype).eps)
        floor = 64.0 * eps * (push.l1(state.x) + push.l1(state.r))
        target = max(tol_r, floor)
        if push.l1(state.r) <= target:
            return 0, 0
        self.frontier_ops()

        def dev(v):
            return torch.tensor(v.astype(np_dtype), device=self.device)

        x, _, _, t, ew = self._floop(dev(state.x), dev(state.r),
                                     dev(state.p), target, max_rounds)
        verified = push.reseed_state(
            self.host, x.cpu().numpy().astype(np.float64))
        state.x[:] = verified.x
        state.r[:] = verified.r
        state.p[:] = verified.p
        return t, ew

    # -- O(Δ) delta hooks ----------------------------------------------- #
    def patch_activity(self, users, lam=None, mu=None) -> bool:
        if self._state is None:
            self.host.patch_activity(users, lam=lam, mu=mu)
        else:
            warm.apply_activity_patch(self.host, self._state, users,
                                      lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        self._refresh_norms()
        # the frontier's 1/w and μ moved: rebuild it on the next device
        # phase (the JAX engine keeps the old vectors, which only steers its
        # rounds toward the old fixed point until the f64 verification)
        self._fops = None
        self._floop = None
        self.last_certificate = None       # served ψ no longer covered
        return True

    def patch_edges(self, src, dst) -> bool:
        if self._state is None:
            self.host.patch_edges(src, dst)
        else:
            warm.apply_edge_insert(self.host, self._state, src, dst)
        self._after_edge_mutation()
        return True

    def unpatch_edges(self, src, dst) -> bool:
        if self._state is None:
            removed, _ = self.host.remove_edges(src, dst)
        else:
            removed, _ = warm.apply_edge_remove(self.host, self._state,
                                                src, dst)
        if removed.size:
            self._after_edge_mutation()
        return True

    def _after_edge_mutation(self) -> None:
        self._graph_stale = True
        self.ops = self.host.to_device(self.dtype, self.device)
        self._refresh_norms()
        self._fops = None                  # padded leader table grew/shrank
        self._floop = None
        self.last_certificate = None
