"""Power-ψ solver abstraction: one protocol, two backends.

``PsiEngine`` is the contract every backend meets:

    prepare(graph, activity) -> EngineState     # build operators, s₀ = c
    step(state) -> EngineState                  # one Alg. 2 iteration
    run(tol=..., max_iter=..., s0=...) -> PsiResult
    epilogue(s) -> psi                          # ψᵀ = (sᵀB + dᵀ)/N

Backends are registered by name and constructed through :func:`make_engine`:

  * ``reference`` — the edge-form segmented-sum iteration of
    :mod:`repro_torch.core.power_psi` (any device, float64-capable).
  * ``cuda`` (alias ``pallas``) — the hand-written CUDA kernels in one of
    two execution regimes: the fused edge-tile ``power_step`` kernel
    (hyper-sparse graphs) or the fused dense-tile ``bsr_step`` kernel
    (clustered graphs); pick with ``regime=`` or hand over a
    :class:`~repro_torch.kernels.autotune.RegimePlan`. On ``device="cpu"``
    the same engine runs each kernel's plain PyTorch version.
  * ``auto`` — a ``cuda`` engine whose regime and tile parameters are
    chosen per graph by the :mod:`repro_torch.kernels.autotune` planner
    (cost model, optional one-shot micro-benchmark, plan cache,
    calibration store).
  * ``accelerated`` — the ``reference`` iteration wrapped in the Aitken
    extrapolation loop (:func:`_accelerated_loop`); any other backend opts
    in with ``accelerate=True``.
  * ``push`` — the local residual-push solver with a certified error
    bound (:class:`repro_torch.localpush.PushEngine`, registered on first
    use of the registry).

All share one :class:`ConvergenceCriterion` — ε on ‖B‖·‖Δs‖ per Eq. 19 —
and report interchangeable :class:`~repro_torch.core.power_psi.PsiResult`
values (``s`` always in node order, so one backend's result warm-starts
another). Engines expose the O(Δ) delta hooks (``patch_activity`` /
``patch_edges``) the serving layer is built on; a hook returns ``False``
when the backend cannot patch incrementally and the caller re-``prepare``s.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when no
CUDA device is present unless ``device="cpu"`` is passed.

PyTorch has no ``lax.while_loop``: the loop runs ``check_every`` steps on
the device, then reads the gap on the host. ``iterations`` lands on a
multiple of ``check_every``, never stops above the tolerance, and
``matvecs = iterations + 1`` — the JAX package's semantics. The accelerated
loop reads the gap once per body of two mat-vecs and counts mat-vecs in
``iterations``.
"""
from __future__ import annotations

import abc
import dataclasses
import inspect
import time
from typing import Any

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from ..kernels.formats import build_bsr, build_edge_tiles
from ..kernels.ops import (DeviceBsr, DeviceEdgeTiles, _i32, bsr_step,
                           power_step, power_step_lanes)
from ..obs import calibrate as obs_calibrate
from .activity import Activity
from .operators import HostOperators, PsiOperators
from .power_psi import _NORMS, PsiResult

__all__ = ["ConvergenceCriterion", "EngineState", "PsiEngine",
           "ReferenceEngine", "AcceleratedEngine", "CudaEngine", "AutoEngine",
           "make_engine", "register_backend", "available_backends",
           "make_reference_step", "make_batched_loop",
           "make_lane_reference_step", "make_dense_step",
           "make_edge_tile_step"]


# --------------------------------------------------------------------- #
# Shared convergence contract
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ConvergenceCriterion:
    """Alg. 2 termination rule, identical across backends.

    Stop when ``scale · ‖s_t − s_{t−1}‖_norm ≤ tol`` with ``scale = ‖B‖``
    when ``use_b_norm`` (Eq. 19: the ψ trajectory then moved ≤ tol/N), else
    1. ``matvecs`` accounting is shared too: one sparse mat-vec per
    iteration plus one for the ψ epilogue.
    """

    tol: float = 1e-9
    max_iter: int = 10_000
    norm: str = "l1"
    use_b_norm: bool = True

    def __post_init__(self):
        if self.norm not in _NORMS:
            raise ValueError(f"unknown norm {self.norm!r}; "
                             f"choose from {sorted(_NORMS)}")

    def resolve(self, tol: float | None,
                max_iter: int | None) -> tuple[float, int]:
        return (self.tol if tol is None else float(tol),
                self.max_iter if max_iter is None else int(max_iter))


@dataclasses.dataclass
class EngineState:
    """Backend-agnostic iteration state. ``s`` lives in the backend's native
    layout (node order, or the padded ``[1, n_pad]`` edge-tile layout)."""

    s: Any
    gap: float = float("inf")
    t: int = 0


# --------------------------------------------------------------------- #
# Protocol + registry
# --------------------------------------------------------------------- #
class PsiEngine(abc.ABC):
    """One (graph, activity) pair's solver; see module docstring.

    A backend sets ``one_step(args, s) -> (s_new, raw_gap)``, its pure
    Alg. 2 step over ``_step_args()``; :meth:`_loop` and :meth:`step`
    drive it.

    Loop-shaping options shared by every backend:

    * ``accelerate`` — wrap the backend's step in the Aitken extrapolation
      loop (:func:`_accelerated_loop`).
    * ``extrapolate_every`` — target plain iterations between jump attempts.
    * ``check_every=k`` evaluates the convergence gap every k-th iteration:
      the k−1 steps between checks run back to back on the device with no
      host read, and ``iterations`` lands on a multiple of k (overshoot < k,
      never undershoot). Ignored by the accelerated loop, whose pairing of
      a jump with its verify step fixes the cadence at 2.
    """

    name: str = "abstract"

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda",
                 criterion: ConvergenceCriterion | None = None,
                 accelerate: bool = False, extrapolate_every: int = 8,
                 check_every: int = 1):
        numpy_dtype(dtype)                       # rejects non-float dtypes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.criterion = criterion or ConvergenceCriterion()
        self.accelerate = bool(accelerate)
        self.extrapolate_every = int(extrapolate_every)
        self.check_every = max(1, int(check_every))
        self._graph: Graph | None = None
        self._graph_stale = False
        self.host: HostOperators | None = None
        self.ops: PsiOperators | None = None

    @property
    def graph(self) -> Graph | None:
        if self._graph_stale:                # edges patched since last look
            self._graph = self.host.graph()
            self._graph_stale = False
        return self._graph

    # -- lifecycle ------------------------------------------------------ #
    @abc.abstractmethod
    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        """Build device operators; returns the cold-start state (s₀ = c)."""

    @abc.abstractmethod
    def run(self, *, tol: float | None = None, max_iter: int | None = None,
            s0: np.ndarray | torch.Tensor | None = None) -> PsiResult:
        """Iterate to the criterion; ``s0`` (node order) warm-starts."""

    def epilogue(self, s) -> torch.Tensor:
        """ψᵀ = (sᵀB + dᵀ)/N from a node-order series vector."""
        return self.ops.psi_epilogue(self._as_node_vector(s))

    # -- delta rebuild hooks (serving runtime) -------------------------- #
    def patch_activity(self, users, lam=None, mu=None) -> bool:
        """O(Δ) activity patch; False → caller must re-``prepare``."""
        return False

    def patch_edges(self, src, dst) -> bool:
        """O(Δ) edge insertion; False → caller must re-``prepare``."""
        return False

    def unpatch_edges(self, src, dst) -> bool:
        """Edge *removal* (unfollow tombstones); False → caller must
        re-``prepare`` from a filtered graph."""
        return False

    def psi_error_bound(self) -> float | None:
        """Certified per-node ``|ψ_exact − ψ_served|`` bound for the last
        ``run``'s returned ψ, or None when the backend cannot certify one
        (the Eq. 19 gap bounds one step's *movement*, not the distance to
        the fixed point). The ``push`` backend overrides this with its
        residual certificate; ``RankingCache`` consumes it."""
        return None

    # -- shared helpers ------------------------------------------------- #
    @property
    def activity(self) -> Activity:
        return self.host.activity()

    def _base_prepare(self, graph: Graph, activity: Activity) -> None:
        self._graph = graph
        self._graph_stale = False
        self.host = HostOperators.from_graph(graph, activity)
        self.ops = self.host.to_device(self.dtype, self.device)

    def _scale(self) -> torch.Tensor:
        return (self.ops.b_norm if self.criterion.use_b_norm
                else torch.ones((), dtype=self.dtype, device=self.device))

    def _step_args(self):
        """What the engine's ``one_step(args, s)`` closure consumes."""
        return self.ops

    def step(self, state: EngineState) -> EngineState:
        """One Alg. 2 iteration ``s ← sᵀA + c`` with the shared gap rule."""
        s_new, raw = self.one_step(self._step_args(), state.s)
        return EngineState(s=s_new, gap=float(self._scale() * raw),
                           t=state.t + 1)

    def _loop(self, s: torch.Tensor, tol: float,
              max_iter: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Iterate from native-layout ``s`` until ``gap ≤ tol`` (compared in
        the working dtype) or ``t ≥ max_iter``; returns (s, gap, t) with the
        gap on the host. With ``accelerate`` the Aitken loop runs instead."""
        args, scale, k = self._step_args(), self._scale(), self.check_every
        if self.accelerate:
            return _accelerated_loop(
                self.one_step, args, s, scale, tol, max_iter,
                extrapolate_every=self.extrapolate_every)
        tol_t = torch.tensor(tol, dtype=self.dtype)
        gap = torch.tensor(float("inf"), dtype=self.dtype)
        t = 0
        while bool(gap > tol_t) and t < max_iter:
            for _ in range(k - 1):
                s, _ = self.one_step(args, s)
            s, raw = self.one_step(args, s)
            gap = (scale * raw).cpu()
            t += k
        return s, gap, t

    def _as_node_vector(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _s0_node_order(self, s0) -> torch.Tensor:
        if s0 is None:
            return self.ops.c
        s0 = self._as_node_vector(s0)
        if s0.shape != (self.ops.n,):
            raise ValueError(f"s0 must be f[{self.ops.n}] in node order; "
                             f"got {tuple(s0.shape)}")
        return s0

    def _result(self, psi, s, gap, t, tol) -> PsiResult:
        return PsiResult(psi=psi, s=s, iterations=int(t), gap=float(gap),
                         converged=float(gap) <= tol, matvecs=int(t) + 1)


_REGISTRY: dict[str, type[PsiEngine]] = {}
_ALIASES = {"pallas": "cuda"}       # the JAX package's kernel backend name


def register_backend(name: str):
    """Class decorator: make the engine constructible by ``make_engine(name)``."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def _ensure_plugin_backends() -> None:
    """Import out-of-package backends that self-register on import.

    ``repro_torch.localpush`` imports this module, so a bottom-of-file
    import here would deadlock whenever ``repro_torch.localpush`` is the
    entry point (its partially-initialized module would be re-entered
    before ``PushEngine`` exists). Deferring to first registry *use* keeps
    both import orders cycle-free."""
    from .. import localpush  # noqa: F401  (registers backend="push")


def available_backends() -> tuple[str, ...]:
    _ensure_plugin_backends()
    return tuple(sorted(_REGISTRY))


def _accepted_options(cls: type[PsiEngine]) -> set[str]:
    """Every named keyword the backend's ``__init__`` chain accepts."""
    names: set[str] = set()
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        for p in inspect.signature(init).parameters.values():
            if p.name != "self" and p.kind in (p.KEYWORD_ONLY,
                                               p.POSITIONAL_OR_KEYWORD):
                names.add(p.name)
    return names


def make_engine(backend: str = "reference", *, graph: Graph | None = None,
                activity: Activity | None = None, **opts) -> PsiEngine:
    """Factory: construct (and, when given a graph, prepare) a backend."""
    _ensure_plugin_backends()
    try:
        cls = _REGISTRY[_ALIASES.get(backend, backend)]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {available_backends()}") from None
    unknown = set(opts) - _accepted_options(cls)
    if unknown:
        raise ValueError(
            f"unknown engine option(s) {sorted(unknown)} for backend "
            f"{backend!r} (accepts: {sorted(_accepted_options(cls))}); "
            f"available backends: {available_backends()}")
    engine = cls(**opts)
    if graph is not None:
        if activity is None:
            raise ValueError("graph given without activity")
        engine.prepare(graph, activity)
    return engine


def make_reference_step(norm: str = "l1"):
    """The pure Alg. 2 step ``(PsiOperators, s) -> (s_new, raw_gap)``."""
    nrm = _NORMS[norm]

    def one_step(ops, s):
        s_new = ops.mu * ops.push(s) + ops.c
        return s_new, nrm(s_new - s)

    return one_step


# --------------------------------------------------------------------- #
# Lane-batched steps and the fleet's masked loop. PyTorch has no vmap over
# a kernel launch, so each step below takes every lane at once: ``s`` and
# every tensor of ``args`` carry a leading lane axis, and ``raw_gap`` is
# one norm a lane.
# --------------------------------------------------------------------- #
_LANE_NORMS = {
    "l1": lambda x: torch.sum(torch.abs(x), dim=-1),
    "l2": lambda x: torch.sqrt(torch.sum(x * x, dim=-1)),
    "linf": lambda x: torch.amax(torch.abs(x), dim=-1),
}


def make_batched_loop(step_with_gap, *, check_every: int = 1):
    """The convergence-masked fleet loop over independent lanes.

    ``step_with_gap(args, s) -> (s_new, raw_gap)`` is a lane-batched step
    (:func:`make_lane_reference_step`, :func:`make_dense_step`,
    :func:`make_edge_tile_step`): ``s`` is ``[L, ...]`` and ``raw_gap``
    ``[L]``. Returns

        loop(args, s0, scale, tol, max_iter, active0) -> (s, gap, t)

    with per-lane ``scale`` / ``gap`` / ``t`` (``tol`` in the working
    dtype, ``active0`` a bool ``[L]``). Each lane runs the solo termination
    rule on its own: a lane whose gap reaches ``tol`` (or whose ``t``
    reaches ``max_iter``) *freezes* — ``torch.where`` keeps its series
    vector bitwise while the other lanes keep stepping (a frozen lane is
    still computed and its result dropped, as under ``jax.vmap``) — and the
    loop ends when no lane is active, which the host reads once a body.
    ``active0`` masks lanes out from the start, so a clean tenant sharing a
    bucket with a dirty one never moves. ``t`` advances by
    ``check_every = k`` a body for every active lane, as in the solo loop.
    The JAX package's ``make_batched_loop`` semantics, body for body.
    """
    k = max(1, int(check_every))

    def loop(args, s0, scale, tol, max_iter, active0):
        lane_shape = (s0.shape[0],) + (1,) * (s0.dim() - 1)
        dev = s0.device
        s = s0
        gap = torch.full((s0.shape[0],), float("inf"), dtype=s0.dtype,
                         device=dev)
        t = torch.zeros(s0.shape[0], dtype=torch.int32, device=dev)
        active = torch.as_tensor(active0, dtype=torch.bool, device=dev)
        tol = torch.as_tensor(tol, dtype=s0.dtype, device=dev)
        while bool(active.any()):
            s_k = s
            for _ in range(k - 1):
                s_k, _ = step_with_gap(args, s_k)
            s_new, raw = step_with_gap(args, s_k)
            gap_new = scale * raw
            s = torch.where(active.reshape(lane_shape), s_new, s)
            gap = torch.where(active, gap_new, gap)
            t = torch.where(active, t + k, t)
            active = active & (gap_new > tol) & (t < max_iter)
        return s, gap, t

    return loop


def make_lane_reference_step(norm: str = "l1"):
    """The fleet's ``reference`` step over a
    :class:`~repro_torch.core.operators.LaneOperators`: every lane's
    ``s_new = μ ⊙ push(s) + c`` through one fixed-order segment sum, and
    each lane's gap norm. Pad lanes and pad nodes (zero rates) stay at 0;
    sentinel slots fall into each lane's dropped segment."""
    nrm = _LANE_NORMS[norm]

    def one_step(ops, s):
        s_new = ops.mu * ops.push(s) + ops.c
        return s_new, nrm(s_new - s)

    return one_step


class _NoTF32:
    """Float32 products in full float32 on the card for the duration (the
    dense regime's product is a reference-grade mat-vec, not a TF32 one)."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev
        return False


def dense_push(x: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """``x[L, n] @ E[L, n, n]`` per lane, one batched product (TF32 off)."""
    with _NoTF32():
        return torch.bmm(x.unsqueeze(1), E).squeeze(1)


def make_dense_step(norm: str = "l1"):
    """The fleet's dense step over ``(E, 1/w, μ, c)`` args, each ``[L, ...]``.

    ``E`` is each lane's {0,1} follower→leader adjacency (``E[ℓ, j, i] = 1``
    iff j follows i), so one batched product ``[L, 1, n] @ [L, n, n]``
    computes every lane's push ``t = (s ⊙ 1/w) E`` and the step is
    ``μ ⊙ t + c``: the edge form's arithmetic as one matrix product
    (``torch.bmm``, as the JAX package leaves it to XLA), the fleet's regime
    for buckets of *small* tenants. O(n²) memory a lane.
    """
    nrm = _LANE_NORMS[norm]

    def one_step(args, s):
        E, inv_w, mu, c = args
        s_new = mu * dense_push(s * inv_w, E) + c
        return s_new, nrm(s_new - s)

    return one_step


def make_edge_tile_step():
    """The fleet's kernel step over ``(fmt, 1/w, μ, c)`` args: a
    lane-stacked :class:`~repro_torch.kernels.ops.DeviceEdgeTiles` and
    ``[L, 1, n_gather]`` / ``[L, 1, n_pad]`` vectors. One
    ``power_step_lanes`` launch steps every lane (the JAX package's pallas
    call under ``jax.vmap``, whose batch axis becomes a grid dimension) and
    returns each lane's gap."""

    def one_step(args, s):
        fmt, inv_w_g, mu_pad, c_pad = args
        return power_step_lanes(s, inv_w_g, mu_pad, c_pad, fmt)

    return one_step


def _accelerated_loop(step_with_gap, args, s0: torch.Tensor,
                      scale: torch.Tensor, tol: float, max_iter: int, *,
                      extrapolate_every: int = 8):
    """Aitken / geometric-series extrapolation around *any* backend step.

    ``step_with_gap(args, s) -> (s_new, raw_gap)`` is a backend's
    ``one_step``. Each loop body consumes exactly two mat-vecs and advances
    either two plain iterations or one extrapolated jump plus its
    verification step:

        s₁ = step(s);  Δ = s₁ − s;  r = ‖Δ_t‖/‖Δ_{t−1}‖
        s_x = s₁ + Δ · r/(1−r)      every ``extrapolate_every // 2`` bodies,
                                    while contracting (0 < r < 0.999) and
                                    far from tolerance (gap > 100·tol)
        s₂ = step(s_x)              # verification (or second plain step)

    The termination gap is *always* ``scale·‖s₂ − s_x‖`` — measured across
    a genuine plain iteration — so the Eq. 19 guarantee survives every
    jump. A jump that fails to shrink the gap is reverted and disables all
    future jumps (plain Power-ψ at one wasted mat-vec); a stalled ratio
    (r ≈ 1, a floating-point period-2 cycle) triggers a Krasnoselskii
    averaging kick, which is always safe for a contraction.

    The jump decisions are tensors on the device (``torch.where``); the
    host reads the gap once a body, as :meth:`PsiEngine._loop` reads it
    every ``check_every`` steps. Returns ``(s, gap on the host, t)`` with
    ``t`` the mat-vecs consumed. The semantics are those of the JAX
    package's ``_make_accelerated_loop``. Near a dtype's fixed-point floor
    a jump can land in a basin whose plain f32 iteration limit-cycles;
    request tolerances ≥ ~100·ulp for f32, or run float64.
    """
    kb = max(1, int(extrapolate_every) // 2)   # loop bodies between attempts
    dtype, dev = s0.dtype, s0.device
    tol_d = torch.tensor(tol, dtype=dtype, device=dev)
    tol_h = torch.tensor(tol, dtype=dtype)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    prev_dn = torch.full((), float("inf"), dtype=dtype, device=dev)
    enabled = torch.ones((), dtype=torch.bool, device=dev)
    gap = torch.tensor(float("inf"), dtype=dtype)
    s, t, j = s0, 0, 0
    while bool(gap > tol_h) and t < max_iter:
        s1, raw1 = step_with_gap(args, s)
        gap_plain = scale * raw1
        r = raw1 / torch.clamp(prev_dn, min=1e-30)
        do_jump = ((r > 0.0) & (r < 0.999) & (gap_plain > 100.0 * tol_d)
                   & enabled) if j % kb == kb - 1 else no
        jump = torch.where(do_jump, r / (1.0 - r), torch.zeros_like(r))
        s_x = s1 + (s1 - s) * jump            # == s₁ when not jumping
        s2, raw2 = step_with_gap(args, s_x)
        gap_ver = scale * raw2
        bad = do_jump & (gap_ver >= gap_plain)
        enabled = enabled & ~bad
        s_next = torch.where(bad, s1, s2)
        gap_d = torch.where(bad, gap_plain, gap_ver)
        prev_dn = torch.where(bad, raw1, raw2)
        stall = ~do_jump & (r > 0.999) & torch.isfinite(r)
        s = torch.where(stall, 0.5 * (s_x + s2), s_next)
        t, j = t + 2, j + 1
        gap = gap_d.cpu()
    return s, gap, t


# --------------------------------------------------------------------- #
# reference — edge-form segmented-sum iteration (power_psi semantics)
# --------------------------------------------------------------------- #
@register_backend("reference")
class ReferenceEngine(PsiEngine):
    """The paper-faithful Alg. 2 loop on :class:`PsiOperators`."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.one_step = make_reference_step(self.criterion.norm)

    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        self._base_prepare(graph, activity)
        return EngineState(s=self.ops.c)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        s, gap, t = self._loop(self._s0_node_order(s0), tol, max_iter)
        return self._result(self.ops.psi_epilogue(s), s, gap, t, tol)

    def patch_activity(self, users, lam=None, mu=None) -> bool:
        self.host.patch_activity(users, lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        return True

    def patch_edges(self, src, dst) -> bool:
        self.host.patch_edges(src, dst)
        self._graph_stale = True
        self.ops = self.host.to_device(self.dtype, self.device)
        return True

    def unpatch_edges(self, src, dst) -> bool:
        removed, _ = self.host.remove_edges(src, dst)
        if removed.size:
            self._graph_stale = True
            self.ops = self.host.to_device(self.dtype, self.device)
        return True


@register_backend("accelerated")
class AcceleratedEngine(ReferenceEngine):
    """Aitken-extrapolated ``reference`` iteration: the engine-level loop
    composition every backend can opt into (``make_engine("cuda",
    accelerate=True)``, …). ``iterations`` / ``matvecs`` count mat-vecs
    actually consumed — the currency an extrapolated loop is judged in.
    """

    def __init__(self, **kw):
        kw["accelerate"] = True
        super().__init__(**kw)


# --------------------------------------------------------------------- #
# cuda — hand-written kernels in two execution regimes
# --------------------------------------------------------------------- #
@register_backend("cuda")
class CudaEngine(PsiEngine):
    """Alg. 2 driven by the CUDA kernels of :mod:`repro_torch.kernels`.

    * ``edge_tile`` — the fused ``power_step`` kernel: dst-sorted edge
      blocks scatter into node tiles and the gap is summed in the kernel.
      Native state layout is the padded ``[1, n_pad]`` node vector.
    * ``bsr``       — the fused ``bsr_step`` dense-tile kernel (the
      ``bsr_spmv`` push with the μ/c epilogue and the L1 gap in the same
      launch). Native layout is the node-order ``f[n]`` vector.

    Both regimes compute the gap in ``l1`` (the paper's choice), so the
    criterion's norm must be ``l1``. Activity patches refresh only node
    vectors; edge patches go into free sentinel slots (edge-tile, via an
    O(Δ) per-tile free-slot cursor) or existing dense tiles (BSR), written
    into the device tensors in place, and fall back to a rebuild of the
    regime's format — never of the operators — when a tile overflows, a
    new BSR block appears or a one-byte BSR cell would pass 255.
    ``format_builds`` counts the format builds.
    """

    def __init__(self, *, regime: str = "edge_tile", tile: int = 256,
                 e1: int = 8, e2: int = 128, ts: int = 128, td: int = 128,
                 plan=None, **kw):
        super().__init__(**kw)
        if self.criterion.norm != "l1":
            raise ValueError("cuda backend computes the gap in l1; "
                             f"got norm={self.criterion.norm!r}")
        self.tile, self.e1, self.e2 = tile, e1, e2
        self.ts, self.td = ts, td
        self.format_builds = 0
        if plan is not None:
            self._apply_plan(plan)
        else:
            self._set_regime(regime)

    # -- regime plumbing ------------------------------------------------ #
    def _apply_plan(self, plan) -> None:
        """Adopt a :class:`~repro_torch.kernels.autotune.RegimePlan`."""
        if plan.regime == "edge_tile":
            self.tile, self.e1, self.e2 = plan.tile, plan.e1, plan.e2
        else:
            self.ts, self.td = plan.ts, plan.td
        self._set_regime(plan.regime)

    def _set_regime(self, regime: str) -> None:
        if regime == "edge_tile":
            def one_step(args, s):
                fmt, inv_w_g, mu_pad, c_pad = args
                return power_step(s, inv_w_g, mu_pad, c_pad, fmt)
        elif regime == "bsr":
            def one_step(args, s):
                fmt, inv_w, mu, c = args
                return bsr_step(s, inv_w, mu, c, fmt)
        else:
            raise ValueError(f"unknown cuda regime {regime!r}; "
                             "choose edge_tile or bsr")
        self.regime = regime
        self.one_step = one_step

    def _build_format(self, graph: Graph) -> None:
        if self.regime == "edge_tile":
            self.fmt_host = build_edge_tiles(graph, tile=self.tile,
                                             e1=self.e1, e2=self.e2)
            self.fmt = DeviceEdgeTiles.from_format(self.fmt_host, self.device)
            self._rebuild_tile_cursor()
            self._refresh_padded()
        else:
            self.fmt_host = build_bsr(graph, ts=self.ts, td=self.td,
                                      dtype=numpy_dtype(self.dtype))
            self.fmt = DeviceBsr.from_format(self.fmt_host, self.device)
            self._rebuild_bsr_block_map()
        self.format_builds += 1

    def _to_native(self, v: torch.Tensor) -> torch.Tensor:
        return (self.fmt.pad_node_vector(v) if self.regime == "edge_tile"
                else v)

    def _from_native(self, s: torch.Tensor) -> torch.Tensor:
        return s[0, :self.fmt.n] if self.regime == "edge_tile" else s

    # -- lifecycle ------------------------------------------------------ #
    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        self._base_prepare(graph, activity)
        self._build_format(graph)
        return EngineState(s=self._to_native(self.ops.c))

    def _refresh_padded(self) -> None:
        f = self.fmt
        self._mu_pad = f.pad_node_vector(self.ops.mu)
        self._c_pad = f.pad_node_vector(self.ops.c)
        self._inv_w_gather = f.pad_gather_source(self.ops.inv_w)

    def _step_args(self):
        if self.regime == "edge_tile":
            return (self.fmt, self._inv_w_gather, self._mu_pad, self._c_pad)
        return (self.fmt, self.ops.inv_w, self.ops.mu, self.ops.c)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        s_init = self._to_native(self._s0_node_order(s0))
        s, gap, t = self._loop(s_init, tol, max_iter)
        s_n = self._from_native(s)
        return self._result(self.ops.psi_epilogue(s_n), s_n, gap, t, tol)

    # -- delta rebuilds ------------------------------------------------- #
    def patch_activity(self, users, lam=None, mu=None) -> bool:
        self.host.patch_activity(users, lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        if self.regime == "edge_tile":
            self._refresh_padded()
        return True

    def patch_edges(self, src, dst) -> bool:
        src, dst = self.host.patch_edges(src, dst)
        self._graph_stale = True
        if self.regime == "edge_tile":
            self._patch_edges_edge_tile(src, dst)
        else:
            self._patch_edges_bsr(src, dst)
        self.ops = self.host.to_device(self.dtype, self.device)
        if self.regime == "edge_tile":
            self._refresh_padded()
        return True

    # -- edge-tile regime: O(Δ) sentinel-slot inserts -------------------- #
    def _rebuild_tile_cursor(self) -> None:
        """Per-tile free-slot cursor, computed once per format build.

        ``build_edge_tiles`` fills each node tile's block span contiguously
        from its first slot, and cursor inserts preserve that invariant —
        so a tile's free sentinel slots are exactly the tail of its span
        and placing an edge is O(1): no per-edge scan over blocks/slots.
        """
        f = self.fmt_host
        used_per_block = (f.src_idx.reshape(f.num_blocks, -1)
                          != f.n).sum(axis=1)
        self._tile_first_block = f.tile_first_block.astype(np.int64)
        blocks_per_tile = f.tile_num_blocks.astype(np.int64)
        self._tile_capacity = blocks_per_tile * f.eblk
        self._tile_used = np.bincount(
            f.block_tile, weights=used_per_block,
            minlength=f.num_tiles).astype(np.int64)

    def _insert_into_tiles(self, src: np.ndarray, dst: np.ndarray):
        """Place new edges into free (sentinel) slots of their dst tile.

        O(Δ) total via the per-tile cursor. Mutates the host format in
        place and returns the placed ``(block, flat_slot, src_id,
        dst_local)`` tuples, or ``None`` when any tile would overflow (the
        caller rebuilds the format; nothing is mutated in that case)."""
        f = self.fmt_host
        tile, eblk = f.tile, f.eblk
        tiles_of = np.asarray(dst, np.int64) // tile
        need = np.bincount(tiles_of, minlength=f.num_tiles)
        if np.any(self._tile_used + need > self._tile_capacity):
            return None
        flat_src = f.src_idx.reshape(f.num_blocks, -1)
        flat_dstl = f.dst_local.reshape(f.num_blocks, -1)
        placed = []
        for s, d, t in zip(src, dst, tiles_of):
            t = int(t)
            u = int(self._tile_used[t])
            b = int(self._tile_first_block[t]) + u // eblk
            slot = u % eblk
            d_loc = int(d) - t * tile
            flat_src[b, slot] = s
            flat_dstl[b, slot] = d_loc
            placed.append((b, slot, int(s), d_loc))
            self._tile_used[t] = u + 1
        return placed

    def _patch_edges_edge_tile(self, src: np.ndarray,
                               dst: np.ndarray) -> None:
        slots = self._insert_into_tiles(src, dst)
        if slots is None:
            # a tile ran out of sentinel slots — rebuild the edge-tile
            # format only (the operator arrays stay incrementally patched)
            self._build_format(self.graph)
        elif slots:
            # write the new slots into the device format in place instead
            # of re-uploading all M edges
            b, slot, s_id, d_loc = (np.asarray(x) for x in zip(*slots))
            i, j = np.divmod(slot, self.e2)
            idx = tuple(torch.as_tensor(x, dtype=torch.int64,
                                        device=self.device)
                        for x in (b, i, j))
            self.fmt.src_idx.index_put_(idx, _i32(s_id, self.device))
            self.fmt.dst_local.index_put_(idx, _i32(d_loc, self.device))

    # -- BSR regime: dense-tile increments ------------------------------ #
    def _rebuild_bsr_block_map(self) -> None:
        f = self.fmt_host
        self._bsr_blocks = {
            (int(st), int(dt)): b
            for b, (st, dt) in enumerate(zip(f.src_tile, f.dst_tile))}

    def _patch_edges_bsr(self, src: np.ndarray, dst: np.ndarray) -> None:
        if src.size == 0:
            return
        f = self.fmt_host
        st = np.asarray(src, np.int64) // f.ts
        dt = np.asarray(dst, np.int64) // f.td
        if any((int(a), int(b)) not in self._bsr_blocks
               for a, b in zip(st, dt)):
            # a brand-new (src_tile, dst_tile) block — rebuild the BSR
            # format, never the operators
            self._build_format(self.graph)
            return
        b = np.asarray([self._bsr_blocks[(int(a), int(c))]
                        for a, c in zip(st, dt)])
        r = np.asarray(src, np.int64) % f.ts
        c = np.asarray(dst, np.int64) % f.td
        np.add.at(f.tiles, (b, r, c), 1.0)
        cells = f.tiles[b, r, c]
        if self.fmt.tiles.dtype == torch.uint8 and cells.max() > 255:
            # a one-byte cell would pass 255 (the host drops duplicate edges,
            # so only a count patched in past it gets here): upload the
            # patched host format again, which then keeps the working dtype
            self.fmt = DeviceBsr.from_format(f, self.device)
            self.format_builds += 1
            return
        # the touched cells' new counts, copied from the host format: exact
        # in either storage
        idx = tuple(torch.as_tensor(x, dtype=torch.int64, device=self.device)
                    for x in (b, r, c))
        self.fmt.tiles.index_put_(idx, torch.as_tensor(cells).to(
            device=self.device, dtype=self.fmt.tiles.dtype))


# --------------------------------------------------------------------- #
# auto — the cuda engine with its regime chosen per graph
# --------------------------------------------------------------------- #
@register_backend("auto")
class AutoEngine(CudaEngine):
    """``cuda`` with the regime chosen per graph by the autotuner.

    ``prepare`` asks :func:`repro_torch.kernels.autotune.plan_regime` for
    the cheapest execution plan at the engine's dtype on its device (cost
    model by default; ``microbench=True`` times one push launch of every
    candidate). Plans are memoized in the process-level
    :data:`~repro_torch.kernels.autotune.PLAN_CACHE` (or ``plan_cache=``)
    keyed by graph *structure*, so ``patch_activity`` / warm re-``prepare``
    cycles never re-plan, and the regime is re-installed only when the plan
    changes.

    Every ``run`` of more than 3 iterations feeds the resolve's wall time
    per iteration to the :mod:`repro_torch.obs.calibrate` store as a
    (modeled bytes, measured µs) sample for the plan's regime, under the key
    of the engine's device and dtype (``calibrate=False`` opts out).
    """

    def __init__(self, *, microbench: bool = False, plan_cache=None,
                 calibrate: bool = True, **kw):
        kw.pop("regime", None)          # the planner owns the regime
        self.microbench = bool(microbench)
        self.calibrate = bool(calibrate)
        self._plan_cache = plan_cache
        self.plan = None
        super().__init__(**kw)

    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        from ..kernels import autotune
        cache = (autotune.PLAN_CACHE if self._plan_cache is None
                 else self._plan_cache)
        plan = autotune.plan_regime(
            graph, microbench=self.microbench, dtype=self.dtype,
            device=self.device, cache=cache,
            calibration=(autotune._USE_GLOBAL if self.calibrate else None))
        if plan != self.plan:
            self.plan = plan
            self._apply_plan(plan)
        return super().prepare(graph, activity)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        t0 = time.perf_counter()
        res = super().run(tol=tol, max_iter=max_iter, s0=s0)
        wall = time.perf_counter() - t0
        # a >3-iteration resolve amortizes the fixed overhead enough for
        # wall/iter to stand in for the step time the model predicts
        if (self.calibrate and self.plan is not None and res.iterations > 3
                and wall > 0.0 and self.plan.est_bytes > 0.0):
            obs_calibrate.get_store().observe(
                self.plan.regime, self.plan.est_bytes,
                wall / res.iterations * 1e6,
                env=obs_calibrate.env_key(self.device, self.dtype),
                source="step_span")
        return res
