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
  * ``distributed`` — the 2-D block-cyclic schedule of
    :mod:`repro_torch.core.distributed` over a ``torch.distributed`` mesh,
    chunked on the host (:class:`DistributedEngine`).
  * ``async`` — the bounded-staleness chunk scheduler of
    :mod:`repro_torch.asyncexec` (:class:`AsyncEngine`).

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
import functools
import inspect
import time
from typing import Any

import numpy as np
import torch

from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from ..kernels.formats import build_bsr, build_edge_tiles
from ..kernels.ops import (DeviceBsr, DeviceEdgeTiles, _i32, bsr_step,
                           edge_spmv, power_step, power_step_lanes)
from ..obs import calibrate as obs_calibrate
from ..obs import convergence as obs_convergence
from ..obs import log as obs_log
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .activity import Activity
from .operators import HostOperators, PsiOperators
from .power_psi import _NORMS, PsiResult

__all__ = ["ConvergenceCriterion", "EngineState", "PsiEngine",
           "ReferenceEngine", "AcceleratedEngine", "CudaEngine", "AutoEngine",
           "DistributedEngine", "AsyncEngine", "ChunkExtrapolator",
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

    def scale(self, b_norm) -> float:
        return float(b_norm) if self.use_b_norm else 1.0

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
def _instrument_run(run):
    """Wrap a backend's ``run`` with the telemetry plane (repro_torch.obs).

    Applied automatically by :meth:`PsiEngine.__init_subclass__` to every
    backend that defines its own ``run`` — one instrumentation point for
    all current and future backends, including out-of-package ones like
    ``repro_torch.localpush``. When every obs sink is null the wrapper is
    one boolean check and a tail call; otherwise it opens an ``engine.run``
    span + a convergence record around the resolve. Instrumentation only
    *reads* the result, so the returned ψ/s are bitwise identical either
    way. Only a live tracer makes the span wait for the result's CUDA
    stream (``Span.sync``, the dispatch/compute split it records); under
    the default null tracer the wrapper adds no device sync, and the
    record's duration is the host wall of ``run``, which ends in the gap
    read of the last step.
    """

    @functools.wraps(run)
    def wrapped(self, *args, **kwargs):
        tracker = obs_convergence.get_tracker()
        tracer = obs_trace.get_tracer()
        if not (tracker.enabled or tracer.enabled or obs_metrics.enabled()):
            return run(self, *args, **kwargs)
        rec = tracker.begin(self.name,
                            tenant=getattr(self, "obs_tenant", None))
        with obs_trace.span("engine.run", backend=self.name) as sp:
            try:
                res = run(self, *args, **kwargs)
            except BaseException:
                tracker.finish(rec, converged=False,
                               duration_s=sp.duration_s)
                raise
            if tracer.enabled:
                sp.sync(res.s)
        tracker.finish(rec, iterations=int(res.iterations),
                       gap=float(res.gap), converged=bool(res.converged),
                       duration_s=sp.duration_s,
                       psi_error_bound=self.psi_error_bound())
        return res

    wrapped._obs_instrumented = True
    return wrapped


def _instrument_prepare(prepare):
    """Wrap a backend's ``prepare`` in an ``engine.prepare`` span, applied
    by :meth:`PsiEngine.__init_subclass__` as :func:`_instrument_run` is,
    so every build is timed: :func:`make_engine`'s, and every re-prepare
    by the serving layer or the resilience ladder. A subclass's
    ``prepare`` that calls its parent's opens one span, not two. The
    span's seconds also go to the ``psi_engine_prepare_seconds`` histogram,
    which holds them where no tracer is live (a process's set-up)."""

    @functools.wraps(prepare)
    def wrapped(self, *args, **kwargs):
        if getattr(self, "_preparing", False):       # super().prepare(...)
            return prepare(self, *args, **kwargs)
        self._preparing = True
        try:
            with obs_trace.span("engine.prepare", backend=self.name) as sp:
                state = prepare(self, *args, **kwargs)
        finally:
            self._preparing = False
        obs_metrics.histogram(
            "psi_engine_prepare_seconds",
            "seconds a backend's prepare took (operators and formats)",
            labelnames=("backend",)).labels(backend=self.name).observe(
                sp.duration_s)
        return state

    wrapped._obs_instrumented = True
    return wrapped


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

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        run = cls.__dict__.get("run")
        if run is not None and not getattr(run, "_obs_instrumented", False):
            cls.run = _instrument_run(run)
        prepare = cls.__dict__.get("prepare")
        if prepare is not None and not getattr(prepare, "_obs_instrumented",
                                               False):
            cls.prepare = _instrument_prepare(prepare)

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
            with obs_trace.hot_span("engine.issue"):
                for _ in range(k - 1):
                    s, _ = self.one_step(args, s)
                s, raw = self.one_step(args, s)
            with obs_trace.hot_span("engine.gap_read"):
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


def _l1(x) -> float:
    return float(abs(x).sum())


class ChunkExtrapolator:
    """Host-side Aitken jump between fixed-length device chunks.

    The ``distributed`` backend (and ``runtime/psi_driver.py``) evaluate
    convergence between ``chunk_iters``-step chunks; this helper
    extrapolates across chunk *endpoints*: the per-chunk contraction ratio
    is ρ^chunk_iters, so the remaining tail after chunk t sums to
    Δ_t · r/(1−r) exactly as in the per-iteration loop. Eq. 19 survives
    because the termination gap is always produced by the *next* chunk's
    plain steps (≥ 1 plain iteration after any jump). A chunk whose gap
    fails to shrink disables all future jumps — no revert is needed since
    the chunk's plain steps already re-contracted the iterate.

    **Epoch-consistency guard** (async executors): the geometric-tail
    formula assumes Δ = s_out − s_in spans a *uniform* number of
    contraction applications on every coordinate. Under bounded-staleness
    execution a chunk endpoint can mix per-chunk epochs; callers pass the
    endpoint pair's ``epoch_spread`` (max − min contributing chunk epoch)
    and the extrapolator only jumps on same-epoch pairs (``spread == 0``),
    dropping its ratio history otherwise — a mixed-epoch Δ is not one
    contraction sample and must not seed r.

    ``l1(x)`` is the norm of a Δ (tensor or array); a sharded iterate
    passes its global norm (:meth:`DistributedPsi.l1`), so every rank takes
    the same decisions.
    """

    def __init__(self, tol: float, *, guard: float = 100.0, l1=_l1):
        self.tol = tol
        self.guard = guard
        self.l1 = l1
        self.reset()

    def reset(self) -> None:
        """Forget history (e.g. after a checkpoint restore)."""
        self._prev_dn: float | None = None
        self._gap_prev = float("inf")
        self.enabled = True
        self.jumps = 0

    def advance(self, s_in, s_out, gap: float, *, epoch_spread: int = 0):
        """Map a finished chunk (input → output, scaled gap) to the next
        chunk's start vector, possibly extrapolated. ``epoch_spread != 0``
        marks the endpoints as epoch-inconsistent: no jump fires and the
        Δ-ratio history resets (synchronous callers pass the default 0)."""
        if not self.enabled:
            return s_out
        if epoch_spread != 0:
            # mixed-epoch Δ poisons both the ratio history and the
            # gap-progress baseline — drop them, keep only `enabled`
            self._prev_dn = None
            self._gap_prev = float("inf")
            return s_out
        if gap >= self._gap_prev:             # jump/stall did not help
            self.enabled = False
            obs_convergence.record_aitken(False)
            return s_out
        self._gap_prev = gap
        dn = self.l1(s_out - s_in)
        r = 0.0 if not self._prev_dn else dn / self._prev_dn
        self._prev_dn = dn
        if 0.0 < r < 0.999 and gap > self.guard * self.tol:
            self.jumps += 1
            obs_convergence.record_aitken(True)
            return s_out + (s_out - s_in) * (r / (1.0 - r))
        return s_out


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
    criterion's norm must be ``l1``. The ``edge_tile`` regime's ψ epilogue
    pushes with the ``edge_spmv`` kernel, in the fleet's form
    ``(λ ⊙ edge_spmv(s ⊙ 1/w) + d) · 1/n`` with 1/n rounded once in the
    working dtype, so a solo solve's ψ is bit for bit a fleet lane's where
    their inputs are; the ``bsr`` regime keeps the operators' push.
    Activity patches refresh only node
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
        """Build the regime's format on the host and copy it to the device,
        in a ``format.build`` span whose seconds also go to the
        ``psi_format_build_seconds`` histogram (a prepare's build, or a
        rebuild an edge patch forces). An edge-tile format gets the step
        kernel's plan, whose share of the slots on the row path goes to the
        gauge ``psi_edge_tile_row_path_share``."""
        with obs_trace.span("format.build", regime=self.regime) as sp:
            if self.regime == "edge_tile":
                self.fmt_host = build_edge_tiles(graph, tile=self.tile,
                                                 e1=self.e1, e2=self.e2)
                self.fmt = DeviceEdgeTiles.from_format(
                    self.fmt_host, self.device).with_row_plan()
                obs_metrics.gauge(
                    "psi_edge_tile_row_path_share",
                    "share of the real slots of the last edge-tile format "
                    "a cuda engine built whose tile the step kernel folds "
                    "on its row path").set(self.fmt.row_path_share)
                self._rebuild_tile_cursor()
                self._refresh_padded()
            else:
                self.fmt_host = build_bsr(graph, ts=self.ts, td=self.td,
                                          dtype=numpy_dtype(self.dtype))
                self.fmt = DeviceBsr.from_format(self.fmt_host, self.device)
                self._rebuild_bsr_block_map()
        self.format_builds += 1
        obs_metrics.histogram(
            "psi_format_build_seconds",
            "seconds a cuda engine's format build took (host and copy)",
            labelnames=("regime",)).labels(regime=self.regime).observe(
                sp.duration_s)

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
        one = numpy_dtype(self.dtype).type(1.0)
        self._inv_n = torch.as_tensor(one / one.dtype.type(f.n),
                                      device=self.device)

    def epilogue(self, s) -> torch.Tensor:
        """ψᵀ = (sᵀB + dᵀ)/N from a node-order series vector; in the
        ``edge_tile`` regime through the ``edge_spmv`` kernel."""
        s = self._as_node_vector(s)
        if self.regime != "edge_tile":
            return self.ops.psi_epilogue(s)
        ops = self.ops
        return (ops.lam * edge_spmv(s * ops.inv_w, self.fmt) + ops.d) \
            * self._inv_n

    def _step_args(self):
        if self.regime == "edge_tile":
            return (self.fmt, self._inv_w_gather, self._mu_pad, self._c_pad)
        return (self.fmt, self.ops.inv_w, self.ops.mu, self.ops.c)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        s_init = self._to_native(self._s0_node_order(s0))
        s, gap, t = self._loop(s_init, tol, max_iter)
        s_n = self._from_native(s)
        return self._result(self.epilogue(s_n), s_n, gap, t, tol)

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
            # of re-uploading all M edges; the tiles written leave the step
            # kernel's row path, whose rows must be in slot order
            b, slot, s_id, d_loc = (np.asarray(x) for x in zip(*slots))
            i, j = np.divmod(slot, self.e2)
            idx = tuple(torch.as_tensor(x, dtype=torch.int64,
                                        device=self.device)
                        for x in (b, i, j))
            self.fmt.src_idx.index_put_(idx, _i32(s_id, self.device))
            self.fmt.dst_local.index_put_(idx, _i32(d_loc, self.device))
            self.fmt.take_ring(np.unique(self.fmt_host.block_tile[b]))

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
    # super().run is already the instrumented CudaEngine.run — marking
    # this thin timer prevents a second nested span/record per resolve
    run._obs_instrumented = True


# --------------------------------------------------------------------- #
# distributed — 2-D block-cyclic schedule over torch.distributed, chunked
# --------------------------------------------------------------------- #
@register_backend("distributed")
class DistributedEngine(PsiEngine):
    """Sharded Power-ψ over a (data, model) mesh
    (:func:`repro_torch.launch.mesh.make_mesh`; without ``mesh=`` a
    ``(world_size, 1)`` mesh on the engine's device, world size 1 when no
    process group runs).

    The device program is a fixed-length ``chunk_iters``-step chunk; the
    criterion is evaluated on the host between chunks (iteration counts are
    therefore multiples of ``chunk_iters``), exactly the
    ``runtime/psi_driver.py`` schedule. The gap norm must be ``l1`` (what the
    sharded step sums). ``s`` is converted to/from node order at the API
    boundary so results interchange with the other backends.

    ``accelerate=True`` applies the Aitken jump at *chunk* granularity via
    :class:`ChunkExtrapolator`. ``patch_edges`` is a block-local O(Δ)
    insert into the node-stable 2-D partition; a genuine block overflow
    (``e_max`` exceeded) is handled per ``on_overflow``:

    * ``"regrow"`` (default) — warn naming the overflowing block and the
      required capacity, rebuild the partitioned arrays from the
      already-patched host graph at the grown ``e_max``, and return True.
    * ``"raise"`` — raise :class:`~repro_torch.core.distributed.
      BlockOverflowError` (block, ``e_max``, required capacity) for callers
      that budget capacity themselves; nothing is mutated.
    """

    def __init__(self, *, mesh=None, chunk_iters: int = 16,
                 on_overflow: str = "regrow", **kw):
        super().__init__(**kw)
        if self.criterion.norm != "l1":
            raise ValueError("distributed backend sums an l1 gap; "
                             f"got norm={self.criterion.norm!r}")
        if on_overflow not in ("regrow", "raise"):
            raise ValueError(f"on_overflow must be 'regrow' or 'raise'; "
                             f"got {on_overflow!r}")
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh is on {mesh.device}, the engine on "
                             f"{self.device}")
        self.mesh = mesh
        self.chunk_iters = chunk_iters
        self.on_overflow = on_overflow
        self.dist = None

    def _install_dist(self, dist) -> None:
        self.dist = dist
        self._run_chunk = dist.make_run(chunk_iters=self.chunk_iters)
        self._one_step = dist.make_step()
        self._epi = dist.make_epilogue()

    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        from ..launch.mesh import make_mesh, world_size
        from .distributed import DistributedPsi
        self._base_prepare(graph, activity)
        if self.mesh is None:
            self.mesh = make_mesh((world_size(), 1), ("data", "model"),
                                  device=self.device)
        self._install_dist(DistributedPsi.from_graph(
            graph, activity, self.mesh, dtype=self.dtype))
        return EngineState(s=self.dist.arrays.c_src)

    def step(self, state: EngineState) -> EngineState:
        s_new, gap = self._one_step(state.s, self.dist.arrays)
        scale = self.criterion.scale(self.host.b_norm)
        return EngineState(s=s_new, gap=scale * float(gap), t=state.t + 1)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        dist = self.dist
        if s0 is None:
            s = dist.arrays.c_src
        else:
            s_host = torch.as_tensor(s0).detach().cpu().numpy()
            s = dist.local_src(dist.part.to_src_layout(
                s_host.astype(numpy_dtype(self.dtype))))
        scale = self.criterion.scale(self.host.b_norm)
        extrap = (ChunkExtrapolator(tol, l1=dist.l1) if self.accelerate
                  else None)
        it, gap = 0, float("inf")
        while it < max_iter and gap > tol:
            s_new, gap_dev = self._run_chunk(s, dist.arrays)
            it += self.chunk_iters
            raw = float(gap_dev)
            gap = scale * raw
            # the host already read this gap — record it, free of syncs
            obs_convergence.record_gap(it, raw=raw, certified=gap)
            s = extrap.advance(s, s_new, gap) if extrap else s_new
        psi = dist.gather_psi(self._epi(s, dist.arrays))
        s_node = dist.part.from_src_layout(dist.gather_src(s))
        return self._result(self._as_node_vector(psi),
                            self._as_node_vector(s_node), gap, it, tol)

    def patch_activity(self, users, lam=None, mu=None) -> bool:
        # partition and edge layouts are untouched; only the activity-derived
        # arrays are rebuilt (no re-partition, no edge re-sort)
        self.host.patch_activity(users, lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        self.dist.arrays = self.dist.build_arrays(self.graph, self.activity)
        return True

    def patch_edges(self, src, dst) -> bool:
        """Block-local edge insert into the node-stable 2-D partition.

        The node → (row, col) ownership map depends only on (n, d, mo, q),
        so a new edge lands in exactly one block; it is merged dst-sorted
        into that block's host slice (sentinels stay at the tail), the rank
        owning a touched block uploads that block's src ids and run
        lengths, and every rank rewrites the 1/w entries of its row — no
        re-partition, no O(M) rebuild. A genuine ``e_max`` block overflow
        regrows the partition (with a warning naming the block and required
        capacity) or raises :class:`~repro_torch.core.distributed.
        BlockOverflowError`, per the engine's ``on_overflow`` option.
        """
        from .distributed import BlockOverflowError, DistributedPsi
        p = self.dist.part
        nc, q = p.nc, p.q
        # probe (no mutation) first: on_overflow='raise' must leave the
        # host mirror untouched, or a caught-and-retried patch would dedup
        # against the half-applied state and silently skip the device insert
        src_k, dst_k = self.host.filter_new_edges(src, dst)
        if src_k.size == 0:
            return True
        s64 = src_k.astype(np.int64)
        d64 = dst_k.astype(np.int64)
        c_of_src = s64 // nc
        off = s64 - c_of_src * nc
        row = off // q
        src_loc = (c_of_src * q + (off - row * q)).astype(np.int32)
        col = d64 // nc
        dst_loc = (d64 - col * nc).astype(np.int32)
        add = np.zeros((p.d, p.mo), np.int64)
        np.add.at(add, (row, col), 1)
        over = p.e_counts + add > p.e_max
        if np.any(over):
            # name the *worst* overflowing block so the reported required
            # capacity belongs to the block in the message
            need = p.e_counts + add
            r_o, c_o = (int(x) for x in
                        np.unravel_index(int(np.argmax(need)), need.shape))
            required = int(need[r_o, c_o])
            if self.on_overflow == "raise":
                raise BlockOverflowError((r_o, c_o), int(p.e_max), required)
            obs_log.warn(
                "block_overflow_regrow",
                f"distributed patch_edges: block (row={r_o}, col={c_o}) "
                f"overflows e_max={int(p.e_max)} (insert requires capacity "
                f">= {required}); regrowing the partition from the patched "
                f"graph", category=RuntimeWarning,
                row=r_o, col=c_o, e_max=int(p.e_max), required=required)
            # commit the edges to the host mirror, then repartition once at
            # the grown e_max
            self.host.insert_filtered(src_k, dst_k)
            self._graph_stale = True
            self._install_dist(DistributedPsi.from_graph(
                self.graph, self.activity, self.mesh, dtype=self.dtype))
            self.ops = self.host.to_device(self.dtype, self.device)
            return True
        self.host.insert_filtered(src_k, dst_k)
        self._graph_stale = True
        a = self.dist.arrays
        mesh = self.mesh
        src_local, lengths = a.src_local, a.lengths
        for r, c in {(int(r), int(c)) for r, c in zip(row, col)}:
            sel = (row == r) & (col == c)
            s_row = p.src_local[r, c]
            d_row = p.dst_local[r, c]
            cnt = int(p.e_counts[r, c])
            for sl, dl in sorted(zip(src_loc[sel], dst_loc[sel]),
                                 key=lambda e: e[1]):
                ins = int(np.searchsorted(d_row[:cnt], dl, side="right"))
                s_row[ins + 1:cnt + 1] = s_row[ins:cnt].copy()
                d_row[ins + 1:cnt + 1] = d_row[ins:cnt].copy()
                s_row[ins], d_row[ins] = sl, dl
                cnt += 1
            p.e_counts[r, c] = cnt
            if (r, c) == (mesh.row, mesh.col):
                src_local = torch.as_tensor(s_row.astype(np.int64),
                                            device=self.device)
                lengths = torch.as_tensor(
                    np.bincount(d_row, minlength=nc + 1), device=self.device)
        # 1/w changed only at the src endpoints of the new edges; this rank
        # holds the entries of its row
        g = np.unique(s64)
        c_of = g // nc
        off_g = g - c_of * nc
        r_g = off_g // q
        mine = r_g == mesh.row
        loc_g = (c_of * q + (off_g - r_g * q))[mine]
        inv_w_src = a.inv_w_src.clone()
        inv_w_src[torch.as_tensor(loc_g, device=self.device)] = torch.as_tensor(
            self.host.inv_w[g[mine]], dtype=self.dtype, device=self.device)
        self.dist.arrays = dataclasses.replace(
            a, src_local=src_local, lengths=lengths, inv_w_src=inv_w_src)
        self.ops = self.host.to_device(self.dtype, self.device)
        return True


# --------------------------------------------------------------------- #
# async — bounded-staleness overlapped chunk scheduler (repro_torch.asyncexec)
# --------------------------------------------------------------------- #
@register_backend("async")
class AsyncEngine(PsiEngine):
    """Power-ψ through the bounded-staleness chunk scheduler.

    The node set splits into ``num_chunks`` dst-row chunks; each carries an
    epoch counter and steps against the latest published board without a
    global barrier — a chunk may run up to ``tau`` epochs ahead of the
    slowest one (``tau=0`` is exactly the bulk-synchronous schedule).
    Termination is gated by the stale-corrected Eq. 19 certificate and
    always sealed by a synchronous verification sweep, so results are
    interchangeable with every other backend. On a card each worker thread
    steps on its own CUDA stream.

    ``delay_hook(chunk, epoch) -> seconds`` injects simulated stragglers;
    ``read_hook(reader, neighbor, epochs) -> lag`` forces reads from the
    epoch history (the staleness-injection test harness). The gap norm is
    ``l1`` (what the chunk deltas sum to).
    """

    def __init__(self, *, num_chunks: int = 4, tau: int = 2,
                 max_workers: int | None = None, delay_hook=None,
                 read_hook=None, lane_pad: int = 128, **kw):
        super().__init__(**kw)
        if self.criterion.norm != "l1":
            raise ValueError("async backend sums per-chunk l1 gaps; "
                             f"got norm={self.criterion.norm!r}")
        if self.accelerate:
            raise ValueError(
                "async backend has no Aitken composition (a mixed-epoch Δ "
                "is not a contraction sample — see ChunkExtrapolator's "
                "epoch guard); run accelerate on a synchronous backend")
        from ..asyncexec.staleness import StalenessBound
        StalenessBound(tau)                  # validate tau eagerly
        self.num_chunks = int(num_chunks)
        self.tau = int(tau)
        self.max_workers = max_workers
        self.delay_hook = delay_hook
        self.read_hook = read_hook
        self.lane_pad = int(lane_pad)
        self.sched = None
        self.chunked = None

    def prepare(self, graph: Graph, activity: Activity) -> EngineState:
        from ..asyncexec.scheduler import (AsyncChunkScheduler,
                                           ChunkedOperators)
        from ..asyncexec.staleness import StalenessBound
        self._base_prepare(graph, activity)
        self.chunked = ChunkedOperators(self.host, self.num_chunks,
                                        dtype=self.dtype,
                                        lane_pad=self.lane_pad,
                                        device=self.device)
        self.sched = AsyncChunkScheduler(
            self.chunked, bound=StalenessBound(self.tau),
            max_workers=self.max_workers, delay_hook=self.delay_hook,
            read_hook=self.read_hook)
        return EngineState(s=self.chunked.board0)

    def step(self, state: EngineState) -> EngineState:
        """One *synchronous* sweep of every chunk — the protocol-level step
        (the overlap lives in ``run``, not here)."""
        board, raw = self.sched.sync_sweep(state.s)
        return EngineState(s=board, gap=float(self._scale()) * raw,
                           t=state.t + 1)

    def run(self, *, tol=None, max_iter=None, s0=None) -> PsiResult:
        tol, max_iter = self.criterion.resolve(tol, max_iter)
        self.sched.reset(s0=None if s0 is None
                         else self._s0_node_order(s0))
        out = self.sched.run(tol=tol, max_epochs=max_iter,
                             scale=float(self._scale()))
        self.last_run = out                  # staleness/overlap observability
        s_node = self.chunked.node_order(out.s)
        res = self._result(self.ops.psi_epilogue(s_node), s_node, out.gap,
                           int(out.epochs.max()), tol)
        # converged comes from the scheduler, not gap ≤ tol: an epoch-budget
        # exit reports the latest *stale* gap sum, which may under-report
        # the true residual and must never claim convergence unverified
        return dataclasses.replace(
            res, converged=bool(out.converged),
            # honest currency: chunk-steps / chunks-per-sweep, + epilogue
            matvecs=-(-out.total_steps // self.num_chunks) + 1)

    # -- delta hooks (mid-flight capable at the scheduler level) --------- #
    def patch_activity(self, users, lam=None, mu=None) -> bool:
        self.host.patch_activity(users, lam=lam, mu=mu)
        self.ops = self.host.refresh_node_arrays(self.ops, self.dtype)
        self.sched.patch_node_arrays()
        return True

    def patch_edges(self, src, dst) -> bool:
        src, dst = self.host.patch_edges(src, dst)
        self._graph_stale = True
        self.ops = self.host.to_device(self.dtype, self.device)
        if src.size:
            self.sched.patch_edges(src, dst)
        return True

    def unpatch_edges(self, src, dst) -> bool:
        src, dst = self.host.remove_edges(src, dst)
        if src.size:
            self._graph_stale = True
            self.ops = self.host.to_device(self.dtype, self.device)
            # same touched-chunk rebuild as an insert: the scheduler's
            # patch hook re-reads the (already shrunk) host mirror
            self.sched.patch_edges(src, dst)
        return True
