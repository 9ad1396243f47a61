"""TenantFleet: many (graph, activity) tenants multiplexed onto one device.

The single-tenant serving story (:class:`repro_torch.core.incremental.
PsiService`) leaves the device idle between solves; a platform scoring many
communities / topics at once wants the opposite — one resident solver
amortized across a *fleet* of independent tenants. The fleet gets there in
three moves:

1. **Size-bucketing** (:mod:`repro_torch.serving.bucket`): tenants are
   padded to a small ladder of ``(n_pad, e_pad)`` capacities so same-bucket
   operator arrays stack along a lane axis. Pad nodes carry zero rates and
   pad edges point at the out-of-range sentinel the segment sum drops —
   inert by construction.
2. **Masked lane iteration**: one bucket solves as a single
   :func:`repro_torch.core.engine.make_batched_loop` call — a lane-batched
   step (every lane in one push) in one loop, each lane honoring the solo
   convergence rule. A converged lane *freezes bitwise* (``torch.where``
   keeps its series vector) while neighbours keep stepping; lanes that were
   already clean when the solve started never move at all.
3. **Warm-state continuity**: every mutation goes through the tenant's own
   O(Δ) :class:`~repro_torch.core.operators.HostOperators` mirror, re-solves
   warm from the previous fixed point, and — when edge growth escapes the
   bucket — the tenant *rebuckets* into the next capacity rung carrying its
   series vector along.

Three execution regimes — ``dense`` (each lane's {0,1} adjacency, one
batched product ``[L, 1, n] @ [L, n, n]``: the regime for buckets of small
tenants), ``reference`` (one fixed-order segment sum over every lane's
edges; any device, any dtype, O(m) memory) and ``cuda`` (alias ``pallas``:
the edge-tile ``power_step`` kernel stepping every lane of the bucket in
one launch, ``edge_spmv`` for the ψ epilogue, tile parameters planned once
per *bucket shape* by :func:`repro_torch.kernels.autotune.plan_for_bucket`
and shared by every same-bucket tenant). ``auto`` picks per bucket:
``dense`` up to ``dense_max_n`` nodes, otherwise ``cuda`` on a CUDA device
and ``reference`` on the CPU. Queries go through
:class:`repro_torch.serving.frontier.FleetRankingCache`.

The port of the JAX package's ``repro.serving.fleet``. JAX's arrays are
immutable and its fleet rewrites a lane with ``.at[lane].set``; here a
lane refresh writes the new rows *in place* into the stacked tensors
(operators, format, ‖B‖, epilogue vectors), never touching another lane's
rows, and the loop's ``torch.where`` gives a fresh iterate. The ψ epilogue
is ``(λ ⊙ t + d) · (1/n)`` with ``1/n`` rounded in the working dtype, which
is how a CUDA tensor divides by a Python number (the solo engines'
``/ n``). ``device="cuda"`` (the default) raises without a card;
``device="cpu"`` runs the kernels' plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.activity import Activity
from ..core.engine import (dense_push, make_batched_loop, make_dense_step,
                           make_edge_tile_step, make_lane_reference_step)
from ..core.incremental import RankedQueries
from ..core.operators import HostOperators, LaneOperators
from ..device import numpy_dtype, resolve_device
from ..graphs.structure import Graph
from ..kernels.ops import DeviceEdgeTiles, edge_spmv_lanes
from ..obs import convergence as obs_convergence
from ..obs import explain as obs_explain
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .bucket import BucketPolicy, BucketSpec

__all__ = ["TenantFleet", "TenantView"]

_BACKENDS = ("auto", "dense", "reference", "cuda")
_ALIASES = {"pallas": "cuda"}       # the JAX package's kernel regime name


@dataclasses.dataclass
class _Tenant:
    """Host-side record of one admitted tenant."""

    tid: str
    host: HostOperators
    n: int
    spec: BucketSpec
    epoch: int = 0              # bumped on every mutation
    solved_epoch: int = -1      # epoch the stored ψ corresponds to
    s_host: np.ndarray | None = None   # node-order warm start, length n
    psi: np.ndarray | None = None
    iterations: int = 0
    gap: float = float("inf")
    converged: bool = False
    rebuckets: int = 0

    @property
    def staleness(self) -> int:
        return self.epoch - self.solved_epoch if self.solved_epoch >= 0 \
            else self.epoch + 1


@dataclasses.dataclass
class _Bucket:
    """Device-side batch of one bucket shape (lane order = ``order``)."""

    spec: BucketSpec
    regime: str = ""                           # resolved at stack time
    order: list = dataclasses.field(default_factory=list)
    restack: bool = True                       # membership/shape changed
    refresh: dict = dataclasses.field(default_factory=dict)  # tid → kind
    args: Any = None                           # the regime's step args
    s: Any = None                              # stacked native state
    scale: Any = None                          # f[L] per-lane ‖B‖
    inv_n: Any = None                          # f[L, 1] 1/n (0 on pad lanes)
    lam: Any = None                            # f[L, n_pad] epilogue
    d: Any = None                              # vectors
    nb: int = 0                                # cuda regime block capacity
    plan: Any = None


class TenantFleet:
    """Admit / evict / patch tenants; solve them in lane-batched buckets.

    Args:
      backend: ``dense`` (batched product — small buckets), ``reference``
        (one segment sum over every lane), ``cuda`` (alias ``pallas``: the
        lane-batched edge-tile kernels) or ``auto`` (per-bucket choice
        under ``dense_max_n``, then ``cuda`` on a card and ``reference`` on
        the CPU).
      tol / max_iter: shared convergence criterion (Eq. 19 rule with the
        per-tenant ‖B‖ scale unless ``use_b_norm=False``).
      dtype: working float type; device: ``"cuda"`` (default; raises
        without a card) or ``"cpu"`` (the kernels' plain versions).
      policy: the :class:`BucketPolicy` sizing ladder.
      check_every: gap-evaluation cadence of the batched loop.
      dense_max_n: largest ``n_pad`` the ``auto`` backend will run dense
        (O(n²) lane memory is the constraint).
      microbench: time edge-tile candidates when planning a bucket
        (``cuda`` regime) instead of trusting the cost model.
      tile / e1 / e2: explicit edge-tile parameters (skip planning).
      plan_cache: override the process-level autotune plan cache.
    """

    def __init__(self, *, backend: str = "auto", tol: float = 1e-8,
                 max_iter: int = 10_000,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda",
                 policy: BucketPolicy | None = None, norm: str = "l1",
                 use_b_norm: bool = True, check_every: int = 1,
                 dense_max_n: int = 1024, microbench: bool = False,
                 tile: int | None = None, e1: int | None = None,
                 e2: int | None = None, plan_cache=None):
        backend = _ALIASES.get(backend, backend)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown fleet backend {backend!r}; "
                             f"available: {_BACKENDS} (pallas = cuda)")
        if backend in ("cuda", "auto") and norm != "l1":
            raise ValueError("the cuda regime computes its gap in l1; "
                             f"got norm={norm!r}")
        self.backend = backend
        self.norm = norm
        self.tol = float(tol)
        self.max_iter = int(max_iter)
        self._np_dtype = numpy_dtype(dtype)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.policy = policy or BucketPolicy()
        self.use_b_norm = bool(use_b_norm)
        self.check_every = int(check_every)
        self.dense_max_n = int(dense_max_n)
        self.microbench = bool(microbench)
        self._tile_override = ((tile, e1, e2)
                               if None not in (tile, e1, e2) else None)
        self._plan_cache = plan_cache
        self._machinery: dict[str, tuple] = {}   # regime → (loop, epilogue)
        self._tenants: dict[str, _Tenant] = {}
        self._buckets: dict[BucketSpec, _Bucket] = {}
        self._frontier = None
        self.solves = 0                  # batched loop runs
        self.lane_solves = 0             # lanes actually iterated

    # -- regime machinery ------------------------------------------------ #
    def _regime_for(self, spec: BucketSpec) -> str:
        if self.backend != "auto":
            regime, rule = self.backend, f"backend={self.backend!r} pinned"
        elif spec.n_pad <= self.dense_max_n:
            regime = "dense"
            rule = f"n_pad {spec.n_pad} ≤ dense_max_n {self.dense_max_n}"
        else:
            regime = "cuda" if self.device.type == "cuda" else "reference"
            rule = (f"n_pad {spec.n_pad} > dense_max_n {self.dense_max_n}, "
                    f"device={self.device.type}")
        obs_explain.record_decision(
            "bucket_regime", "TenantFleet._regime_for",
            inputs=dict(n_pad=int(spec.n_pad), e_pad=int(spec.e_pad),
                        backend=self.backend,
                        dense_max_n=self.dense_max_n),
            chosen=regime, source="model",
            candidates=[obs_explain.Candidate(
                name, chosen=(name == regime),
                detail=(dict(rule=rule) if name == regime else {}))
                for name in ("dense", "reference", "cuda")])
        return regime

    def _loop_and_epilogue(self, regime: str) -> tuple:
        """The (batched loop, batched epilogue) pair of one regime, built
        lazily and shared by every bucket the regime serves. The epilogue
        maps ``(args, s, λ, d, 1/n)`` to every lane's ψ ``f[L, n_pad]``."""
        if regime in self._machinery:
            return self._machinery[regime]
        if regime == "reference":
            one_step = make_lane_reference_step(self.norm)

            def push(ops, s):
                return ops.push(s)
        elif regime == "dense":
            one_step = make_dense_step(self.norm)

            def push(args, s):
                E, inv_w, _, _ = args
                return dense_push(s * inv_w, E)
        else:
            one_step = make_edge_tile_step()

            def push(args, s):
                fmt, inv_w_g, _, _ = args
                s_pre = s[:, 0, :fmt.n] * inv_w_g[:, 0, :fmt.n]
                return edge_spmv_lanes(s_pre, fmt)

        def epilogue(args, s, lam, d, inv_n):
            return (lam * push(args, s) + d) * inv_n

        # guard the batched loop: bucket-shape churn is the cost the retrace
        # counter exists to surface. warn=False — the loop is shared across
        # bucket shapes, so a second bucket's first signature is expected
        # (still counted, not alerted)
        pair = (obs_trace.retrace_guard(
                    make_batched_loop(one_step,
                                      check_every=self.check_every),
                    name=f"fleet.{regime}.loop", warn=False),
                epilogue)
        self._machinery[regime] = pair
        return pair

    # -- introspection --------------------------------------------------- #
    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    @property
    def tenant_ids(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    @property
    def frontier(self):
        """The cross-tenant query layer (lazily constructed)."""
        if self._frontier is None:
            from .frontier import FleetRankingCache
            self._frontier = FleetRankingCache(self)
        return self._frontier

    def view(self, tenant_id: str) -> "TenantView":
        """A PsiService-shaped single-tenant view (see TenantView)."""
        self._rec(tenant_id)
        return TenantView(self, tenant_id)

    def spec_of(self, tenant_id: str) -> BucketSpec:
        return self._rec(tenant_id).spec

    def stats(self, tenant_id: str) -> dict:
        r = self._rec(tenant_id)
        return dict(n=r.n, m=r.host.m, spec=r.spec, epoch=r.epoch,
                    solved_epoch=r.solved_epoch, staleness=r.staleness,
                    iterations=r.iterations, gap=r.gap,
                    converged=r.converged, rebuckets=r.rebuckets)

    def occupancy(self) -> dict:
        """Per-bucket padding accounting (see BucketPolicy.occupancy)."""
        out = {}
        for spec, bucket in sorted(self._buckets.items()):
            pairs = [(self._tenants[t].n, self._tenants[t].host.m)
                     for t in bucket.order]
            acct = self.policy.occupancy(spec, pairs)
            acct["regime"] = bucket.regime or self._regime_for(spec)
            if bucket.plan is not None:
                acct["plan"] = bucket.plan.params()
            out[spec] = acct
        return out

    # -- tenant lifecycle ------------------------------------------------ #
    def admit(self, tenant_id: str, graph: Graph, activity: Activity, *,
              s0: np.ndarray | None = None) -> BucketSpec:
        """Register a tenant; it solves lazily at the next query/solve.

        ``s0`` optionally warm-starts the first solve (e.g. a series vector
        migrated from another fleet or a solo engine's ``PsiResult.s``).

        The graph is deduped on the way in (the paper's model has neither
        self-loops nor multi-edges, and the execution regimes would
        otherwise disagree on duplicate counting — the dense adjacency is
        {0,1} while the edge form sums every occurrence).
        """
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} already admitted")
        graph = graph.dedup()
        host = HostOperators.from_graph(graph, activity)
        spec = self.policy.bucket_for(graph.n, graph.m)
        rec = _Tenant(tid=tenant_id, host=host, n=graph.n, spec=spec)
        if s0 is not None:
            if isinstance(s0, torch.Tensor):
                s0 = s0.detach().cpu().numpy()
            s0 = np.asarray(s0, self._np_dtype).reshape(-1)
            if s0.shape != (graph.n,):
                raise ValueError(f"s0 must be f[{graph.n}]; got {s0.shape}")
            rec.s_host = s0.copy()
        self._tenants[tenant_id] = rec
        self._join_bucket(rec)
        obs_metrics.gauge(
            "psi_fleet_tenants",
            "tenants currently admitted to the fleet"
        ).set(len(self._tenants))
        return spec

    def evict(self, tenant_id: str) -> np.ndarray | None:
        """Drop a tenant; returns its last ψ (None if never solved)."""
        rec = self._rec(tenant_id)
        self._leave_bucket(rec)
        del self._tenants[tenant_id]
        if self._frontier is not None:
            self._frontier.drop(tenant_id)
        obs_metrics.gauge(
            "psi_fleet_tenants",
            "tenants currently admitted to the fleet"
        ).set(len(self._tenants))
        return rec.psi

    def patch_activity(self, tenant_id: str, users, lam=None,
                       mu=None) -> None:
        """O(Δ) λ/μ patch on one tenant; its lane re-solves warm.

        An empty user set is a true no-op — the tenant stays clean, its
        epoch does not advance and no lane refresh is scheduled.
        """
        users = np.asarray(users).reshape(-1)
        if users.size == 0:
            return
        rec = self._rec(tenant_id)
        rec.host.patch_activity(users, lam=lam, mu=mu)
        self._mark_dirty(rec, "activity")

    def patch_edges(self, tenant_id: str, src, dst) -> None:
        """Edge insert on one tenant; rebuckets when growth escapes the
        bucket's edge capacity (warm state migrates with the tenant)."""
        rec = self._rec(tenant_id)
        kept_src, _ = rec.host.patch_edges(np.asarray(src, np.int32),
                                           np.asarray(dst, np.int32))
        if kept_src.size == 0:
            return
        if self.policy.needs_rebucket(rec.spec, rec.n, rec.host.m):
            self._leave_bucket(rec)
            rec.spec = self.policy.bucket_for(rec.n, rec.host.m)
            rec.rebuckets += 1
            rec.epoch += 1
            self._join_bucket(rec)
            obs_metrics.counter(
                "psi_fleet_rebuckets_total",
                "tenants migrated to a larger capacity rung").inc()
        else:
            self._mark_dirty(rec, "edges")

    def remove_edges(self, tenant_id: str, src, dst) -> None:
        """Edge removal (unfollow tombstones) on one tenant; absent pairs
        are ignored. Shrinking never rebuckets — the bucket spec is an
        upper bound — so this is always a lane-local refresh."""
        rec = self._rec(tenant_id)
        kept_src, _ = rec.host.remove_edges(np.asarray(src, np.int32),
                                            np.asarray(dst, np.int32))
        if kept_src.size == 0:
            return
        self._mark_dirty(rec, "edges")

    def activity(self, tenant_id: str) -> Activity:
        """The tenant's current λ/μ rates (host-mirror copy)."""
        return self._rec(tenant_id).host.activity()

    def invalidate(self) -> None:
        """Forget all solver state: the next solve is cold (s₀ = c).

        The stacked device operators are kept — only the iterate resets —
        so a post-invalidate solve measures pure solver work, exactly like
        a solo engine's cold ``run()`` over prebuilt operators.
        """
        for bucket in self._buckets.values():
            if bucket.args is not None and not bucket.restack \
                    and not bucket.refresh:
                bucket.s = self._cold_state(bucket)
            else:
                # pending lane refreshes (or no stack at all): the kept
                # args would be stale — rebuild from the host mirrors
                bucket.restack = True
                bucket.args = bucket.s = None
            bucket.refresh.clear()
        for rec in self._tenants.values():
            rec.s_host = None
            rec.solved_epoch = -1

    def _cold_state(self, bucket: _Bucket) -> torch.Tensor:
        """The stacked cold-start iterate s₀ = c in the regime's layout (a
        copy: lane refreshes write into ``c`` in place)."""
        if bucket.regime == "reference":
            return bucket.args.c.clone()
        return bucket.args[3].clone()      # dense: c vectors; cuda: c_pad

    # -- solving --------------------------------------------------------- #
    def solve(self, *, force: bool = False) -> int:
        """Re-solve every bucket with a stale tenant; returns lanes run.

        Per bucket this is ONE masked loop over its lanes (on the card, one
        ``power_step`` launch a step for the whole bucket): dirty lanes
        iterate from their warm state, clean lanes are masked inactive and
        stay bitwise frozen (their recomputed ψ is bit-identical).
        """
        ran = 0
        for spec in sorted(self._buckets):
            bucket = self._buckets[spec]
            recs = [self._tenants[t] for t in bucket.order]
            dirty = [r.solved_epoch < r.epoch for r in recs]
            if not (any(dirty) or force):
                continue
            if bucket.restack:
                self._stack_bucket(bucket)
            elif bucket.refresh:
                self._apply_refresh(bucket)
                if bucket.restack:          # refresh escalated (block growth)
                    self._stack_bucket(bucket)
            loop, _ = self._loop_and_epilogue(bucket.regime)
            lanes = bucket.s.shape[0]
            active0 = np.zeros(lanes, bool)
            active0[:len(recs)] = [d or force for d in dirty]
            with obs_trace.span("fleet.solve", spec=str(spec),
                                regime=bucket.regime,
                                lanes=int(active0.sum())) as sp:
                s, gap, t = loop(
                    bucket.args, bucket.s, bucket.scale,
                    torch.tensor(self.tol, dtype=self.dtype,
                                 device=self.device),
                    self.max_iter,
                    torch.as_tensor(active0, device=self.device))
                sp.sync(s)
            bucket.s = s
            obs_metrics.gauge(
                "psi_fleet_lane_occupancy",
                "admitted lanes / lane capacity of the bucket",
                labelnames=("spec",)).labels(spec=str(spec)) \
                .set(len(recs) / max(lanes, 1))
            psi = self._run_epilogue(bucket).cpu().numpy()
            gap, t = gap.cpu().numpy(), t.cpu().numpy()
            tracker = obs_convergence.get_tracker()
            for lane, rec in enumerate(recs):
                if active0[lane]:
                    # clean lanes keep their stored ψ untouched (their
                    # frozen iterate would reproduce it bit-for-bit anyway)
                    rec.psi = psi[lane, :rec.n].copy()
                    rec.iterations = int(t[lane])
                    rec.gap = float(gap[lane])
                    rec.converged = rec.gap <= self.tol
                    ran += 1
                    if tracker.enabled:
                        # one endpoint-only record per re-solved tenant —
                        # the per-tenant convergence time series
                        tracker.finish(
                            tracker.begin("fleet", tenant=rec.tid),
                            iterations=rec.iterations, gap=rec.gap,
                            converged=rec.converged,
                            duration_s=sp.duration_s)
                rec.solved_epoch = rec.epoch
            self.solves += 1
            obs_metrics.counter("psi_fleet_solves_total",
                                "batched bucket loop launches").inc()
        self.lane_solves += ran
        if ran:
            obs_metrics.counter("psi_fleet_lane_solves_total",
                                "lanes actually iterated").inc(ran)
        return ran

    def psi(self, tenant_id: str) -> np.ndarray:
        """This tenant's ψ vector (solving first if anything is stale)."""
        self.solve()
        return self._rec(tenant_id).psi

    def series(self, tenant_id: str) -> np.ndarray | None:
        """The tenant's current node-order series vector s (warm state)."""
        rec = self._rec(tenant_id)
        self._sync_bucket(self._buckets[rec.spec])
        return rec.s_host

    def last_iterations(self, tenant_id: str) -> int:
        self.solve()
        return self._rec(tenant_id).iterations

    # -- internals: bookkeeping ------------------------------------------ #
    def _rec(self, tenant_id: str) -> _Tenant:
        try:
            return self._tenants[tenant_id]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant_id!r}; admitted: "
                           f"{sorted(self._tenants)}") from None

    def _mark_dirty(self, rec: _Tenant, kind: str) -> None:
        rec.epoch += 1
        bucket = self._buckets[rec.spec]
        if not bucket.restack:
            prev = bucket.refresh.get(rec.tid)
            bucket.refresh[rec.tid] = ("edges" if "edges" in (kind, prev)
                                       else kind)

    def _join_bucket(self, rec: _Tenant) -> None:
        bucket = self._buckets.get(rec.spec)
        if bucket is None:
            bucket = self._buckets[rec.spec] = _Bucket(spec=rec.spec)
        self._invalidate_stack(bucket)
        bucket.order.append(rec.tid)

    def _leave_bucket(self, rec: _Tenant) -> None:
        bucket = self._buckets[rec.spec]
        self._invalidate_stack(bucket)
        bucket.order.remove(rec.tid)
        bucket.refresh.pop(rec.tid, None)
        if not bucket.order:
            del self._buckets[rec.spec]

    def _invalidate_stack(self, bucket: _Bucket) -> None:
        """Membership is changing: preserve warm states, drop device batch."""
        self._sync_bucket(bucket)
        bucket.restack = True
        bucket.refresh.clear()
        bucket.args = bucket.s = None

    def _sync_bucket(self, bucket: _Bucket) -> None:
        """Pull each lane's series vector back to its tenant record."""
        if bucket.s is None:
            return
        s_node = self._node_order(bucket).cpu().numpy()
        for lane, tid in enumerate(bucket.order):
            rec = self._tenants[tid]
            rec.s_host = s_node[lane, :rec.n].copy()

    def _node_order(self, bucket: _Bucket) -> torch.Tensor:
        if bucket.regime == "cuda":
            return bucket.s[:, 0, :bucket.spec.n_pad]
        return bucket.s

    # -- internals: per-tenant padded arrays ----------------------------- #
    def _node_arrays(self, rec: _Tenant | None,
                     n_pad: int) -> tuple[dict, float]:
        """(padded node vectors, ‖B‖) for one lane; zeros for a pad lane
        (``rec is None``) — inert under the masked loop."""
        names = ("lam", "mu", "inv_w", "c", "d")
        if rec is None:
            return ({k: np.zeros(n_pad, self._np_dtype) for k in names}, 0.0)
        h = rec.host
        c, d = h.cd()
        out = {}
        for name, v in zip(names, (h.lam, h.mu, h.inv_w, c, d)):
            buf = np.zeros(n_pad, self._np_dtype)
            buf[:rec.n] = v
            out[name] = buf
        return out, float(h.b_norm)

    def _edge_arrays(self, rec: _Tenant | None,
                     spec: BucketSpec) -> tuple[np.ndarray, np.ndarray]:
        """dst-sorted edges padded to e_pad; pad slots scatter out-of-range
        (``dst == n_pad``), which the segment sum drops."""
        src = np.zeros(spec.e_pad, np.int32)
        dst = np.full(spec.e_pad, spec.n_pad, np.int32)
        if rec is not None:
            m = rec.host.m
            src[:m] = rec.host.src_by_dst
            dst[:m] = rec.host.dst_by_dst
        return src, dst

    def _lane_s0(self, rec: _Tenant | None, node: dict,
                 n_pad: int) -> np.ndarray:
        if rec is None or rec.s_host is None:
            return node["c"]                    # cold start: s₀ = c
        buf = np.zeros(n_pad, self._np_dtype)
        buf[:rec.n] = rec.s_host.astype(self._np_dtype)
        return buf

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # -- internals: stacking --------------------------------------------- #
    def _stack_bucket(self, bucket: _Bucket) -> None:
        spec = bucket.spec
        bucket.regime = self._regime_for(spec)
        recs: list[_Tenant | None] = [self._tenants[t] for t in bucket.order]
        recs += [None] * (self.policy.lanes_padded(len(recs)) - len(recs))
        nodes, b_norms, s0s = [], [], []
        for rec in recs:
            node, b_norm = self._node_arrays(rec, spec.n_pad)
            nodes.append(node)
            b_norms.append(b_norm)
            s0s.append(self._lane_s0(rec, node, spec.n_pad))
        # ψ = (λ ⊙ t + d) · 1/n, 1/n rounded once in the working dtype
        one = self._np_dtype.type(1.0)
        bucket.inv_n = self._tensor(np.asarray(
            [[0.0 if r is None else one / self._np_dtype.type(r.n)]
             for r in recs], self._np_dtype))
        bucket.scale = (self._tensor(np.asarray(b_norms, self._np_dtype))
                        if self.use_b_norm
                        else torch.ones(len(recs), dtype=self.dtype,
                                        device=self.device))
        bucket.lam = self._tensor(np.stack([n["lam"] for n in nodes]))
        bucket.d = self._tensor(np.stack([n["d"] for n in nodes]))
        if bucket.regime == "reference":
            self._stack_reference(bucket, recs, nodes, s0s)
        elif bucket.regime == "dense":
            self._stack_dense(bucket, recs, nodes, s0s)
        else:
            self._stack_cuda(bucket, recs, nodes, s0s)
        bucket.restack = False
        bucket.refresh.clear()

    def _stack_reference(self, bucket, recs, nodes, s0s) -> None:
        spec = bucket.spec
        edges = [self._edge_arrays(rec, spec) for rec in recs]
        dst = np.stack([e[1] for e in edges])
        vecs = {k: self._tensor(np.stack([n[k] for n in nodes]))
                for k in ("inv_w", "mu", "c")}
        bucket.args = LaneOperators(
            n=spec.n_pad,
            src=self._tensor(np.stack([e[0] for e in edges]), torch.int64),
            lengths=self._tensor(LaneOperators.segment_lengths(
                dst, spec.n_pad), torch.int64), **vecs)
        bucket.s = self._tensor(np.stack(s0s))

    def _dense_adjacency(self, rec: _Tenant | None,
                         n_pad: int) -> np.ndarray:
        E = np.zeros((n_pad, n_pad), self._np_dtype)
        if rec is not None:
            E[rec.host.src_by_dst, rec.host.dst_by_dst] = 1.0
        return E

    def _stack_dense(self, bucket, recs, nodes, s0s) -> None:
        spec = bucket.spec
        E = self._tensor(np.stack(
            [self._dense_adjacency(rec, spec.n_pad) for rec in recs]))
        vecs = {k: self._tensor(np.stack([n[k] for n in nodes]))
                for k in ("inv_w", "mu", "c")}
        bucket.args = (E, vecs["inv_w"], vecs["mu"], vecs["c"])
        bucket.s = self._tensor(np.stack(s0s))

    def _row(self, v: np.ndarray, width: int) -> np.ndarray:
        buf = np.zeros((1, width), self._np_dtype)
        buf[0, :v.shape[0]] = v
        return buf

    def _stack_cuda(self, bucket, recs, nodes, s0s) -> None:
        from ..kernels.formats import pad_edge_tile_blocks
        spec = bucket.spec
        tile, e1, e2 = self._bucket_plan(bucket, recs)
        fmts = [self._tenant_format(rec, spec, tile, e1, e2) for rec in recs]
        nb = max(f.num_blocks for f in fmts)
        bucket.nb = max(bucket.nb, -(-nb // 4) * 4)   # monotone, quantized
        fmt = DeviceEdgeTiles.stack(
            [pad_edge_tile_blocks(f, bucket.nb) for f in fmts],
            self.device).with_row_plan()
        n_fmt, n_g = fmt.n_pad, fmt.n_gather
        inv_w_g = self._tensor(np.stack(
            [self._row(n["inv_w"], n_g) for n in nodes]))
        mu_pad = self._tensor(np.stack(
            [self._row(n["mu"], n_fmt) for n in nodes]))
        c_pad = self._tensor(np.stack(
            [self._row(n["c"], n_fmt) for n in nodes]))
        bucket.args = (fmt, inv_w_g, mu_pad, c_pad)
        bucket.s = self._tensor(np.stack(
            [self._row(s0, n_fmt) for s0 in s0s]))

    def _bucket_plan(self, bucket: _Bucket,
                     recs) -> tuple[int, int, int]:
        """Edge-tile parameters shared by every tenant of this bucket."""
        if self._tile_override is not None:
            return self._tile_override
        if bucket.plan is None:
            from ..kernels import autotune
            rep = next((r for r in recs if r is not None), None)
            graph = (rep.host.graph() if rep is not None
                     else Graph(bucket.spec.n_pad, np.empty(0, np.int32),
                                np.empty(0, np.int32)))
            cache = (autotune.PLAN_CACHE if self._plan_cache is None
                     else self._plan_cache)
            bucket.plan = autotune.plan_for_bucket(
                graph, n_pad=bucket.spec.n_pad, e_pad=bucket.spec.e_pad,
                microbench=self.microbench, dtype=self.dtype,
                device=self.device, cache=cache)
        return bucket.plan.tile, bucket.plan.e1, bucket.plan.e2

    def _tenant_format(self, rec: _Tenant | None, spec: BucketSpec,
                       tile: int, e1: int, e2: int):
        from ..kernels.formats import build_edge_tiles
        if rec is None:
            gp = Graph(spec.n_pad, np.empty(0, np.int32),
                       np.empty(0, np.int32))
        else:
            gp = Graph(spec.n_pad, rec.host.src_by_dst.copy(),
                       rec.host.dst_by_dst.copy())
        return build_edge_tiles(gp, tile=tile, e1=e1, e2=e2)

    # -- internals: lane refresh (no restack) ---------------------------- #
    def _apply_refresh(self, bucket: _Bucket) -> None:
        """Write each patched tenant's new rows into its lane, in place."""
        spec = bucket.spec
        for tid, kind in list(bucket.refresh.items()):
            lane = bucket.order.index(tid)
            rec = self._tenants[tid]
            node, b_norm = self._node_arrays(rec, spec.n_pad)
            if self.use_b_norm:
                bucket.scale[lane] = b_norm
            bucket.lam[lane] = self._tensor(node["lam"])
            bucket.d[lane] = self._tensor(node["d"])
            if bucket.regime == "reference":
                ops = bucket.args
                for k in ("inv_w", "mu", "c"):
                    getattr(ops, k)[lane] = self._tensor(node[k])
                if kind == "edges":
                    src, dst = self._edge_arrays(rec, spec)
                    w = spec.n_pad + 1
                    ops.src[lane] = self._tensor(src, torch.int64)
                    ops.lengths[lane * w:(lane + 1) * w] = self._tensor(
                        LaneOperators.segment_lengths(dst[None], spec.n_pad),
                        torch.int64)
            elif bucket.regime == "dense":
                E, inv_w, mu, c = bucket.args
                if kind == "edges":
                    E[lane] = self._tensor(
                        self._dense_adjacency(rec, spec.n_pad))
                inv_w[lane] = self._tensor(node["inv_w"])
                mu[lane] = self._tensor(node["mu"])
                c[lane] = self._tensor(node["c"])
            else:
                fmt, inv_w_g, mu_pad, c_pad = bucket.args
                if kind == "edges":
                    from ..kernels.formats import pad_edge_tile_blocks
                    tile, e1, e2 = self._bucket_plan(bucket, [rec])
                    f = self._tenant_format(rec, spec, tile, e1, e2)
                    if f.num_blocks > bucket.nb:
                        # block capacity outgrown — full restack; sync the
                        # device batch first so every lane (this one and
                        # its clean co-tenants) restacks from its current
                        # series vector, not a stale or cold one
                        self._invalidate_stack(bucket)
                        return
                    fmt.write_lane(lane, pad_edge_tile_blocks(f, bucket.nb))
                inv_w_g[lane] = self._tensor(
                    self._row(node["inv_w"], inv_w_g.shape[-1]))
                mu_pad[lane] = self._tensor(
                    self._row(node["mu"], mu_pad.shape[-1]))
                c_pad[lane] = self._tensor(
                    self._row(node["c"], c_pad.shape[-1]))
        bucket.refresh.clear()

    def _run_epilogue(self, bucket: _Bucket) -> torch.Tensor:
        _, epilogue = self._loop_and_epilogue(bucket.regime)
        return epilogue(bucket.args, bucket.s, bucket.lam, bucket.d,
                        bucket.inv_n)


class TenantView(RankedQueries):
    """A PsiService-shaped thin view over one fleet tenant.

    Carries the full single-tenant serving surface — ``scores`` /
    ``scores_batch`` / ``top_k`` / ``rank_of`` plus the mutations
    ``update_activity`` / ``add_edges`` / ``remove_edges`` — but owns no
    solver: every call delegates to the shared fleet (and therefore
    batches with whatever co-tenants are dirty). Obtained via
    ``fleet.view(tid)`` or :meth:`repro_torch.core.incremental.PsiService.
    from_fleet`.
    """

    def __init__(self, fleet: TenantFleet, tenant_id: str):
        self._fleet = fleet
        self.tenant_id = tenant_id

    @property
    def backend(self) -> str:
        return f"fleet[{self._fleet.backend}]"

    @property
    def graph(self) -> Graph:
        return self._fleet._rec(self.tenant_id).host.graph()

    def update_activity(self, users, lam=None, mu=None) -> None:
        self._fleet.patch_activity(self.tenant_id, users, lam=lam, mu=mu)

    def add_edges(self, src, dst) -> None:
        self._fleet.patch_edges(self.tenant_id, src, dst)

    def remove_edges(self, src, dst) -> None:
        self._fleet.remove_edges(self.tenant_id, src, dst)

    def last_iterations(self) -> int:
        return self._fleet.last_iterations(self.tenant_id)

    @property
    def stale(self) -> bool:
        """True when mutations are pending a fleet solve (the next read
        triggers it — unlike PsiService, views never serve stale)."""
        return self._fleet._rec(self.tenant_id).staleness > 0

    def _obs_cache_state(self) -> str:
        rec = self._fleet._rec(self.tenant_id)
        entry = self._fleet.frontier._caches.get(self.tenant_id)
        fresh = entry is not None and entry[0] == rec.solved_epoch
        return "hit" if fresh and rec.staleness == 0 else "miss"

    def _query(self):
        return self._fleet.frontier.ranking(self.tenant_id)
