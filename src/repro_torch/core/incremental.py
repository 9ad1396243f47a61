"""Incremental ψ-score serving runtime — backend-pluggable, delta-rebuilt.

The Alg. 2 iteration is an affine contraction (ρ(A) < 1), so after a graph or
activity update the fixed point moves continuously; restarting the power
iteration from the previous s* instead of c needs only
O(log(‖Δs*‖/ε) / log(1/ρ)) iterations — typically a handful for small updates.

:class:`PsiService` is built on :class:`~repro_torch.core.engine.PsiEngine`:
any registered backend serves queries, every backend warm-starts from the
previous fixed point, and mutations go through the engines' O(Δ) delta hooks
instead of a full operator rebuild. :class:`RankingCache` is the batched
query layer: the descending order is computed once per fixed point and
memoized until the next mutation.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from ..graphs.structure import Graph
from ..kernels.autotune import choose_solver
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .activity import Activity
from .engine import PsiEngine, make_engine
from .operators import _validate_rates
from .power_psi import PsiResult

__all__ = ["PsiService", "RankingCache", "RankedQueries"]


class RankingCache:
    """Batched query layer over one ψ fixed point.

    Memoizes the descending sort (one ``argsort`` per fixed point, not per
    query); ``top_k`` uses ``torch.topk`` on the device-resident ψ so a
    small k never round-trips through a host sort.

    ``err_bound`` is the solve's certified per-node ``|ψ_exact − ψ|``
    bound when the engine produced one
    (:meth:`~repro_torch.core.engine.PsiEngine.psi_error_bound`); it powers
    :meth:`top_k_certified` — rank-stability statements about the *exact*
    scores, served from the approximate ones.
    """

    def __init__(self, psi: torch.Tensor, *, err_bound: float | None = None):
        self._psi_dev = psi
        with obs_trace.hot_span("ranking.copy"):
            self._psi = psi.detach().cpu().numpy()
        self.err_bound = err_bound
        self._order: np.ndarray | None = None
        self._rank: np.ndarray | None = None

    @property
    def psi(self) -> np.ndarray:
        return self._psi

    def scores_batch(self, users: np.ndarray) -> np.ndarray:
        return self._psi[np.asarray(users)]

    def top_k(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        k = min(int(k), self._psi.size)           # clip like argsort[:k]
        if self._order is not None:               # sort already paid for
            idx = self._order[:k]
            return idx, self._psi[idx]
        vals, idx = torch.topk(self._psi_dev, k)
        return idx.cpu().numpy(), vals.cpu().numpy()

    def rank_of(self, users: np.ndarray) -> np.ndarray:
        self._ensure_order()
        return self._rank[np.asarray(users)]

    def top_k_certified(self, k: int):
        """:class:`~repro_torch.localpush.topk.TopKCertificate` for the
        served ψ.

        ``certified`` is True only when the cache carries an error bound
        and the k/k+1 margin clears it — i.e. the returned *set* provably
        equals the exact top-k. Without a bound (non-certifying backends)
        the indices are still served, honestly marked uncertified.
        """
        from ..localpush.topk import certify_top_k
        bound = self.err_bound
        if bound is not None and self._psi.dtype != np.float64:
            # the certificate covers the solver's float64 ψ; a lower-precision
            # served copy adds one cast rounding per node on top of it
            bound = float(bound) + float(np.finfo(self._psi.dtype).eps) \
                * float(np.abs(self._psi).max(initial=0.0))
        return certify_top_k(self._psi, k, bound)

    def _ensure_order(self) -> None:
        if self._order is None:
            self._order = np.argsort(-self._psi, kind="stable")
            rank = np.empty_like(self._order)
            rank[self._order] = np.arange(self._order.size)
            self._rank = rank


class RankedQueries:
    """Read-side ψ-query surface over an abstract ``_query()``.

    Subclasses provide ``_query() -> RankingCache`` (fresh for the current
    fixed point); the mixin supplies the canonical reads so a dedicated
    :class:`PsiService` and a fleet lane
    (:class:`repro_torch.serving.fleet.TenantView`) are interchangeable at
    every query site. Every read goes through :meth:`_read`, the funnel
    that times it on the host and counts its cache outcome.
    """

    def _query(self) -> RankingCache:
        raise NotImplementedError

    def _obs_cache_state(self) -> str:
        """'hit' when this read will be served from a memoized ranking,
        'miss' when it must (re)build one. Overridable by subclasses whose
        cache lives elsewhere (the fleet's per-lane views)."""
        return "hit" if getattr(self, "_cache", None) is not None else "miss"

    def _read(self, op: str, fn):
        """Every public read funnels through here: latency histogram
        (``psi_query_seconds{op=}``), cache hit ratio, staleness-at-read
        counter, and a ``query`` span — all skipped in one branch when the
        telemetry plane is dark. The funnel only reads host clocks and
        counters: it adds no device sync of its own (a read that builds a
        ranking copies ψ to the host, with or without it)."""
        reg = obs_metrics.get_registry()
        if getattr(reg, "null", False) and not obs_trace.get_tracer().enabled:
            return fn(self._query())
        state = self._obs_cache_state()
        stale = bool(getattr(self, "stale", False))
        with obs_trace.span("query", op=op, cache=state) as sp:
            out = fn(self._query())
        # remembered for explain(): the facts of the most recent read
        self._last_read = dict(op=op, cache=state, stale=stale,
                               seconds=sp.duration_s)
        reg.histogram("psi_query_seconds",
                      "read-side ψ query latency (seconds)",
                      labelnames=("op",)).labels(op=op).observe(sp.duration_s)
        reg.counter("psi_query_cache_total",
                    "ranking-cache outcome at read time",
                    labelnames=("result",)).labels(result=state).inc()
        if stale:
            reg.counter("psi_query_stale_reads_total",
                        "reads served from a fixed point with deferred "
                        "patches pending").inc()
        return out

    def scores(self) -> np.ndarray:
        return self._read("scores", lambda c: c.psi)

    def scores_batch(self, users: np.ndarray) -> np.ndarray:
        """ψ for a batch of users (no ranking sort paid)."""
        return self._read("scores_batch", lambda c: c.scores_batch(users))

    def top_k(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        return self._read("top_k", lambda c: c.top_k(k))

    def top_k_certified(self, k: int):
        """Top-k plus its rank-stability certificate (see
        :meth:`RankingCache.top_k_certified`)."""
        return self._read("top_k_certified", lambda c: c.top_k_certified(k))

    def rank_of(self, users: np.ndarray) -> np.ndarray:
        return self._read("rank_of", lambda c: c.rank_of(users))

    def explain(self, *, op: str | None = None) -> str:
        """EXPLAIN-ANALYZE tree for the last resolve + query.

        Assembles the decision trail recorded by the planner stack
        (:mod:`repro_torch.obs.explain`) — plan candidates, prunes, cache
        state, predicted vs measured cost, calibration factors — together
        with the owning resolve's convergence record, the last read's
        funnel facts (op, cache, staleness, wall time), and the served
        certificate bound. Pure read: rendering never touches the engine
        state or the device.
        """
        from ..obs import calibrate as obs_calibrate
        from ..obs import convergence as obs_convergence
        from ..obs import explain as obs_explain
        g = getattr(self, "graph", None)
        decisions = obs_explain.decisions_for(
            n=getattr(g, "n", None), m=getattr(g, "m", None))
        tenant = getattr(self, "tenant_id", None)
        tracker = obs_convergence.get_tracker()
        series = tracker.series(tenant) or (
            tracker.series(None) if tenant is not None else [])
        resolve = series[-1] if series else None
        query = dict(getattr(self, "_last_read", None) or {})
        if op is not None:
            query["op"] = op
        cache = getattr(self, "_cache", None)
        if cache is not None and cache.err_bound is not None:
            query.setdefault("err_bound", f"{cache.err_bound:.3g}")
        query.setdefault("stale", bool(getattr(self, "stale", False)))
        store = obs_calibrate.get_store()
        # the port keys calibration samples by the engine's device and
        # dtype; a fleet view owns no engine
        eng = getattr(self, "engine", None)
        extra = (dict(calibration_env=(None if eng is None else
                                       obs_calibrate.env_key(eng.device,
                                                             eng.dtype)),
                      calibration_samples=len(store),
                      calibration_generation=store.generation)
                 if len(store) else None)
        backend = getattr(self, "backend", "?")
        return obs_explain.explain_tree(
            header=f"EXPLAIN ANALYZE — power-ψ [backend={backend}]",
            resolve=resolve, decisions=decisions, query=query or None,
            extra=extra)


class PsiService(RankedQueries):
    """Maintains ψ-scores for a mutable (graph, activity) pair.

    Args:
      graph, activity: the initial platform state.
      tol / max_iter: shared convergence criterion for every (re)solve.
      backend: engine name — ``reference`` (default), ``cuda`` (alias
        ``pallas``), ``auto``, ``accelerated`` or ``push`` (certified
        top-k reads); see :func:`repro_torch.core.engine.make_engine`.
      accelerate: opt the chosen backend into the Aitken-extrapolated loop;
        ``accelerated`` implies it.
      check_every: gap-evaluation cadence of the solver loop; 1 keeps the
        per-iteration check.
      dtype: working float type (float32 by default).
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
      engine_opts: extra backend kwargs (``regime=...``, ``tile=...``,
        ``microbench=...``).
    """

    def __init__(self, graph: Graph, activity: Activity, *, tol: float = 1e-8,
                 max_iter: int = 10_000, backend: str = "reference",
                 accelerate: bool = False, check_every: int = 1,
                 dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 engine_opts: dict | None = None):
        self.tol = tol
        self.max_iter = max_iter
        opts = dict(engine_opts or {})
        if accelerate:
            opts.setdefault("accelerate", True)
        if check_every != 1:
            opts.setdefault("check_every", check_every)
        self._engine: PsiEngine = make_engine(
            backend, graph=graph, activity=activity,
            dtype=dtype or torch.float32, device=device, **opts)
        self._last: PsiResult | None = None
        self._cache: RankingCache | None = None
        self._pending = False            # deferred patches awaiting resolve
        self._dirty = 0                  # patched rows/edges since last solve
        self._early = False              # last solve stopped at a top-k cert

    @classmethod
    def from_fleet(cls, fleet, tenant_id: str):
        """A single-tenant serving view over a fleet lane: a
        :class:`~repro_torch.serving.fleet.TenantView`, the same query and
        mutation surface as a ``PsiService`` but solved inside the fleet's
        lane-batched loop (so one device amortizes across tenants)."""
        return fleet.view(tenant_id)

    # -- queries -------------------------------------------------------- #
    @property
    def backend(self) -> str:
        return self._engine.name

    @property
    def engine(self) -> PsiEngine:
        return self._engine

    @property
    def graph(self) -> Graph:
        return self._engine.graph

    def last_iterations(self) -> int:
        self._query()
        return int(self._last.iterations)

    @property
    def last_result(self) -> PsiResult | None:
        """The most recent solve's :class:`PsiResult` (None before the
        first solve); does not trigger a solve."""
        return self._last

    # -- mutations (each warm-starts from the previous s*) --------------- #
    # ``resolve=False`` defers the warm re-solve: patches accumulate at the
    # engine level and the *stale* RankingCache keeps serving until
    # :meth:`resolve`. An empty delta is a true no-op.
    def update_activity(self, users: np.ndarray, lam: np.ndarray | None = None,
                        mu: np.ndarray | None = None, *,
                        resolve: bool = True) -> None:
        users = np.asarray(users).reshape(-1)
        if users.size == 0:
            return
        # reject NaN/Inf/negative rates before any engine is touched, so a
        # rejected patch leaves the service serving its current fixed point
        _validate_rates(lam, mu)
        if not self._engine.patch_activity(users, lam=lam, mu=mu):
            self._full_rebuild(activity=self._patched_activity(users, lam, mu))
        self._pending = True
        self._dirty += int(users.size)
        if resolve:
            self._resolve()

    def add_edges(self, src: np.ndarray, dst: np.ndarray, *,
                  resolve: bool = True) -> None:
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        if src.size == 0:
            return
        if not self._engine.patch_edges(src, dst):
            g = self._engine.graph
            merged = Graph(
                g.n, np.concatenate([g.src, src]),
                np.concatenate([g.dst, dst]),
                name=g.name).dedup()
            self._full_rebuild(graph=merged)
        self._pending = True
        self._dirty += int(src.size)
        if resolve:
            self._resolve()

    def remove_edges(self, src: np.ndarray, dst: np.ndarray, *,
                     resolve: bool = True) -> None:
        """Delete follow edges (unfollow tombstones); pairs not present are
        ignored. Backends without an incremental shrink hook re-``prepare``
        from the filtered graph (warm start still carries over)."""
        src = np.asarray(src, np.int32).reshape(-1)
        dst = np.asarray(dst, np.int32).reshape(-1)
        if src.size == 0:
            return
        if not self._engine.unpatch_edges(src, dst):
            g = self._engine.graph
            keep = ~np.isin(g.src.astype(np.int64) * g.n + g.dst,
                            src.astype(np.int64) * g.n + dst)
            self._full_rebuild(graph=Graph(g.n, g.src[keep], g.dst[keep],
                                           name=g.name))
        self._pending = True
        self._dirty += int(src.size)
        if resolve:
            self._resolve()

    @property
    def stale(self) -> bool:
        """True when deferred patches have not been re-solved yet (queries
        then serve the previous fixed point's ranking)."""
        return self._pending

    def resolve(self) -> None:
        """Warm re-solve to the full tolerance if any deferred patch is
        pending, nothing was solved yet, or the last solve stopped early at
        a top-k certificate (query-driven resolution leaves scores only
        err_bound-accurate; ``resolve`` restores the global contract)."""
        if self._pending or self._last is None or self._early:
            self._resolve()

    def top_k_certified(self, k: int):
        """Certified top-k, resolved only as far as the query demands.

        With a pending delta and a backend that exposes ``run_top_k`` (the
        ``push`` engine), the warm re-solve stops at rank separation
        instead of the global tolerance — the certified *set* is exact
        while the edge-work stays proportional to the dirty region and the
        requested k. Other backends (or a fresh state) fall through to the
        cache path, which certifies against the engine's
        :meth:`~repro_torch.core.engine.PsiEngine.psi_error_bound`.
        """
        if ((self._pending or self._last is None)
                and hasattr(self._engine, "run_top_k")):
            self._plan_query(k)
            with obs_trace.span("query", op="top_k_certified",
                                cache="early_stop") as sp:
                prev_s = None if self._last is None else self._last.s
                self._last, cert = self._engine.run_top_k(
                    k, tol=self.tol, max_iter=self.max_iter, s0=prev_s)
                self._cache = RankingCache(
                    self._last.psi, err_bound=self._engine.psi_error_bound())
                self._pending = False
                self._dirty = 0
                self._early = not bool(self._last.converged)
            obs_metrics.histogram(
                "psi_query_seconds", "read-side ψ query latency (seconds)",
                labelnames=("op",)) \
                .labels(op="top_k_certified").observe(sp.duration_s)
            return cert
        return RankedQueries.top_k_certified(self, k)

    # -- internals ------------------------------------------------------ #
    def _plan_query(self, k: int | None) -> None:
        """Record the push-vs-global solver plan for a query.

        Advisory: the engine already committed to its backend, so the
        :func:`~repro_torch.kernels.autotune.choose_solver` verdict only
        lands in the decision log (:mod:`repro_torch.obs.explain`) — what
        the planner *would* pick from the dirty fraction and k. Pure host
        arithmetic over counts the service already tracks: no device work
        and no behaviour change.
        """
        host = self._engine.host
        if host is None or host.n <= 0:
            return
        k = host.n if k is None else max(int(k), 1)  # full resolve ≡ k=n
        choose_solver(types.SimpleNamespace(n=host.n, m=host.m),
                      dirty_frac=min(1.0, self._dirty / host.n),
                      k_frac=min(1.0, k / host.n))

    def _patched_activity(self, users, lam, mu) -> Activity:
        act = self._engine.activity
        new_lam, new_mu = act.lam.copy(), act.mu.copy()
        if lam is not None:
            new_lam[np.asarray(users)] = lam
        if mu is not None:
            new_mu[np.asarray(users)] = mu
        return Activity(new_lam, new_mu)

    def _full_rebuild(self, graph: Graph | None = None,
                      activity: Activity | None = None) -> None:
        self._engine.prepare(graph or self._engine.graph,
                             activity or self._engine.activity)

    def _resolve(self) -> None:
        self._plan_query(None)                    # log the solver verdict
        prev_s = None if self._last is None else self._last.s
        self._last = self._engine.run(tol=self.tol, max_iter=self.max_iter,
                                      s0=prev_s)
        self._cache = None                        # ranking invalidated
        self._pending = False
        self._dirty = 0
        self._early = False

    def _query(self) -> RankingCache:
        if self._last is None:
            self._last = self._engine.run(tol=self.tol,
                                          max_iter=self.max_iter)
            self._cache = None
        if self._cache is None:
            self._cache = RankingCache(
                self._last.psi, err_bound=self._engine.psi_error_bound())
        return self._cache
