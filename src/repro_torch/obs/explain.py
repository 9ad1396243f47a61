"""Decision observability: EXPLAIN ANALYZE for the planner stack.

The repo picks its computation in several otherwise-hidden places — the
``plan_regime``/``plan_for_bucket`` HBM-bytes cost model, ``choose_solver``'s
push-vs-sweep planner, the fleet's per-bucket regime rule, and the push
backend's certified early stop.  The PR 8/9 telemetry plane records the
*outcome* of a resolve; this module records the *decision trail*: every
planner call appends a structured :class:`DecisionRecord` — the full
candidate table (modeled cost, measured µs, calibrated µs), the pruned
candidates with their prune reason, the plan-cache state, the inputs the
decision was made from, and the calibration factors consumed — linked to
the innermost open :class:`~repro.obs.convergence.ResolveRecord` when one
exists.  ``PsiService.explain()`` and ``serve --explain`` render the trail
as an EXPLAIN-ANALYZE tree.

Recording is telemetry: :func:`repro.obs.disable` swaps the log for its
null twin and the planner behaves identically either way (the records are
pure reads of values the planner already holds on the host).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from . import convergence as _convergence
from . import metrics as _metrics

__all__ = ["Candidate", "Pruned", "DecisionRecord", "DecisionLog",
           "NULL_DECISIONS", "get_log", "set_log", "record_decision",
           "decisions_for", "format_cost", "render_decision",
           "explain_tree"]

KINDS = ("regime_plan", "bucket_plan", "bucket_regime", "solver_choice",
         "early_stop")


@dataclasses.dataclass
class Candidate:
    """One alternative the planner considered."""

    name: str                       # e.g. "edge_tile(tile=256,e1=8,e2=128)"
    est: float | None = None        # modeled cost (unit below)
    unit: str = "bytes"             # "bytes" | "edges" | ""
    measured_us: float = 0.0        # microbench result (0 = not timed)
    calibrated_us: float | None = None
    chosen: bool = False
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        out = dict(name=self.name, chosen=self.chosen)
        if self.est is not None:
            out["est"] = self.est
            out["unit"] = self.unit
        if self.measured_us:
            out["measured_us"] = self.measured_us
        if self.calibrated_us is not None:
            out["calibrated_us"] = self.calibrated_us
        if self.detail:
            out["detail"] = self.detail
        return out


@dataclasses.dataclass
class Pruned:
    """A candidate dropped before scoring, and why."""

    name: str
    reason: str                     # e.g. "BSR_MIN_OCCUPANCY"
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dict(name=self.name, reason=self.reason, detail=self.detail)


class DecisionRecord:
    """One planner decision: inputs, alternatives, prunes, the winner."""

    __slots__ = ("kind", "site", "wall_time", "inputs", "candidates",
                 "pruned", "cache", "chosen", "source", "calibration",
                 "resolve_index", "note")

    def __init__(self, kind: str, site: str, *, inputs: dict | None = None,
                 candidates=(), pruned=(), cache: str | None = None,
                 chosen: str = "", source: str | None = None,
                 calibration: dict | None = None, note: str = ""):
        self.kind = kind
        self.site = site
        self.wall_time = time.time()
        self.inputs = dict(inputs or {})
        self.candidates = list(candidates)
        self.pruned = list(pruned)
        self.cache = cache              # "hit" | "miss" | "bypass" | None
        self.chosen = chosen
        self.source = source            # "model"|"microbench"|"calibrated"
        self.calibration = calibration
        self.note = note
        rec = _convergence.current()
        self.resolve_index = rec.index if rec is not None else None

    def to_json(self) -> dict:
        out = dict(kind=self.kind, site=self.site, wall_time=self.wall_time,
                   inputs=self.inputs, chosen=self.chosen,
                   candidates=[c.to_json() for c in self.candidates],
                   pruned=[p.to_json() for p in self.pruned])
        for k in ("cache", "source", "calibration", "resolve_index"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.note:
            out["note"] = self.note
        return out


class DecisionLog:
    """Bounded process-wide ring of :class:`DecisionRecord`\\ s."""

    enabled = True

    def __init__(self, *, keep: int = 256):
        self._lock = threading.Lock()
        self._ring: deque[DecisionRecord] = deque(maxlen=int(keep))

    def record(self, rec: DecisionRecord) -> DecisionRecord:
        with self._lock:
            self._ring.append(rec)
        return rec

    def recent(self, n: int | None = None, *,
               kind: str | None = None) -> list[DecisionRecord]:
        with self._lock:
            recs = list(self._ring)
        if kind is not None:
            recs = [r for r in recs if r.kind == kind]
        return recs if n is None else recs[-n:]

    def last(self, *, kind: str | None = None) -> DecisionRecord | None:
        recs = self.recent(1, kind=kind)
        return recs[-1] if recs else None

    def to_json(self) -> list[dict]:
        return [r.to_json() for r in self.recent()]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class _NullDecisionLog:
    enabled = False

    def record(self, rec):
        return None

    def recent(self, n=None, *, kind=None):
        return []

    def last(self, *, kind=None):
        return None

    def to_json(self):
        return []

    def clear(self):
        pass

    def __len__(self):
        return 0


NULL_DECISIONS = _NullDecisionLog()
_LOG = DecisionLog()


def get_log():
    return _LOG


def set_log(log):
    """Install the process decision log (NULL_DECISIONS disables);
    returns the previous one."""
    global _LOG
    prev, _LOG = _LOG, log
    return prev


def record_decision(kind: str, site: str, **kw) -> DecisionRecord | None:
    """Build, count, and ring one decision (no-op when disabled)."""
    if not _LOG.enabled:
        return None
    rec = DecisionRecord(kind, site, **kw)
    _LOG.record(rec)
    _metrics.counter("psi_plan_decisions_total",
                     "planner decisions by kind",
                     labelnames=("kind",)).labels(kind=kind).inc()
    return rec


def decisions_for(*, n: int | None = None, m: int | None = None,
                  log: DecisionLog | None = None) -> list[DecisionRecord]:
    """The newest decision of each kind, preferring records whose inputs
    match the caller's graph shape ``(n, m)`` — the assembly step behind
    ``PsiService.explain``."""
    log = log or _LOG
    out = []
    for kind in KINDS:
        recs = log.recent(kind=kind)
        if not recs:
            continue
        match = [r for r in recs
                 if (n is None or r.inputs.get("n") in (None, n))
                 and (m is None or r.inputs.get("m") in (None, m))]
        out.append((match or recs)[-1])
    return out


# --------------------------------------------------------------------- #
# Rendering
# --------------------------------------------------------------------- #
def format_cost(value: float | None, unit: str) -> str:
    if value is None:
        return "-"
    if unit == "bytes":
        for thresh, suff in ((1 << 30, "GB"), (1 << 20, "MB"),
                             (1 << 10, "KB")):
            if value >= thresh:
                return f"{value / thresh:.2f}{suff}"
        return f"{value:.0f}B"
    if unit == "us":
        return f"{value / 1e3:.2f}ms" if value >= 1e3 else f"{value:.1f}µs"
    if unit == "edges":
        return f"{value:.3g} edges"
    return f"{value:.4g}{unit}"


def _candidate_line(c: Candidate, best_est: float | None) -> str:
    tag = "chosen" if c.chosen else "reject"
    parts = [f"{tag}  {c.name}"]
    if c.est is not None:
        parts.append(f"est={format_cost(c.est, c.unit)}")
        if (not c.chosen and best_est and c.unit in ("bytes", "edges")
                and c.est > 0):
            parts.append(f"(+{(c.est / best_est - 1.0) * 100:.0f}%)")
    if c.measured_us:
        parts.append(f"measured={format_cost(c.measured_us, 'us')}")
    if c.calibrated_us is not None:
        parts.append(f"calibrated={format_cost(c.calibrated_us, 'us')}")
    for k, v in c.detail.items():
        parts.append(f"{k}={v}")
    return "  ".join(parts)


def render_decision(rec: DecisionRecord) -> list[str]:
    """One decision as indented tree lines (no leading connectors)."""
    inputs = " ".join(f"{k}={v}" for k, v in rec.inputs.items())
    head = f"{rec.kind} via {rec.site}"
    if rec.cache:
        head += f" [PLAN_CACHE {rec.cache}]" if rec.kind in (
            "regime_plan", "bucket_plan") else f" [cache {rec.cache}]"
    if rec.source:
        head += f" source={rec.source}"
    if inputs:
        head += f"  ({inputs})"
    lines = [head]
    chosen = [c for c in rec.candidates if c.chosen]
    best = chosen[0].est if chosen and chosen[0].est else None
    for c in sorted(rec.candidates, key=lambda c: not c.chosen):
        lines.append("  " + _candidate_line(c, best))
    for p in rec.pruned:
        detail = "  ".join(f"{k}={v}" for k, v in p.detail.items())
        lines.append(f"  pruned  {p.name}  {p.reason}" +
                     (f"  {detail}" if detail else ""))
    if rec.calibration:
        factors = rec.calibration.get("factors", {})
        fstr = " ".join(
            f"{r}:{f['median']:.3g}×(±{f['mad']:.2g},n={f['count']})"
            for r, f in sorted(factors.items()))
        lines.append(f"  calibration env={rec.calibration.get('env')}  "
                     f"gen={rec.calibration.get('generation')}  {fstr}")
    if rec.note:
        lines.append(f"  note: {rec.note}")
    return lines


def _tree(blocks: list[list[str]]) -> list[str]:
    """Join rendered blocks with box-drawing connectors."""
    out = []
    for i, block in enumerate(blocks):
        last = i == len(blocks) - 1
        head, cont = ("└─ ", "   ") if last else ("├─ ", "│  ")
        for j, line in enumerate(block):
            out.append((head if j == 0 else cont) + line)
    return out


def explain_tree(*, header: str = "EXPLAIN ANALYZE — power-ψ resolve",
                 resolve=None, decisions=(), query: dict | None = None,
                 extra: dict | None = None) -> str:
    """Render the full decision trail for one resolve/query.

    ``resolve`` is a :class:`~repro.obs.convergence.ResolveRecord` (or
    ``None``); ``decisions`` an iterable of :class:`DecisionRecord`;
    ``query`` the last query-funnel facts (op, cache, staleness,
    err_bound, seconds).
    """
    blocks: list[list[str]] = []
    if resolve is not None:
        lines = [f"resolve #{resolve.index} backend={resolve.backend}"
                 + (f" tenant={resolve.tenant}"
                    if resolve.tenant is not None else "")]
        lines.append(f"  iterations={resolve.iterations} "
                     f"gap={resolve.gap:.3g} converged={resolve.converged} "
                     f"wall={resolve.duration_s * 1e3:.1f}ms")
        if resolve.psi_error_bound is not None:
            lines.append("  certified |ψ−ψ̂| ≤ "
                         f"{resolve.psi_error_bound:.3g}")
        if resolve.push:
            p = resolve.push
            lines.append(
                "  push rounds={rounds} edge_work={edge_work:.3g} "
                "touched_frac={touched_frac:.3g} certified={certified}"
                .format(rounds=p.get("rounds"),
                        edge_work=float(p.get("edge_work", 0.0)),
                        touched_frac=float(p.get("touched_frac", 0.0)),
                        certified=p.get("certified")))
        blocks.append(lines)
    for rec in decisions:
        blocks.append(render_decision(rec))
    if query:
        qline = "query"
        for k in ("op", "cache", "stale", "err_bound"):
            if query.get(k) is not None:
                qline += f" {k}={query[k]}"
        if query.get("seconds") is not None:
            qline += f" wall={query['seconds'] * 1e3:.2f}ms"
        blocks.append([qline])
    if extra:
        blocks.append([" ".join(f"{k}={v}" for k, v in extra.items())])
    if not blocks:
        blocks.append(["(no recorded decisions — run a resolve first)"])
    return "\n".join([header] + _tree(blocks))
