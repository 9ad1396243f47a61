"""Span-stream profiler: folded stacks, cost attribution, critical path.

Consumes the span records a :class:`repro_torch.obs.trace.Tracer` retains (or
wrote to JSONL) and turns the raw stream into three judgements:

* **Folded stacks** (:meth:`Profile.folded`) — classic flamegraph input:
  ``root;child;leaf  self_time`` lines, where self time is a span's wall
  minus its direct children's wall (clipped at zero; children running on
  other threads — the async workers — attribute to their own roots).
* **Cost attribution** (:meth:`Profile.hotspots`,
  :meth:`Profile.attribution`) — per-frame totals split into self wall,
  dispatch (host) vs sync (device wait) where the span recorded a
  :meth:`Span.sync`, and per-backend/per-regime rollups keyed on the
  discriminating span attr (``engine.run{backend}``, ``fleet.solve
  {spec,regime}``, ``query{op}``).
* **Critical path** (:meth:`Profile.critical_path`) — for the async
  chunk pipeline: walk back from the last-finishing ``async.step``
  through its latest-finishing predecessor (the step it plausibly waited
  on) and report which chunk chain bounds wall-clock, so a low
  ``overlap_efficiency`` names the culprit instead of just scoring it.

Everything is stdlib-only and runs offline: records in, dicts out.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Iterable, Optional

__all__ = ["Profile", "CriticalPath"]

#: attrs that discriminate otherwise-identical frames, in priority order
_FRAME_ATTRS = ("backend", "spec", "op", "chunk")


def _frame(rec: dict) -> str:
    """Display name for one span: ``name`` plus its discriminating attr."""
    attrs = rec.get("attrs") or {}
    for key in _FRAME_ATTRS:
        if key in attrs:
            return f"{rec['name']}[{key}={attrs[key]}]"
    return rec["name"]


@dataclasses.dataclass
class CriticalPath:
    """The chain of ``async.step`` spans bounding wall-clock."""
    steps: list              # span records, execution order
    length_s: float          # sum of step walls along the path
    wall_s: float            # first-start → last-end over ALL steps
    chunk_share: dict        # chunk id -> seconds of path time

    @property
    def coverage(self) -> float:
        """path length / wall — 1.0 means zero overlap hid the path."""
        return self.length_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bounding_chunk(self) -> Optional[int]:
        """The chunk contributing the most critical-path seconds."""
        if not self.chunk_share:
            return None
        return max(self.chunk_share, key=self.chunk_share.get)

    def describe(self) -> str:
        if not self.steps:
            return "critical path: no async.step spans recorded"
        share = ", ".join(
            f"chunk {k}: {v:.4f}s ({v / self.length_s:.0%})"
            for k, v in sorted(self.chunk_share.items(),
                               key=lambda kv: -kv[1]))
        return (f"critical path: {len(self.steps)} steps, "
                f"{self.length_s:.4f}s of {self.wall_s:.4f}s wall "
                f"({self.coverage:.0%}); bounds: {share}")


class Profile:
    """Aggregated view over a finished span stream."""

    def __init__(self, records: Iterable[dict]):
        self.records = [r for r in records
                        if "dur" in r and "ts" in r]
        self._by_id = {r["id"]: r for r in self.records if "id" in r}
        # direct-children wall per parent id, same-thread only (cross-
        # thread "children" run concurrently and own their time)
        child_wall: dict = defaultdict(float)
        for r in self.records:
            p = r.get("parent")
            if p is not None and p in self._by_id \
                    and self._by_id[p].get("thread") == r.get("thread"):
                child_wall[p] += r["dur"]
        self._self_s = {
            r["id"]: max(0.0, r["dur"] - child_wall.get(r["id"], 0.0))
            for r in self.records if "id" in r}

    # -- constructors --------------------------------------------------- #
    @classmethod
    def from_tracer(cls, tracer) -> "Profile":
        return cls(list(getattr(tracer, "spans", ())))

    @classmethod
    def from_jsonl(cls, path: str) -> "Profile":
        with open(path) as f:
            return cls(json.loads(ln) for ln in f if ln.strip())

    # -- folded stacks --------------------------------------------------- #
    def _stack_of(self, rec: dict) -> str:
        frames = [_frame(rec)]
        seen = {rec.get("id")}
        p = rec.get("parent")
        while p is not None and p in self._by_id and p not in seen:
            seen.add(p)
            parent = self._by_id[p]
            frames.append(_frame(parent))
            p = parent.get("parent")
        return ";".join(reversed(frames))

    def folded(self) -> dict:
        """``stack -> self seconds`` over every span (flamegraph input)."""
        out: dict = defaultdict(float)
        for r in self.records:
            if "id" not in r:
                continue
            out[self._stack_of(r)] += self._self_s[r["id"]]
        return dict(out)

    def write_folded(self, path: str) -> str:
        """Write ``stack  microseconds`` lines (flamegraph.pl format)."""
        with open(path, "w") as f:
            for stack, secs in sorted(self.folded().items(),
                                      key=lambda kv: -kv[1]):
                f.write(f"{stack} {max(1, round(secs * 1e6))}\n")
        return path

    # -- hotspots / attribution ------------------------------------------ #
    def hotspots(self, n: int = 10) -> list[dict]:
        """Top-``n`` frames by self time, with the dispatch/sync split."""
        agg: dict = {}
        for r in self.records:
            key = _frame(r)
            a = agg.setdefault(key, dict(
                frame=key, count=0, total_s=0.0, self_s=0.0,
                dispatch_s=0.0, sync_s=0.0))
            a["count"] += 1
            a["total_s"] += r["dur"]
            a["self_s"] += self._self_s.get(r.get("id"), r["dur"])
            if "dispatch_s" in r:
                a["dispatch_s"] += r["dispatch_s"]
                a["sync_s"] += r["sync_s"]
        ranked = sorted(agg.values(), key=lambda a: -a["self_s"])
        for a in ranked:
            for k in ("total_s", "self_s", "dispatch_s", "sync_s"):
                a[k] = round(a[k], 6)
        return ranked[:n]

    def attribution(self) -> dict:
        """Wall per backend/spec/op attr value — where the seconds go
        across engines, fleet buckets, and query ops."""
        out: dict = {}
        for r in self.records:
            attrs = r.get("attrs") or {}
            for key in ("backend", "spec", "op"):
                if key in attrs:
                    bucket = out.setdefault(key, defaultdict(float))
                    bucket[str(attrs[key])] += r["dur"]
                    break
        return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
                for k, v in out.items()}

    # -- critical path ---------------------------------------------------#
    def critical_path(self, name: str = "async.step") -> CriticalPath:
        """Walk the async chunk pipeline back from the last-finishing
        step through latest-finishing predecessors."""
        steps = [r for r in self.records if r["name"] == name]
        if not steps:
            return CriticalPath([], 0.0, 0.0, {})
        end = lambda r: r["ts"] + r["dur"]                     # noqa: E731
        wall = max(end(r) for r in steps) - min(r["ts"] for r in steps)
        by_end = sorted(steps, key=end)
        path = [by_end[-1]]
        eps = 1e-9
        while True:
            cur = path[-1]
            pred = None
            for r in reversed(by_end):       # latest end first
                if r is cur:
                    continue
                if end(r) <= cur["ts"] + eps:
                    pred = r
                    break
            if pred is None:
                break
            path.append(pred)
        path.reverse()
        share: dict = defaultdict(float)
        for r in path:
            chunk = (r.get("attrs") or {}).get("chunk", -1)
            share[chunk] += r["dur"]
        return CriticalPath(path, sum(r["dur"] for r in path),
                            wall, dict(share))

    # -- one-call export -------------------------------------------------#
    def to_json(self, top: int = 10) -> dict:
        cp = self.critical_path()
        return dict(
            spans=len(self.records),
            hotspots=self.hotspots(top),
            attribution=self.attribution(),
            critical_path=None if not cp.steps else dict(
                steps=len(cp.steps), length_s=round(cp.length_s, 6),
                wall_s=round(cp.wall_s, 6),
                coverage=round(cp.coverage, 4),
                bounding_chunk=cp.bounding_chunk,
                chunk_share={str(k): round(v, 6)
                             for k, v in cp.chunk_share.items()}))
