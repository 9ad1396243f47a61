"""Per-step sums of the LM decode path's program spans, for the metric
readers: a decode step is an ``lm.decode_step`` span, and a layer's span
inside it names that step as its parent."""
from __future__ import annotations

import statistics

__all__ = ["per_step_ms"]


def per_step_ms(run, name: str) -> float | None:
    """The median over the window's decode steps of the seconds of the
    ``name`` spans inside each step, in ms; None without such spans."""
    steps = {s["id"]: 0.0 for s in run.program_spans
             if s["name"] == "lm.decode_step"}
    found = False
    for s in run.program_spans:
        if s["name"] == name and s.get("parent") in steps:
            steps[s["parent"]] += s["dur"]
            found = True
    return statistics.median(steps.values()) * 1e3 if found else None
