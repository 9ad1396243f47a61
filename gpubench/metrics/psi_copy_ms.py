"""psi_copy_ms (ms): the median of the program's ``ranking.copy`` spans,
the ranked read's copy of every user's ψ to the host (it waits for the
solve's epilogue), in the first half of a traced window."""
import statistics


def read(run):
    spans = [s["dur"] for s in run.program_spans
             if s["name"] == "ranking.copy"]
    return statistics.median(spans) * 1e3 if spans else None
