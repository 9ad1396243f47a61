"""engine_run_ms (ms): the median of the program's ``engine.run`` spans (the
solo engine's solve loop and ψ epilogue; the span waits for the result's
stream while a tracer is live), in the first half of a traced window."""
import statistics


def read(run):
    spans = [s["dur"] for s in run.program_spans if s["name"] == "engine.run"]
    return statistics.median(spans) * 1e3 if spans else None
