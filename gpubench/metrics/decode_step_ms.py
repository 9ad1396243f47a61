"""decode_step_ms (ms): the median of the program's ``lm.decode_step``
spans (one decode step of every session; the span waits for the step's
logits while a tracer is live), in the first half of a traced window."""
import statistics


def read(run):
    spans = [s["dur"] for s in run.program_spans
             if s["name"] == "lm.decode_step"]
    return statistics.median(spans) * 1e3 if spans else None
