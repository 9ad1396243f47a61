"""read_ms (ms): the median time of the ranked read of a request, the
harness's span around the read calls (the ranking cache's ψ copy and its
top-k), in the first, unprofiled half of a traced window."""
import statistics


def read(run):
    spans = [b - a for name, a, b in run.phases if name == "read"]
    return statistics.median(spans) * 1e3 if spans else None
