"""rank_p95_ms (ms, host clock): the 95th percentile of every completed
request's latency in the window, from issue to the read on the host
(numpy's linear interpolation between order statistics)."""
import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
