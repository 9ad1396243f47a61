"""rank_ms (ms, host clock): the window's wall time over the requests
completed in it, so a stall between requests counts."""


def read(run):
    if not run.latencies:
        return None
    return run.window_s / len(run.latencies) * 1e3
