"""device_idle_pct (%): the share of the profiled half of a traced window in
which no operation ran on the device (``torch.profiler``: the union of the
kernels', copies' and sets' intervals)."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
