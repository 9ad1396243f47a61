"""decode_idle_pct (%): in the decode cell, the share of the profiled half
of a traced window in which no operation ran on the device: the same
reading as ``device_idle_pct`` (the union of the kernels', copies' and
sets' intervals under ``torch.profiler``), reported for the turns of
decode steps."""
from gpubench.metrics.device_idle_pct import read  # noqa: F401
