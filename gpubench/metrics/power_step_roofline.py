"""power_step_roofline (%): the device time of the fused step kernel
(``power_step_kernel``, one launch a step) against the least time its bytes
take at the card's HBM bandwidth (``gpubench/roofline.py``: the inputs'
sizes), from the profiled half of a traced window."""


def read(run):
    if run.trace is None or not run.peaks:
        return None
    seconds, launches = run.trace.kernel_seconds("power_step_kernel")
    if launches == 0 or seconds <= 0:
        return None
    least = launches * run.work["step"] / run.peaks["hbm_bytes_per_s"]
    return least / seconds * 100.0
