"""full_attn_roofline (%): the device time of the full layers' decode
attention (``decode_attn_kernel``, one launch a full layer a step, and its
merge, every op named ``decode_attn``) against the least time its bytes
take at the card's HBM bandwidth: launches × the program's gauge
``lm_decode_attn_least_bytes`` (one launch's live keys and values, queries
and output, set by the decode step while a tracer is live), from the
profiled half of a traced window; nothing where the program has no such
gauge or kernel."""


def read(run):
    from repro_torch.obs import metrics
    family = metrics.get_registry().get("lm_decode_attn_least_bytes")
    if family is None or run.trace is None or not run.peaks:
        return None
    launches = run.trace.kernel_seconds("decode_attn_kernel")[1]
    seconds = run.trace.kernel_seconds("decode_attn")[0]
    if launches == 0 or seconds <= 0:
        return None
    least = launches * family.value / run.peaks["hbm_bytes_per_s"]
    return least / seconds * 100.0
