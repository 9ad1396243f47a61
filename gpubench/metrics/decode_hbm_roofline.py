"""decode_hbm_roofline (%): each request's least bytes (the entry's
``work_bytes``: a turn's weights, each session's full-layer keys and
values at its true context, the window rings, the new keys and values,
from the configuration and the histories) at the card's HBM bandwidth,
over the requests' wall time, summed over the first half of a traced
window."""


def read(run):
    if not run.peaks or not run.latencies or "request" not in run.work:
        return None
    least = len(run.latencies) * run.work["request"] / \
        run.peaks["hbm_bytes_per_s"]
    return least / sum(run.latencies) * 100.0
