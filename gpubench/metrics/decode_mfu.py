"""decode_mfu (%): each request's model FLOPs (the entry's ``work_bytes``
``request_flops``: projections, the dense FFN, routers, head, the held
experts' expected evaluations and attention over each context) over the
requests' wall time at the card's dense bf16 peak, summed over the first
half of a traced window."""


def read(run):
    if not run.peaks or not run.latencies or "request_flops" not in run.work:
        return None
    least = len(run.latencies) * run.work["request_flops"] / \
        run.peaks["bf16_flops"]
    return least / sum(run.latencies) * 100.0
