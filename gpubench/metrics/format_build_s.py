"""format_build_s (s): the seconds of the program's ``format.build`` spans,
the cuda engine's format built on the host and copied to the card (a part
of ``prepare_s``). The set-up runs with no tracer live, so the reader takes
the spans' sum from the program's ``psi_format_build_seconds`` histogram,
where each span's seconds go: in a cell whose requests patch no edge, the
set-up's one build."""


def read(run):
    from repro_torch.obs import metrics
    family = metrics.get_registry().get("psi_format_build_seconds")
    pooled = family.merged() if family is not None else None
    return pooled.sum if pooled is not None and pooled.count else None
