"""prepare_s (s): the seconds of the program's ``engine.prepare`` spans,
the engine's build from a graph and its rates (operators and formats; the
graph's own construction is not in it). The set-up runs with no tracer
live, so the reader takes the spans' sum from the program's
``psi_engine_prepare_seconds`` histogram, where each span's seconds go:
in a cell that builds its engine once, the set-up's one build."""


def read(run):
    from repro_torch.obs import metrics
    family = metrics.get_registry().get("psi_engine_prepare_seconds")
    pooled = family.merged() if family is not None else None
    return pooled.sum if pooled is not None and pooled.count else None
