"""prefill_s (s): the seconds of the program's ``lm.prefill`` spans, each
session's history prefilled into its row of the cache, to its logits. The
set-up runs with no tracer live, so the reader takes the spans' sum from
the program's ``lm_prefill_seconds`` histogram, where each span's seconds
go: in the decode cell, the set-up's prefills."""


def read(run):
    from repro_torch.obs import metrics
    family = metrics.get_registry().get("lm_prefill_seconds")
    pooled = family.merged() if family is not None else None
    return pooled.sum if pooled is not None and pooled.count else None
