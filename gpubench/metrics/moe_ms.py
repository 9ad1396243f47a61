"""moe_ms (ms): the routed layers' share of a decode step: per
``lm.decode_step`` span, the sum of the ``lm.moe`` spans inside it (a
routed FFN: router, dispatch, the held experts, combine; synced on its
output while a tracer is live); the median over the steps of the first
half of a traced window."""


def read(run):
    from gpubench.lmspans import per_step_ms
    return per_step_ms(run, "lm.moe")
