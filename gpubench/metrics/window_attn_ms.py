"""window_attn_ms (ms): the window-attention layers' share of a decode step:
per ``lm.decode_step`` span, the sum of the ``lm.attn.window`` spans inside
it (each layer's attention sub-layer, synced on its output while a tracer
is live); the median over the steps of the first half of a traced
window."""


def read(run):
    from gpubench.lmspans import per_step_ms
    return per_step_ms(run, "lm.attn.window")
