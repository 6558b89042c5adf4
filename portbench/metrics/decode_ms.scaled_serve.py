"""Mean host duration of a serving dispatch's decode over the traced
stretch: the program's ``serve.decode`` spans (``DVAE.decode`` through the
127M-parameter layer, the clamp and the quantisation to uint8)."""

from yardstick.span_reads import mean_ms, traced_spans


def read(run, work):
    return mean_ms(traced_spans(work), "serve.decode")
