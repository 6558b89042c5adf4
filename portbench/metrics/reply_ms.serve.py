"""Mean duration of a reply's work in the client's thread over the traced
stretch: the program's ``serve.reply`` spans (uint8 to f32, sharpen, grid)."""

from yardstick.span_reads import mean_ms, traced_spans


def read(run, work):
    return mean_ms(traced_spans(work), "serve.reply")
