"""Mean time from one ``serve.dispatch`` span's end to the next one's start
over the traced stretch: no serving work is queued on the card then (the
coalescer's window, the leader's hand-off and the drain)."""

from yardstick.span_reads import mean_gap_ms, traced_spans


def read(run, work):
    return mean_gap_ms(traced_spans(work), "serve.dispatch")
