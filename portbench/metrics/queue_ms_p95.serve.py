"""95th percentile of a request's wait in the coalescer over the traced
stretch: the program's ``coalescer.queue`` records, from the request's place
in the queue to the start of the dispatch that serves it."""

from yardstick.span_reads import p95_ms, traced_spans


def read(run, work):
    return p95_ms(traced_spans(work), "coalescer.queue")
