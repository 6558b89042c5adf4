"""Mean host duration of a serving dispatch's sampler call over the traced
stretch: the program's ``serve.sample`` spans (``SampleFns.sample_fn``
inside ``_serve_fn``: the sampler model's build and the sweeps' launch)."""

from yardstick.span_reads import mean_ms, traced_spans


def read(run, work):
    return mean_ms(traced_spans(work), "serve.sample")
