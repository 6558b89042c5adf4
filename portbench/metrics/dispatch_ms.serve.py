"""Mean duration of a serving dispatch over the traced stretch: the
program's ``serve.dispatch`` spans (``WarmGenerator._run_group``: the lock,
the model, the sampler, the decode and the copy to the host)."""

from yardstick.span_reads import mean_ms, traced_spans


def read(run, work):
    return mean_ms(traced_spans(work), "serve.dispatch")
