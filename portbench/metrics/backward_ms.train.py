"""Device milliseconds a training step spends in the program's
``train.backward`` spans over the traced stretch (the backward pass, and the
gradient sum on a data axis): the CUDA event pair around each span, summed,
over the stretch's ``train.step`` spans."""

from yardstick.span_reads import device_ms_a_step, traced_spans


def read(run, work):
    return device_ms_a_step(traced_spans(work), "train.backward")
