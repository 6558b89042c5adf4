"""Device milliseconds a training step spends in the program's
``train.forward`` spans over the traced stretch (zero_grad, the DVAE
forward, the MSE and the MMD): the CUDA event pair around each span, summed,
over the stretch's ``train.step`` spans."""

from yardstick.span_reads import device_ms_a_step, traced_spans


def read(run, work):
    return device_ms_a_step(traced_spans(work), "train.forward")
