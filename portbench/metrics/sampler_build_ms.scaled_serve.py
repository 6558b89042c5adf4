"""Milliseconds of the card's stream that a serving dispatch's sampler
model build spans over the traced stretch: the mean ``device_ms`` of the
program's ``sampler.build`` spans (a CUDA event pair around
``SampleFns.build_sampler_model`` inside ``sample_fn``: permute, quantize,
pack), one a dispatch; the pair holds the build's kernels and the gaps its
host work leaves between them.  None where the program has no such span."""

import numpy as np

from yardstick.span_reads import named, traced_spans


def read(run, work):
    times = [s["device_ms"] for s in named(traced_spans(work), "sampler.build")
             if s["device_ms"] is not None]
    return float(np.mean(times)) if times else None
