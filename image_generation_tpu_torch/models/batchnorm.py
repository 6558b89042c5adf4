"""BatchNorm with Flax's running-statistics convention.

The JAX models use ``flax.linen.BatchNorm(momentum=0.9)``: in training it
normalises with the batch statistics and updates the running averages as
``0.9·running + 0.1·batch`` with the *biased* batch variance, where
``torch.nn.BatchNorm2d`` would store the unbiased one.  ``batch_norm``
keeps the ``nn.BatchNorm2d`` module only for its parameters and buffers
(the reference's state-dict layout) and writes the training-mode
normalisation out by hand with Flax's formulas; evaluation uses the
running averages through ``F.batch_norm``.  It computes in f32 whatever
the input type, as the JAX models do.

Data-parallel training (``global_batch_stats``): each rank holds a slice of
the global batch, and the batch statistics are those of the global batch,
as GSPMD computes them in the JAX package: the slices' sums of x and x²
are summed over the mesh's data axis by a differentiable all-reduce, so
each rank's gradient also reaches the other slices' activations.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["batch_norm", "global_batch_stats", "MOMENTUM"]

MOMENTUM = 0.9  # Flax's: weight of the old running average
_GLOBAL = threading.local()  # this thread's (sum over the data axis, slices)


@contextmanager
def global_batch_stats(reduce_sum, n_slices: int):
    """Within the block, training-mode statistics are over the global
    batch: ``reduce_sum`` (differentiable) sums a tensor over the
    ``n_slices`` equal slices of the batch the ranks hold."""
    prev = getattr(_GLOBAL, "reduce", None)
    _GLOBAL.reduce = (reduce_sum, n_slices)
    try:
        yield
    finally:
        _GLOBAL.reduce = prev


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    """Normalise NCHW ``x`` with ``bn``'s affine parameters: batch
    statistics (and a running-average update) when ``train``, the running
    averages otherwise.  Returns f32."""
    x = x.float()
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    # Flax's statistics and normalisation, in its order of operations:
    # var = max(E[x²] − E[x]², 0), y = (x − mean)·(rsqrt(var + eps)·scale) + bias
    reduce = getattr(_GLOBAL, "reduce", None)
    if reduce is None:
        mean, mean2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    else:
        reduce_sum, n_slices = reduce
        n = x.numel() // x.shape[1] * n_slices
        sums = reduce_sum(torch.stack([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3))])) / n
        mean, mean2 = sums[0], sums[1]
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
        bn.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
