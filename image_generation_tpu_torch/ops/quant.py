"""Int8 quantization of the cached sampler coupling.

Port of ``image_generation_tpu/ops/quant.py``.  A symmetric per-model
scale maps the coupling onto 255 levels:

    scale = max|A| / 127          A_q = round(A / scale)  ∈ [-127, 127]

(rounding half to even, as ``jnp.round``; a zero matrix gets scale 1).
Under graph sharding each rank quantizes its own row block with the scale
of the whole matrix: max|A| is all-reduced (MAX) over the mesh's graph
axis first, so every shard holds the rows of the whole matrix's
quantization.
The sampler then samples the quantized model A' = scale · A_q exactly:
±1 spins times int8 couplings accumulate exactly in int32, and fields and
energies scale out once in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantCoupling", "quantize_coupling", "dequantize_coupling"]


class QuantCoupling(NamedTuple):
    """Int8-quantized symmetric coupling matrix with its f32 scale."""

    q: torch.Tensor      # (n_pad, n_pad) int8, symmetric
    scale: torch.Tensor  # () f32: the dequantized coupling is q · scale


def quantize_coupling(a: torch.Tensor, mesh=None) -> QuantCoupling:
    """Symmetric int8 quantization of a (n_pad, n_pad) coupling matrix, or
    with ``mesh`` (``parallel/mesh.py``) of this rank's row block of it,
    at the scale of the whole matrix."""
    a = a.to(torch.float32)
    lo, hi = torch.aminmax(a)  # max|A| without an |A| temporary
    amax = torch.maximum(-lo, hi)
    if mesh is not None:
        amax = mesh.all_reduce(amax.reshape(1), op="max").reshape(())
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = a / scale  # one temporary the size of ``a``: a row block may be GBs
    q.round_().clamp_(-127, 127)
    return QuantCoupling(q=q.to(torch.int8), scale=scale)


def dequantize_coupling(qc: QuantCoupling) -> torch.Tensor:
    """The f32 coupling matrix the int8 sampler actually samples."""
    return qc.q.to(torch.float32) * qc.scale
