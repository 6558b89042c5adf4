"""Int8 quantization of the cached sampler coupling.

Port of ``image_generation_tpu/ops/quant.py``.  A symmetric per-model
scale maps the coupling onto 255 levels:

    scale = max|A| / 127          A_q = round(A / scale)  ∈ [-127, 127]

(rounding half to even, as ``jnp.round``; a zero matrix gets scale 1).
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


def quantize_coupling(a: torch.Tensor) -> QuantCoupling:
    """Symmetric int8 quantization of a (n_pad, n_pad) coupling matrix."""
    a = a.to(torch.float32)
    amax = a.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return QuantCoupling(q=q, scale=scale)


def dequantize_coupling(qc: QuantCoupling) -> torch.Tensor:
    """The f32 coupling matrix the int8 sampler actually samples."""
    return qc.q.to(torch.float32) * qc.scale
