"""Sampler backend protocol: the annealer-replacement surface.

Port of ``image_generation_tpu/samplers/base.py``.  A sampler backend is
anything with

    sample(h, quadratic, graph, num_reads, generator, **kwargs) -> SampleSet

where ``h`` / ``quadratic`` are the already prefactor-scaled,
range-clipped parameters (``models.grbm.scaled_ising``), ``graph`` is the
GRBMGraph and ``generator`` a ``torch.Generator`` (the JAX ``key``).
Returned spins are ±1 in original spin order, one row per read.

Backends:
  * ``GibbsSampler``  — block-Gibbs through the sweep kernel (default)
  * ``PTSampler``     — parallel tempering for stiff models
  * ``ExactSampler``  — exact enumeration, n ≤ 20 (tests / fake annealer)
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import torch

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.utils.sampleset import SampleSet

__all__ = ["SamplerBackend", "get_sampler"]


@runtime_checkable
class SamplerBackend(Protocol):
    name: str

    def sample(
        self,
        h,
        quadratic,
        graph: GRBMGraph,
        num_reads: int,
        generator: Optional[torch.Generator],
        **kwargs,
    ) -> SampleSet: ...


def get_sampler(name: str, **kwargs) -> "SamplerBackend":
    """Backend factory: "gibbs", "pt" or "exact"."""
    from image_generation_tpu_torch.samplers.exact_sampler import ExactSampler
    from image_generation_tpu_torch.samplers.gibbs_sampler import GibbsSampler, PTSampler

    table = {"gibbs": GibbsSampler, "pt": PTSampler, "exact": ExactSampler}
    if name not in table:
        raise ValueError(f"unknown sampler backend: {name!r} (have {sorted(table)})")
    return table[name](**kwargs)
