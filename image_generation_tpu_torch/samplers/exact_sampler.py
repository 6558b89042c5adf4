"""Exact enumeration sampler backend (the host "fake annealer").

Port of ``image_generation_tpu/samplers/exact_sampler.py``: for n ≤ 20
spins it draws exact Boltzmann samples on the host (``ops/exact.py``).
"""

from __future__ import annotations

import numpy as np

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.ops.exact import exact_sample
from image_generation_tpu_torch.utils.sampleset import SampleSet

__all__ = ["ExactSampler", "host_array"]


def host_array(x) -> np.ndarray:
    """A numpy array of ``x``: a torch tensor on any device, or array-like."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ExactSampler:
    name = "exact"

    def __init__(self, beta: float = 1.0):
        self.beta = beta

    def sample(self, h, quadratic, graph: GRBMGraph, num_reads, generator, **_) -> SampleSet:
        h, q = host_array(h), host_array(quadratic)
        spins = exact_sample(generator, h, graph.edge_i, graph.edge_j, q, num_reads, self.beta)
        energies = spins @ h + (spins[:, graph.edge_i] * spins[:, graph.edge_j]) @ q
        return SampleSet(spins=spins, energies=energies, info={"sampler": self.name})
