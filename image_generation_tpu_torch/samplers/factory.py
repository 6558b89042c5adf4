"""Sampler + latent-graph factory: the reference's setup entry point.

Port of ``image_generation_tpu/samplers/factory.py``: resolve the QPU's
coupling graph (``utils/topology.py``, no networkx), select and relabel
the n-latent subgraph, build the sampler backend, and return the hardware
parameter ranges.
"""

from __future__ import annotations

from typing import Optional, Tuple

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.samplers.base import SamplerBackend, get_sampler
from image_generation_tpu_torch.utils.graph_cache import graph_from_topology
from image_generation_tpu_torch.utils.subgraph import select_latent_graph
from image_generation_tpu_torch.utils.topology import graph_for_qpu

__all__ = ["get_sampler_and_graph"]

# Production hardware parameter ranges
H_RANGE = (-4.0, 4.0)
J_RANGE = (-1.0, 1.0)


def get_sampler_and_graph(
    num_reads: int,
    n_latents: int,
    random_seed: Optional[int],
    qpu: str,
    sampler: str = "gibbs",
    **sampler_kwargs,
) -> Tuple[SamplerBackend, dict, GRBMGraph, Tuple[float, float], Tuple[float, float]]:
    """Returns (sampler, sample_kwargs, grbm_graph, linear_range,
    quadratic_range); ``sample_kwargs`` carries num_reads."""
    latent, _ = select_latent_graph(graph_for_qpu(qpu), n_latents, random_seed)
    graph = graph_from_topology(latent)
    backend = get_sampler(sampler, **sampler_kwargs)
    return backend, {"num_reads": num_reads}, graph, H_RANGE, J_RANGE
