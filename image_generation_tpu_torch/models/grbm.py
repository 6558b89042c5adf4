"""Graph-Restricted Boltzmann Machine: a fully-visible Ising model.

Port of ``image_generation_tpu/models/grbm.py``: ``GRBMParams`` holds the
(n,) fields and (E,) couplings as tensors, ``GRBMGraph`` the immutable edge
lists as numpy, ``scaled_ising`` gives the prefactor-scaled, range-clipped
model the sampler draws from, and ``nll_value`` / ``nll_grads`` are the
training objective and its closed-form gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "GRBMParams", "GRBMGraph", "energy", "scaled_ising", "suff_stats",
    "nll_value", "nll_grads",
]


@dataclass
class GRBMParams:
    """The checkpoint's ``_linear`` / ``_quadratic`` tensors."""

    linear: torch.Tensor  # (n,) float32 — per-spin field h_i
    quadratic: torch.Tensor  # (E,) float32 — per-edge coupling J_ij

    @property
    def n(self) -> int:
        return self.linear.shape[0]

    @property
    def n_edges(self) -> int:
        return self.quadratic.shape[0]


@dataclass(frozen=True, eq=False)
class GRBMGraph:
    """Immutable coupling structure (the checkpoint's ``_edge_idx_i/j``).

    Edges must be unique and non-self.  Compared and hashed by identity,
    like the JAX class.
    """

    n: int
    edge_i: np.ndarray  # (E,) int32
    edge_j: np.ndarray  # (E,) int32

    def __post_init__(self):
        object.__setattr__(self, "edge_i", np.asarray(self.edge_i, np.int32))
        object.__setattr__(self, "edge_j", np.asarray(self.edge_j, np.int32))
        if (self.edge_i == self.edge_j).any():
            raise ValueError("self-loops are not allowed")

    @property
    def n_edges(self) -> int:
        return int(self.edge_i.shape[0])

    @property
    def visible_idx(self) -> np.ndarray:
        return np.arange(self.n, dtype=np.int64)

    def _edges(self, device):
        return (torch.as_tensor(self.edge_i, dtype=torch.long, device=device),
                torch.as_tensor(self.edge_j, dtype=torch.long, device=device))

    def coupling_matrix(self, quadratic: torch.Tensor) -> torch.Tensor:
        """Dense symmetric (n, n) coupling matrix with zero diagonal."""
        ei, ej = self._edges(quadratic.device)
        a = torch.zeros((self.n, self.n), dtype=torch.float32, device=quadratic.device)
        a.index_put_((ei, ej), quadratic.to(torch.float32), accumulate=True)
        a.index_put_((ej, ei), quadratic.to(torch.float32), accumulate=True)
        return a

    def init_params(self, generator: Optional[torch.Generator] = None,
                    scale: float = 0.01, device=None) -> "GRBMParams":
        """Small random init: N(0, scale²) fields and couplings, drawn from
        ``generator`` on ``device`` (the generator's device by default)."""
        if device is None:
            device = generator.device if generator is not None else "cpu"
        return GRBMParams(
            linear=scale * torch.randn(self.n, generator=generator, device=device),
            quadratic=scale * torch.randn(self.n_edges, generator=generator, device=device),
        )


def energy(params: GRBMParams, graph: GRBMGraph, spins: torch.Tensor) -> torch.Tensor:
    """Per-sample Ising energy E(s) = Σ h·s + Σ J·s_i·s_j for (..., n)
    spins in {−1, +1}; returns (...,)."""
    ei, ej = graph._edges(spins.device)
    return spins @ params.linear + (spins[..., ei] * spins[..., ej]) @ params.quadratic


def scaled_ising(
    params: GRBMParams,
    prefactor: float,
    linear_range: Tuple[float, float],
    quadratic_range: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Ising problem handed to the sampler: parameters multiplied by
    ``prefactor`` and clipped into the hardware h/J ranges."""
    h = torch.clamp(prefactor * params.linear, linear_range[0], linear_range[1])
    j = torch.clamp(prefactor * params.quadratic, quadratic_range[0], quadratic_range[1])
    return h, j


def suff_stats(graph: GRBMGraph, spins: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean sufficient statistics (⟨s_i⟩, ⟨s_i s_j⟩) over the batch axis:
    (B, n) spins → ((n,), (E,))."""
    ei, ej = graph._edges(spins.device)
    return spins.mean(0), (spins[:, ei] * spins[:, ej]).mean(0)


def nll_value(params: GRBMParams, graph: GRBMGraph, data_spins: torch.Tensor,
              model_spins: torch.Tensor) -> torch.Tensor:
    """The quasi-NLL ``mean(E(data)) − mean(E(model samples))``."""
    return (energy(params, graph, data_spins).mean()
            - energy(params, graph, model_spins).mean())


def nll_grads(graph: GRBMGraph, data_spins: torch.Tensor,
              model_spins: torch.Tensor) -> GRBMParams:
    """Closed-form gradient of the quasi-NLL: d/dh = ⟨s⟩_data − ⟨s⟩_model,
    d/dJ = ⟨s_i s_j⟩_data − ⟨s_i s_j⟩_model."""
    d1, d2 = suff_stats(graph, data_spins)
    m1, m2 = suff_stats(graph, model_spins)
    return GRBMParams(linear=d1 - m1, quadratic=d2 - m2)
