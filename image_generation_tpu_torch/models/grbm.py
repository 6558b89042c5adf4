"""Graph-Restricted Boltzmann Machine: a fully-visible Ising model.

Port of ``image_generation_tpu/models/grbm.py`` (the serving subset):
``GRBMParams`` holds the (n,) fields and (E,) couplings as tensors,
``GRBMGraph`` the immutable edge lists as numpy, and ``scaled_ising`` gives
the prefactor-scaled, range-clipped model the sampler draws from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["GRBMParams", "GRBMGraph", "energy", "scaled_ising"]


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


def energy(params: GRBMParams, graph: GRBMGraph, spins: torch.Tensor) -> torch.Tensor:
    """Per-sample Ising energy E(s) = Σ h·s + Σ J·s_i·s_j for (..., n)
    spins in {−1, +1}; returns (...,)."""
    ei = torch.as_tensor(graph.edge_i, dtype=torch.long, device=spins.device)
    ej = torch.as_tensor(graph.edge_j, dtype=torch.long, device=spins.device)
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
