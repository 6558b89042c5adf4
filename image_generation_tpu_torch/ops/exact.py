"""Exact Boltzmann enumeration for small Ising models (test oracle).

Port of ``image_generation_tpu/ops/exact.py`` (numpy only, so it also runs
on a machine without JAX): on graphs of up to ~20 spins the Boltzmann
distribution is enumerated and the samplers' moments are held against it.
``exact_sample`` draws exact Boltzmann samples (the ``exact`` sampler
backend): host code, with the categorical draw made by numpy from a seed
the caller's ``torch.Generator`` draws, where JAX draws from its key.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["enumerate_states", "exact_moments", "exact_sample", "exact_log_z"]

_MAX_N = 22


def enumerate_states(n: int) -> np.ndarray:
    """All 2^n spin configurations as a (2^n, n) ±1 float32 array."""
    if n > _MAX_N:
        raise ValueError(f"n={n} too large for enumeration")
    bits = ((np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
    return 2.0 * bits - 1.0


def _energies(h, edge_i, edge_j, j, states):
    return states @ h + (states[:, edge_i] * states[:, edge_j]) @ j


def exact_log_z(h, edge_i, edge_j, j, beta: float = 1.0) -> float:
    states = enumerate_states(len(h))
    e = _energies(np.asarray(h), edge_i, edge_j, np.asarray(j), states)
    m = (-beta * e).max()
    return float(m + np.log(np.exp(-beta * e - m).sum()))


def exact_moments(
    h, edge_i, edge_j, j, beta: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact (⟨s_i⟩, ⟨s_i s_j⟩) under p(s) ∝ exp(−β E(s))."""
    h = np.asarray(h, np.float64)
    j = np.asarray(j, np.float64)
    states = enumerate_states(len(h)).astype(np.float64)
    e = _energies(h, edge_i, edge_j, j, states)
    logp = -beta * e
    logp -= logp.max()
    p = np.exp(logp)
    p /= p.sum()
    m1 = p @ states
    m2 = p @ (states[:, edge_i] * states[:, edge_j])
    return m1, m2


def exact_sample(generator, h, edge_i, edge_j, j, num_reads: int,
                 beta: float = 1.0) -> np.ndarray:
    """Draw ``num_reads`` exact Boltzmann samples by enumeration (n ≤ 20):
    a (num_reads, n) ±1 float32 array.  The categorical draw over the 2^n
    states is numpy's, seeded by one integer drawn from ``generator`` (a
    ``torch.Generator``, or None for torch's default one)."""
    h = np.asarray(h, np.float64)
    j = np.asarray(j, np.float64)
    states = enumerate_states(len(h))
    logits = -beta * _energies(h, edge_i, edge_j, j, states.astype(np.float64))
    p = np.exp(logits - logits.max())
    seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device if generator is not None else "cpu"))
    idx = np.random.default_rng(seed).choice(len(states), size=num_reads, p=p / p.sum())
    return states[idx]
