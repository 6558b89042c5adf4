"""Persistent sample cache: the reference's deque helper, with its bug fixed.

Port of ``image_generation_tpu/samplers/persistent.py``, the same
semantics:

  * a FIFO buffer of up to ``max_deque_size`` past samples;
  * while the buffer is filling OR every ``iterations_before_resampling``
    calls, draw fresh samples from the backend and push them in;
  * otherwise serve a uniform random subset of the buffer, its indices
    drawn with the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.samplers.exact_sampler import host_array
from image_generation_tpu_torch.utils.sampleset import SampleSet

__all__ = ["PersistentSampleCache", "push_to_deque"]


def push_to_deque(deque: np.ndarray, x: np.ndarray, deque_size: int) -> np.ndarray:
    """FIFO push of rows of ``x`` into ``deque``, keeping ≤ deque_size rows."""
    out = np.concatenate([deque, x], axis=0)
    return out[-deque_size:]


class PersistentSampleCache:
    def __init__(
        self,
        backend,
        max_deque_size: int = 4096,
        iterations_before_resampling: int = 100,
    ):
        self.backend = backend
        self.max_deque_size = max_deque_size
        self.iterations_before_resampling = iterations_before_resampling
        self.deque: Optional[np.ndarray] = None
        self.iterations_since_last_resampling = 0
        self._last_energies: Optional[np.ndarray] = None

    @property
    def current_deque_size(self) -> int:
        return 0 if self.deque is None else self.deque.shape[0]

    def reset(self) -> None:
        """Drop all cached samples: call when the model's parameters
        change, so the cache never serves draws from an older model."""
        self.deque = None
        self.iterations_since_last_resampling = 0
        self._last_energies = None

    def sample(self, h, quadratic, graph: GRBMGraph, num_reads: int,
               generator: Optional[torch.Generator], **kw) -> SampleSet:
        resample = (
            self.current_deque_size < self.max_deque_size
            or self.iterations_since_last_resampling >= self.iterations_before_resampling
        )
        if resample:
            ss = self.backend.sample(h, quadratic, graph, num_reads, generator, **kw)
            if self.deque is None:
                self.deque = ss.spins.copy()
            else:
                self.deque = push_to_deque(self.deque, ss.spins, self.max_deque_size)
            self.iterations_since_last_resampling = 0
            self._last_energies = ss.energies
            return ss
        self.iterations_since_last_resampling += 1
        gdev = generator.device if generator is not None else "cpu"
        idx = torch.randint(0, self.current_deque_size, (num_reads,), generator=generator,
                            device=gdev).cpu().numpy()
        spins = self.deque[idx]
        h, q = host_array(h), host_array(quadratic)
        energies = spins @ h + (spins[:, graph.edge_i] * spins[:, graph.edge_j]) @ q
        return SampleSet(spins=spins, energies=energies, info={"sampler": "cache"})
