"""Sample container: the framework's ``dimod.SampleSet`` equivalent.

A numpy copy of ``image_generation_tpu/utils/sampleset.py``: samples are
plain arrays plus this small dataclass for the places that need the
record structure (the problem-details table, the persistent sample cache,
generation).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["SampleSet"]


@dataclass
class SampleSet:
    """A batch of spin samples with their energies.

    Attributes:
      spins: (num_reads, n) array with entries in {-1, +1}.
      energies: (num_reads,) energies of each read under the *sampled*
        (prefactor-scaled, range-clipped) Ising model.
      vartype: always "SPIN" (the GRBMs are spin-valued).
      info: free-form metadata (sampler name, sweeps, beta ladder).
    """

    spins: np.ndarray
    energies: Optional[np.ndarray] = None
    vartype: str = "SPIN"
    info: dict = field(default_factory=dict)

    def __post_init__(self):
        self.spins = np.asarray(self.spins)
        if self.energies is not None:
            self.energies = np.asarray(self.energies)

    def __len__(self) -> int:
        return self.spins.shape[0]

    @property
    def num_variables(self) -> int:
        return self.spins.shape[1]

    def first(self):
        """(spins, energy) of the lowest-energy read (dimod's ``.first``)."""
        if self.energies is None:
            return self.spins[0], None
        k = int(np.argmin(self.energies))
        return self.spins[k], float(self.energies[k])
