"""The numbers the comparison with the reference reads."""

from __future__ import annotations

import numpy as np

__all__ = ["relative_gap", "leaf_gaps"]


def relative_gap(program: float, reference: float) -> float:
    return abs(program - reference) / max(abs(reference), 1e-30)


def leaf_gaps(program: dict, reference: dict) -> dict:
    """Each leaf's gap between its norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's; a leaf the program lacks reads as norm 0."""
    median = float(np.median(list(reference.values())))
    return {k: abs(program.get(k, 0.0) - v) / max(v, median, 1e-30)
            for k, v in reference.items()}
