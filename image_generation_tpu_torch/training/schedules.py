"""Learning-rate schedules with the reference's one-step lag.

Port of ``image_generation_tpu/training/schedules.py``: the reference
writes ``geomspace(initial, final, N + 1)[opt_step]`` into the optimizer
after each step, so step 0 runs at the initial LR and step k ≥ 1 at entry
k − 1.  Evaluated on the host: the step counter is a host integer here.
"""

from __future__ import annotations

__all__ = ["geomspace_lr"]


def geomspace_lr(initial: float, final: float, total_steps: int):
    """Step → LR: ``initial · (final/initial)^(i/N)`` with
    ``i = clip(step − 1, 0, N)``, N = max(total_steps, 1)."""
    ratio = final / initial
    n = max(total_steps, 1)

    def lr(step: int) -> float:
        i = min(max(step - 1, 0), n)
        return initial * ratio ** (i / n)

    return lr
