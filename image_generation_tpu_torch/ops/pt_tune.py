"""Parallel-tempering ladder helpers (host side).

Port of the two numpy functions of ``image_generation_tpu/ops/pt_tune.py``
that training calls: ``recommend_num_betas`` (the rung-count
recommendation ``Trainer.train_epoch`` reports under PT) and
``respace_betas`` (one equal-barrier re-spacing, ``PT_ADAPT="epoch"``).
Both take a per-pair swap acceptance curve; the communication barrier is
Λ = Σ(1 − a_k) (Syed et al. 2021).  The acceptance probe and offline
tuner (``size_ladder``, ``tune_pt_betas``) are not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["recommend_num_betas", "respace_betas"]


def recommend_num_betas(accept, target_accept: float = 0.5, t_min: int = 2,
                        t_max: int = 64) -> int:
    """Rung count of an equal-barrier ladder whose per-pair acceptance is
    ≥ ``target_accept``: T = ⌈Λ / (1 − target)⌉ + 1, clipped."""
    accept = np.clip(np.asarray(accept, np.float64), 0.0, 1.0)
    barrier = float(np.sum(1.0 - accept))
    t = int(np.ceil(barrier / max(1e-9, 1.0 - float(target_accept)))) + 1
    return int(np.clip(t, t_min, t_max))


def respace_betas(betas, accept) -> np.ndarray:
    """Move the interior rungs to the equal-Λ quantiles of the
    piecewise-linear barrier through the current rungs (endpoints fixed)."""
    betas = np.asarray(betas, np.float64)
    accept = np.clip(np.asarray(accept, np.float64), 1e-4, 1.0)
    rej = np.maximum(1.0 - accept, 1e-4)  # keeps Λ strictly increasing
    lam = np.concatenate([[0.0], np.cumsum(rej)])
    new = np.interp(np.linspace(0.0, lam[-1], len(betas)), lam, betas)
    new[0], new[-1] = betas[0], betas[-1]
    return new
