"""Images served from an int8-sampled model, worked out again in plain f32.

A model of 2,048 latents or more is served from a sampler that stores
its coupling quantized to int8 and samples the quantized model exactly.
From the definition:

    scale = max|A| / 127          (1 for a zero matrix)
    A_q   = round(A / scale), ties to even, clamped to [-127, 127]
    f     = scale * (s @ A_q[:, c0:c1]) + h[c0:c1]

with A the prefactor-scaled, clipped coupling in the plan's columns.  The
product s @ A_q is a sum of integers of at most 127 times a spin's
degree, far below 2^24, so an f32 product with TF32 off holds it exactly
in any order; it is scaled once and h added.  Everything else is
``reference/serve.py``'s ``ReferenceServer``: which chains and Philox
seed a tagged slot owns, the colouring order, the sweeps at beta = 1, the
f32 decode and the uint8 quantisation.
"""

from __future__ import annotations

from typing import Optional

import torch

from reference import gibbs
from reference.serve import ReferenceServer

__all__ = ["LEVELS", "quantize", "int8_sweeps", "Int8ReferenceServer"]

LEVELS = 127  # int8's symmetric levels each side of zero


def quantize(a: torch.Tensor):
    """(A_q as f32 integers, scale as a 0-d f32 tensor) of ``a``."""
    a = a.to(torch.float32)
    amax = a.abs().max()
    scale = amax / LEVELS if float(amax) > 0 else torch.ones_like(amax)
    return torch.clamp(torch.round(a / scale), -LEVELS, LEVELS), scale


def int8_sweeps(plan, hp, jq, scale, spins, n_sweeps: int, key: Optional[torch.Tensor] = None,
                rows: Optional[torch.Tensor] = None, uniforms: Optional[torch.Tensor] = None,
                beta: float = 1.0) -> torch.Tensor:
    """``n_sweeps`` colour-block sweeps of ``spins`` (C, n_pad) under the
    quantized coupling ``jq`` at ``scale`` and fields ``hp``, with
    ``uniforms`` (n_sweeps, C, n_pad) or the Philox draws of ``key`` at
    counter rows ``rows`` (``gibbs.philox_uniforms``)."""
    s = spins.to(torch.float32).clone()
    if uniforms is None:
        rows = torch.arange(s.shape[0], dtype=torch.int64, device=s.device) if rows is None \
            else rows
        key = key.reshape(-1).to(s.device).expand(s.shape[0])
    for sweep in range(n_sweeps):
        u = uniforms[sweep] if uniforms is not None else \
            gibbs.philox_uniforms(key, rows, plan.n_pad, sweep)
        for c0, c1 in plan.spans:
            f = scale * (s @ jq[:, c0:c1]) + hp[c0:c1]
            s[:, c0:c1] = torch.where(u[:, c0:c1] < torch.sigmoid(-2.0 * beta * f), 1.0, -1.0)
    return s


class Int8ReferenceServer(ReferenceServer):
    """``ReferenceServer`` with the int8 sampler's model: the same slots,
    draws and decode, the coupling quantized as above."""

    def __init__(self, model_dir, cfg: dict, seed: int, device):
        super().__init__(model_dir, cfg, seed, device)
        self.jq, self.scale = quantize(self.jp)

    def spins(self, requests) -> torch.Tensor:
        """(reads · len(requests), n) spins of the tagged slots, original order."""
        s0, keys, rows = self.chains(requests)
        sweeps = self.cfg["GIBBS_BURN_IN"] + self.cfg["GIBBS_SWEEPS"]
        s = int8_sweeps(self.plan, self.hp, self.jq, self.scale, s0, sweeps, keys, rows)
        return s[:, torch.as_tensor(self.plan.orig_to_perm, device=self.dev)]
