"""Discrete Variational Autoencoder with a ±1 spin latent bottleneck.

Port of ``image_generation_tpu/models/dvae.py``.  The submodules are
``_encoder`` / ``_decoder``, so the module's state dict is the reference's
``dvae.pth`` layout and loads with ``load_state_dict``.  The public
functions keep the JAX package's layout: ``encode`` takes (B, H, W, 1)
images, ``decode`` takes (B, R, n) spins and returns (B, R, H, W, 1).

Latent-to-discrete modes: ``None`` (stochastic straight-through: s = +1
with probability σ(2ℓ), identity gradient to the logits),
``"heaviside"`` (sign(ℓ), single replica) and ``"gumbel"`` (relaxed spins
tanh((2ℓ + log u − log(1−u)) / τ) in (−1, 1), fully differentiable, at
the temperature ``gumbel_tau``).  Any other mode raises ``ValueError``, as
the JAX model does.  In training mode (``module.train()``) BatchNorm uses
batch statistics and updates its running averages (Flax's convention) and
the decoder's Dropout2d is active; the spin uniforms and dropout masks can
be fed.

Precision: ``dtype`` is the conv/dense compute precision.  On CUDA,
bfloat16 runs under ``torch.autocast`` with BatchNorm in float32 and its
output cast back to bfloat16, as the JAX models do; parameters and
outputs stay float32.  On the CPU everything runs in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from image_generation_tpu_torch.models.decoder import Decoder
from image_generation_tpu_torch.models.encoder import Encoder

__all__ = ["DVAE", "spins_straight_through", "gumbel_spins", "gumbel_uniforms",
           "heaviside_spins"]

_GUMBEL_MIN, _GUMBEL_MAX = 1e-6, 1.0 - 1e-6  # the JAX draw's minval / maxval


def spins_straight_through(
    logits: torch.Tensor, n_replicas: int, generator: Optional[torch.Generator],
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stochastic ±1 spins with straight-through identity gradients:
    logits (B, n) → spins (B, n_replicas, n).  ``uniforms`` (B, R, n)
    replaces the draws from ``generator``."""
    p_plus = torch.sigmoid(2.0 * logits)[:, None, :]
    u = uniforms if uniforms is not None else torch.rand(
        (logits.shape[0], n_replicas, logits.shape[1]), generator=generator,
        device=logits.device, dtype=logits.dtype,
    )
    hard = torch.where(u < p_plus, 1.0, -1.0).to(logits.dtype)
    soft = logits[:, None, :]
    return soft + (hard - soft).detach()


def gumbel_uniforms(unit: torch.Tensor) -> torch.Tensor:
    """The JAX ``uniform(minval=1e-6, maxval=1-1e-6)`` map of a unit draw
    in [0, 1): ``max(min, u·(max − min) + min)`` in the draw's dtype (an
    affine map, not a clamp), with one rounding as XLA's fused multiply-add
    (an f32 product is exact in f64)."""
    lo = torch.tensor(_GUMBEL_MIN, dtype=unit.dtype, device=unit.device)
    span = torch.tensor(_GUMBEL_MAX, dtype=unit.dtype, device=unit.device) - lo
    fused = (unit.double() * span.double() + lo.double()).to(unit.dtype)
    return torch.maximum(lo, fused)


def gumbel_spins(
    logits: torch.Tensor, n_replicas: int, generator: Optional[torch.Generator],
    tau: float = 1.0, uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Relaxed spins through logistic noise: logits (B, n) → (B, R, n) in
    (−1, 1), s = tanh((2ℓ + log u − log1p(−u)) / τ), with no stop-gradient.
    ``uniforms`` (B, R, n), already in (1e-6, 1 − 1e-6) (``gumbel_uniforms``
    of a unit draw), replaces the draws from ``generator``."""
    u = uniforms if uniforms is not None else gumbel_uniforms(torch.rand(
        (logits.shape[0], n_replicas, logits.shape[1]), generator=generator,
        device=logits.device, dtype=logits.dtype,
    ))
    noise = torch.log(u) - torch.log1p(-u)
    return torch.tanh((2.0 * logits[:, None, :] + noise) / tau)


def heaviside_spins(logits: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """Deterministic sign(ℓ) spins (0 maps to −1) with ST gradients."""
    if n_replicas != 1:
        raise ValueError("heaviside latent-to-discrete requires n_replicas=1")
    hard = torch.where(logits > 0, 1.0, -1.0).to(logits.dtype)
    return (logits + (hard - logits).detach())[:, None, :]


class DVAE(nn.Module):
    """Encoder → spin bottleneck → decoder."""

    def __init__(self, n_latents: int, latent_to_discrete: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, gumbel_tau: float = 1.0):
        super().__init__()
        if latent_to_discrete not in (None, "heaviside", "gumbel"):
            raise ValueError("Invalid Mode: Mode is not heaviside.")
        self.n_latents = n_latents
        self.latent_to_discrete = latent_to_discrete
        self.gumbel_tau = gumbel_tau
        self.dtype = dtype
        self._encoder = Encoder(n_latents)
        self._decoder = Decoder(n_latents)

    def _bf16(self, device: torch.device) -> bool:
        return device.type == "cuda" and self.dtype == torch.bfloat16

    def _autocast(self, device: torch.device):
        return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                              enabled=self._bf16(device))

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) images → (B, n_latents) f32 logits."""
        act = torch.bfloat16 if self._bf16(images.device) else None
        with self._autocast(images.device):
            return self._encoder(images.permute(0, 3, 1, 2), act)

    def decode(self, spins: torch.Tensor, generator: Optional[torch.Generator] = None,
               dropout_masks=None) -> torch.Tensor:
        """(B, R, n_latents) spins → (B, R, H, W, 1) f32 images."""
        b, r, _ = spins.shape
        act = torch.bfloat16 if self._bf16(spins.device) else None
        with self._autocast(spins.device):
            x = self._decoder(spins, act, generator, dropout_masks)  # (B·R, 1, H, W)
        h, w = x.shape[-2:]
        return x.reshape(b, r, h, w, 1)

    def forward(self, images: torch.Tensor, n_replicas: int = 1,
                generator: Optional[torch.Generator] = None, *,
                spin_uniforms: Optional[torch.Tensor] = None, dropout_masks=None):
        """(B, H, W, 1) images → (logits, spins (B, R, n), recon
        (B, R, H, W, 1)).  Runs the module's current train/eval mode.
        ``spin_uniforms`` (B, R, n; in the gumbel mode already mapped by
        ``gumbel_uniforms``) and ``dropout_masks`` (four (B·R, C)
        multipliers) replace the draws from ``generator``."""
        logits = self.encode(images)
        if self.latent_to_discrete == "heaviside":
            spins = heaviside_spins(logits, n_replicas)
        elif self.latent_to_discrete == "gumbel":
            spins = gumbel_spins(logits, n_replicas, generator, self.gumbel_tau, spin_uniforms)
        else:
            spins = spins_straight_through(logits, n_replicas, generator, spin_uniforms)
        return logits, spins, self.decode(spins, generator, dropout_masks)
