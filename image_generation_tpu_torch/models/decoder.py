"""Convolutional decoder: latent spins → images.

Port of ``image_generation_tpu/models/decoder.py`` in the reference's NCHW
layout: Linear(n → 4n), unflatten to a channel-major (n, 2, 2) map with
the batch and replica dims merged, then four blocks of
ConvTranspose3×3(stride 1, pad 1) → BatchNorm → Dropout2d(0.2) →
Upsample×2 (nearest) → LeakyReLU with channels n→128→64→32→1 and spatial
2→4→8→16→32, and a final ConvTranspose3×3(1→1).  The JAX package runs the
transposed convolutions as flipped regular ones; here they are
``nn.ConvTranspose2d``, whose weights are the reference's tensors as they
are (``_decoder.convtrans.{0,5,10,15,20}``, BatchNorms ``{1,6,11,16}``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Decoder"]


class Decoder(nn.Module):
    """Maps (B, R, n_latents) spins to (B·R, 1, H, W) images (f32)."""

    def __init__(self, n_latents: int):
        super().__init__()
        self.n_latents = n_latents
        self.increase_latent_dim = nn.Linear(n_latents, 4 * n_latents)
        layers = []
        chans = (n_latents, 128, 64, 32, 1)
        for i in range(4):
            layers += [
                nn.ConvTranspose2d(chans[i], chans[i + 1], 3, stride=1, padding=1),
                nn.BatchNorm2d(chans[i + 1], eps=1e-5, momentum=0.1),
                nn.Dropout2d(0.2),
                nn.Upsample(scale_factor=2, mode="nearest"),
                nn.LeakyReLU(0.01),
            ]
        layers.append(nn.ConvTranspose2d(1, 1, 3, stride=1, padding=1))
        self.convtrans = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if z.ndim != 3:
            raise ValueError(f"decoder expects (B, R, n_latents); got {tuple(z.shape)}")
        b, r, n = z.shape
        x = self.increase_latent_dim(z).reshape(b * r, n, 2, 2)
        return self.convtrans(x).float()
