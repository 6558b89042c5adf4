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

In training, Dropout2d drops whole channels: a channel's activations are
multiplied by ``keep / 0.8``, ``keep`` drawn per (image, channel) from the
caller's generator, or by a fed (N, C) multiplier.  BatchNorm follows
Flax's running-statistics convention (``models/batchnorm.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from image_generation_tpu_torch.models.batchnorm import batch_norm

__all__ = ["Decoder", "DROPOUT_RATE", "draw_dropout_masks"]

DROPOUT_RATE = 0.2
CHANNELS = (128, 64, 32, 1)  # the four dropout layers' channels


def draw_dropout_masks(n: int, generator: Optional[torch.Generator], device):
    """The four (n, C) Dropout2d multipliers ``Decoder.forward`` draws in
    training for n = B·R images, in its order."""
    return [(torch.rand((n, c), generator=generator, device=device) >= DROPOUT_RATE).float()
            / (1.0 - DROPOUT_RATE) for c in CHANNELS]


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
                nn.BatchNorm2d(chans[i + 1], eps=1e-5),
                nn.Dropout2d(DROPOUT_RATE),
                nn.Upsample(scale_factor=2, mode="nearest"),
                nn.LeakyReLU(0.01),
            ]
        layers.append(nn.ConvTranspose2d(1, 1, 3, stride=1, padding=1))
        self.convtrans = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor, act_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``dropout_masks``: optional per-layer (B·R, C) multipliers that
        replace the drawn channel masks in training (ones turn dropout off)."""
        if z.ndim != 3:
            raise ValueError(f"decoder expects (B, R, n_latents); got {tuple(z.shape)}")
        b, r, n = z.shape
        x = self.increase_latent_dim(z).reshape(b * r, n, 2, 2)
        if self.training and dropout_masks is None:
            dropout_masks = draw_dropout_masks(b * r, generator, x.device)
        i_drop = 0
        for layer in self.convtrans:
            if isinstance(layer, nn.BatchNorm2d):
                x = batch_norm(x, layer, self.training)
                if act_dtype is not None:
                    x = x.to(act_dtype)
            elif isinstance(layer, nn.Dropout2d):
                if self.training:
                    x = x * dropout_masks[i_drop].to(x.dtype)[:, :, None, None]
                i_drop += 1
            elif isinstance(layer, nn.LeakyReLU):
                x = F.leaky_relu(x, 0.01)
            else:
                x = layer(x)
        return x.float()
