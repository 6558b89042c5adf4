"""Convolutional encoder: images → latent spin logits.

Port of ``image_generation_tpu/models/encoder.py`` in the reference's own
NCHW layout: four blocks of Conv3×3(stride 1, pad 1) → BatchNorm →
MaxPool2 → LeakyReLU (the last LeakyReLU dropped), channels
1→32→64→128→n_latents, spatial 32→16→8→4→2; then each channel's 2×2 map is
flattened and projected 4 → 1.  The ``nn.Sequential`` indices reproduce
the reference's state-dict keys (``_encoder.conv.{0,4,8,12}`` convs,
``{1,5,9,13}`` BatchNorms), so ``dvae.pth`` loads as it is.  BatchNorm
follows Flax's running-statistics convention (``models/batchnorm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from image_generation_tpu_torch.models.batchnorm import batch_norm

__all__ = ["Encoder"]


class Encoder(nn.Module):
    """Maps (B, 1, H, W) images to (B, n_latents) spin logits."""

    def __init__(self, n_latents: int):
        super().__init__()
        self.n_latents = n_latents
        layers = []
        chans = (1, 32, 64, 128, n_latents)
        for i in range(4):
            layers += [
                nn.Conv2d(chans[i], chans[i + 1], 3, stride=1, padding=1),
                nn.BatchNorm2d(chans[i + 1], eps=1e-5),
                nn.MaxPool2d(2),
            ]
            if i < 3:
                layers.append(nn.LeakyReLU(0.01))
        self.conv = nn.Sequential(*layers)
        self.projection = nn.Linear(4, 1)

    def forward(self, x: torch.Tensor, act_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``act_dtype``: the type BatchNorm's f32 output is cast back to
        (the compute type under bf16 autocast, as the JAX model casts)."""
        for layer in self.conv:
            if isinstance(layer, nn.BatchNorm2d):
                x = batch_norm(x, layer, self.training)
                if act_dtype is not None:
                    x = x.to(act_dtype)
            elif isinstance(layer, nn.LeakyReLU):
                x = F.leaky_relu(x, 0.01)
            else:
                x = layer(x)
        x = self.projection(x.flatten(-2, -1))  # (B, n, 1)
        return x.flatten(1).float()
