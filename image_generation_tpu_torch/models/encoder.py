"""Convolutional encoder: images → latent spin logits.

Port of ``image_generation_tpu/models/encoder.py`` in the reference's own
NCHW layout: four blocks of Conv3×3(stride 1, pad 1) → BatchNorm →
MaxPool2 → LeakyReLU (the last LeakyReLU dropped), channels
1→32→64→128→n_latents, spatial 32→16→8→4→2; then each channel's 2×2 map is
flattened and projected 4 → 1.  The ``nn.Sequential`` indices reproduce
the reference's state-dict keys (``_encoder.conv.{0,4,8,12}`` convs,
``{1,5,9,13}`` BatchNorms), so ``dvae.pth`` loads as it is.
"""

from __future__ import annotations

import torch
from torch import nn

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
                # flax momentum 0.9 on the running average = torch 0.1
                nn.BatchNorm2d(chans[i + 1], eps=1e-5, momentum=0.1),
                nn.MaxPool2d(2),
            ]
            if i < 3:
                layers.append(nn.LeakyReLU(0.01))
        self.conv = nn.Sequential(*layers)
        self.projection = nn.Linear(4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)  # (B, n, 2, 2)
        x = self.projection(x.flatten(-2, -1))  # (B, n, 1)
        return x.flatten(1).float()
