"""Image-grid assembly and output sharpening (numpy).

Copy of ``image_generation_tpu/utils/grid.py``: ``make_grid`` /
``sharpen``, the host post-processing that each serving caller runs on its
own slice, and ``interleave``, the original/reconstruction pairing.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_grid", "sharpen", "interleave"]


def make_grid(
    images: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0
) -> np.ndarray:
    """Tile (N, H, W, C) images into one (H', W', C) grid image, with
    torchvision's semantics: ``nrow`` images per row, ``padding`` pixels
    between and around tiles."""
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, dtype=images.dtype)
    for k in range(n):
        r, col = divmod(k, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = images[k]
    return grid


def sharpen(images: np.ndarray, lower: float = 0.4, upper: float = 0.6) -> np.ndarray:
    """Binarize bright/dark pixels, keep mid-range: the reference's
    ``(over + |over−1|·img)·under`` with heaviside thresholds."""
    images = np.asarray(images)
    over = np.heaviside(images - upper, 0.0)
    under = np.heaviside(images - lower, 0.0)
    return (over + np.abs(over - 1.0) * images) * under


def interleave(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Alternate images from two stacks: (N,...)+(N,...) → (2N,...), the
    reference's ``rearrange([batch, recon], "i b c h w -> (b i) c h w")``."""
    a, b = np.asarray(a), np.asarray(b)
    out = np.empty((a.shape[0] + b.shape[0], *a.shape[1:]), dtype=a.dtype)
    out[0::2] = a
    out[1::2] = b
    return out
