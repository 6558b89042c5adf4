"""MNIST data pipeline: device-resident, permutation-batched.

Port of ``image_generation_tpu/utils/data.py``.  The whole binarised,
resized dataset lives on the trainer's device once; each epoch draws a
permutation there and batches are slices of the permuted tensor.

Sources, in order (no download is ever attempted):
  1. raw MNIST IDX files (optionally .gz) under ``$MNIST_DATA_DIR``,
     ``data/MNIST/raw``, ``data`` or ``~/.keras/datasets``;
  2. an ``mnist.npz`` (keras layout) in the same places;
  3. scikit-learn's bundled ``load_digits``, upsampled 8→28 (imported
     lazily, only when the first two are missing);
  4. procedural synthetic digits, 4,096 of them (never fails).

``DataSource.origin`` records which one was used.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["DataSource", "load_mnist", "mnist_pool_size", "prepare_images", "get_dataset",
           "epoch_batches", "permuted_epoch"]


@dataclass
class DataSource:
    images: np.ndarray  # (N, 28, 28) float32 in [0, 1]
    labels: np.ndarray  # (N,) int32
    origin: str


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def mnist_pool_size() -> int:
    """The length of the pool ``load_mnist(None)`` would give, reading only
    the IDX header when raw MNIST is on disk (60k images that need not be
    loaded to be counted); otherwise the offline pool is loaded and
    counted."""
    idx = _find("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz")
    if idx is not None:
        opener = gzip.open if idx.suffix == ".gz" else open
        with opener(idx, "rb") as f:
            f.read(4)  # magic
            return struct.unpack(">I", f.read(4))[0]  # first dim = N
    return len(load_mnist(None).images)


def _find(*names: str) -> Optional[Path]:
    roots = []
    if os.environ.get("MNIST_DATA_DIR"):
        roots.append(Path(os.environ["MNIST_DATA_DIR"]))
    roots += [Path("data/MNIST/raw"), Path("data"), Path.home() / ".keras/datasets"]
    for root in roots:
        for name in names:
            p = root / name
            if p.exists():
                return p
    return None


def _synthetic_digits(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural digit-like images: anti-aliased strokes on a 28×28 grid
    (the same numpy stream as the JAX package, so the same images)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    images = np.zeros((n, 28, 28), np.float32)
    labels = rng.randint(0, 10, n).astype(np.int32)
    for i in range(n):
        k = 2 + labels[i] % 3
        img = np.zeros((28, 28), np.float32)
        for _ in range(k):
            x0, y0 = rng.uniform(6, 22, 2)
            ang = rng.uniform(0, np.pi)
            length = rng.uniform(6, 14)
            x1, y1 = x0 + length * np.cos(ang), y0 + length * np.sin(ang)
            t = np.linspace(0, 1, 24)[:, None, None]
            px, py = x0 + t * (x1 - x0), y0 + t * (y1 - y0)
            img += np.exp(-(((xx - px) ** 2 + (yy - py) ** 2) / 2.0)).sum(0)
        images[i] = np.clip(img, 0, 1)
    return images, labels


def _resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W) → (N, size, size), half-pixel bilinear: for upsampling the
    same weights as ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x[:, None], size=(size, size), mode="bilinear",
                         align_corners=False)[:, 0]


def load_mnist(dataset_size: Optional[int] = None) -> DataSource:
    """MNIST train images from the best offline source (module docstring)."""
    idx = _find("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz")
    if idx is not None:
        lab = _find("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz")
        images = _read_idx(idx).astype(np.float32) / 255.0
        labels = (_read_idx(lab).astype(np.int32) if lab is not None
                  else np.zeros(len(images), np.int32))
        src = DataSource(images, labels, origin="mnist-idx")
    else:
        npz = _find("mnist.npz")
        if npz is not None:
            with np.load(npz) as z:
                src = DataSource(z["x_train"].astype(np.float32) / 255.0,
                                 z["y_train"].astype(np.int32), origin="mnist-npz")
        else:
            try:
                from sklearn.datasets import load_digits

                d = load_digits()
                imgs8 = torch.from_numpy(d.images.astype(np.float32) / 16.0)
                up = _resize_bilinear(imgs8, 28).clamp(0, 1).numpy()
                src = DataSource(up, d.target.astype(np.int32),
                                 origin="sklearn-digits-upsampled")
            except Exception:
                images, labels = _synthetic_digits(4096)
                src = DataSource(images, labels, origin="synthetic")

    if dataset_size is not None and dataset_size > 0:
        if dataset_size <= len(src.images):
            src = DataSource(src.images[:dataset_size], src.labels[:dataset_size], src.origin)
        else:  # tile the small offline sources up
            reps = -(-dataset_size // len(src.images))
            src = DataSource(np.tile(src.images, (reps, 1, 1))[:dataset_size],
                             np.tile(src.labels, reps)[:dataset_size],
                             src.origin + f"-tiled{reps}")
    return src


def prepare_images(source: DataSource, image_size: int = 32, binarize: bool = True,
                   device="cpu") -> torch.Tensor:
    """Resize 28→image_size (bilinear) and binarise by rounding (the
    reference's Resize + ToTensor + round).  Returns (N, S, S, 1) f32 on
    ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(source.images)).to(device)
    if x.shape[1] != image_size:
        x = _resize_bilinear(x, image_size)
    if binarize:
        x = torch.round(torch.clamp(x, 0.0, 1.0))
    return x[..., None].to(torch.float32).contiguous()


def get_dataset(image_size: int = 32, dataset_size: Optional[int] = None,
                binarize: bool = True, device="cpu") -> Tuple[torch.Tensor, DataSource]:
    """Device images (N, S, S, 1) and the source they came from."""
    src = load_mnist(dataset_size)
    return prepare_images(src, image_size, binarize, device), src


def epoch_batches(images: torch.Tensor, batch_size: int,
                  generator: Optional[torch.Generator],
                  drop_last: bool = True) -> Iterator[torch.Tensor]:
    """Shuffled batches of a device-resident dataset, one epoch: one
    permutation drawn on the images' device, then slices of the permuted
    tensor (the ``DataLoader(shuffle=True, drop_last=True)`` equivalent);
    without ``drop_last`` one more batch covers the rest, its start moved
    back to keep ``batch_size`` images (the JAX dynamic slice clamps it)."""
    n = images.shape[0]
    shuffled = images[torch.randperm(n, generator=generator, device=images.device)]
    n_batches = n // batch_size if drop_last else -(-n // batch_size)
    for i in range(n_batches):
        start = min(i * batch_size, n - batch_size)
        yield shuffled[start:start + batch_size]


def permuted_epoch(images: torch.Tensor, batch_size: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """(n_batches, B, S, S, 1): one shuffled epoch, drop_last, drawn on the
    images' device."""
    n = images.shape[0]
    n_batches = n // batch_size
    perm = torch.randperm(n, generator=generator, device=images.device)[: n_batches * batch_size]
    return images[perm].reshape(n_batches, batch_size, *images.shape[1:])
