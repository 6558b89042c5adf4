"""Live model-diagram assets: the per-stage images the UI animates.

Port of ``image_generation_tpu/app/diagram.py``:

  assets/model_diagram/step_1_input.png   — the example input image
  assets/model_diagram/step_2_encode.png  — the example's latent activations
  assets/model_diagram/latent_encoded.json — the example's ±1 latent spins
  assets/model_diagram/step_4_decode.png  — decoder 2×2 feature maps (grid)
  assets/model_diagram/step_5_output.png  — the decoded reconstruction

``save_png`` writes 8-bit PNGs through ``png_bytes``, with ``zlib`` and
``struct`` (the JAX package uses PIL, which this package does not need):
the same pixels.  ``app/render.py`` encodes its heatmaps with it too.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from image_generation_tpu_torch.utils.grid import make_grid

__all__ = ["png_bytes", "save_png", "generate_model_diagram", "save_example_image"]


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(px: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 pixels → the bytes of an 8-bit grey (or
    RGB) PNG."""
    px = np.ascontiguousarray(px, dtype=np.uint8)
    height, width = px.shape[:2]
    color = 0 if px.ndim == 2 else 2  # grey, or RGB
    rows = px.reshape(height, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(height))  # filter 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_png(image: np.ndarray, path) -> None:
    """(H, W) or (H, W, 1|3) float array in [0, 1] → an 8-bit grey (or
    RGB) PNG; a value v becomes ``uint8(v · 255)``, truncated as PIL's
    ``fromarray`` of the same cast."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    with open(path, "wb") as f:
        f.write(png_bytes((np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)))


def _normalized_grid(maps: np.ndarray, nrow: int) -> np.ndarray:
    """(N, H, W) feature maps → one grid image, min-max normalized."""
    maps = np.asarray(maps, np.float32)
    lo, hi = maps.min(), maps.max()
    if hi > lo:
        maps = (maps - lo) / (hi - lo)
    return make_grid(maps[..., None], nrow=nrow, padding=1, pad_value=1.0)


def save_example_image(images, out_dir, index: int = 0) -> np.ndarray:
    """Write step_1_input.png from the dataset."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    example = images[index]
    example = example.cpu().numpy() if hasattr(example, "cpu") else np.asarray(example)
    save_png(example, out_dir / "step_1_input.png")
    return example


def generate_model_diagram(trainer, example_image, out_dir="assets/model_diagram") -> dict:
    """Run the example through the pipeline stages and write the assets.

    Returns the asset paths.  ``example_image``: (H, W, 1) in [0, 1], a
    tensor or an array.  ``out_dir`` None: the pass runs (its draw from
    the trainer's seed stream, and on a mesh its collectives, as on the
    rank that writes) and nothing is written; returns {}."""
    from image_generation_tpu_torch.parallel.dense import ColumnShardedLinear

    dvae = trainer.dvae.eval()
    x = torch.as_tensor(np.asarray(example_image.cpu() if hasattr(example_image, "cpu")
                                   else example_image), dtype=torch.float32,
                        device=trainer.device)[None]  # (1, H, W, 1)
    with torch.inference_mode():
        logits, spins, recon = dvae(x, 1, trainer._next_generator())
        n = trainer.n_latents
        # the example's latent activations as one square-ish image
        side = int(np.ceil(np.sqrt(n)))
        latent_img = np.zeros((side * side,), np.float32)
        latent_img[:n] = torch.sigmoid(2.0 * logits[0]).cpu().numpy()
        s0 = spins[0, 0]
        # the decoder's first stage: its 2×2 feature map per latent (a
        # column-sharded layer's weight gathered whole first)
        lin = dvae._decoder.increase_latent_dim
        weight = lin.shard.gather(lin.weight) if isinstance(lin, ColumnShardedLinear) else lin.weight
        feat = (s0 @ weight.T.float() + lin.bias.float()).cpu().numpy()
        out = torch.clamp(recon[0, 0], 0, 1).cpu().numpy()
    if out_dir is None:
        return {}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_png(x[0].cpu().numpy(), out_dir / "step_1_input.png")
    save_png(latent_img.reshape(side, side), out_dir / "step_2_encode.png")
    with open(out_dir / "latent_encoded.json", "w") as f:
        json.dump([float(v) for v in s0.cpu().numpy()], f)
    maps = feat.reshape(n, 2, 2)[: min(n, 256)]
    save_png(_normalized_grid(maps, nrow=16), out_dir / "step_4_decode.png")
    save_png(out, out_dir / "step_5_output.png")

    return {
        "step_1": str(out_dir / "step_1_input.png"),
        "step_2": str(out_dir / "step_2_encode.png"),
        "step_4": str(out_dir / "step_4_decode.png"),
        "step_5": str(out_dir / "step_5_output.png"),
        "latent_encoded": str(out_dir / "latent_encoded.json"),
    }
