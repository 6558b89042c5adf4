"""Plotly-schema figure JSON without the plotly dependency.

Port of ``image_generation_tpu/app/figures.py`` (``imshow_figure``,
``loss_figure``, ``write_figure``): dicts with plotly's schema
(``{"data": [...], "layout": {...}}``) that any plotly front end, and the
bundled web UI, render unchanged.  The topology figures wait for the
server's port (they need graph layout positions).
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

__all__ = ["imshow_figure", "loss_figure", "write_figure"]

_BARE_LAYOUT = {"margin": {"t": 0, "l": 0, "b": 0, "r": 0}}


def imshow_figure(image: np.ndarray) -> dict:
    """A grey-scale image as a heatmap figure (px.imshow's), z quantized
    to 8-bit ints 0-255 with ``zmax`` 255, flipped so the heatmap's
    upward y-axis shows the image upright."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img[..., 0]
    z = np.flipud(img)
    z8 = np.round(np.clip(z.astype(np.float64), 0.0, 1.0) * 255.0)
    return {
        "data": [
            {
                "type": "heatmap",
                "z": z8.astype(np.uint8).tolist(),
                "colorscale": "Greys",
                "reversescale": True,
                "showscale": False,
                "zmin": 0,
                "zmax": 255,
            }
        ],
        "layout": {
            **_BARE_LAYOUT,
            "xaxis": {"showticklabels": False, "visible": False},
            "yaxis": {
                "showticklabels": False,
                "visible": False,
                "scaleanchor": "x",
            },
        },
    }


def loss_figure(losses: Sequence[float], title_y: str = "Loss") -> dict:
    """Per-batch loss curve."""
    ys = [float(v) for v in losses]
    return {
        "data": [{"type": "scatter", "mode": "lines", "x": list(range(len(ys))), "y": ys}],
        "layout": {
            **_BARE_LAYOUT,
            "xaxis": {"title": {"text": "Batch"}},
            "yaxis": {"title": {"text": title_y}},
        },
    }


def write_figure(fig: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(fig, f, separators=(",", ":"))  # compact: grids are ~1 MB
