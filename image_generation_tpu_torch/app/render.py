"""Server-side figure rendering: plotly-schema JSON → PNG / SVG / HTML.

Port of ``image_generation_tpu/app/render.py``: every figure the web page
shows is drawn here in tested Python, so the page's script only swaps
``<img>`` sources and ``innerHTML``.

Renderers:
  * ``render_heatmap_png``   — generated / reconstructed image grids, PNG
    written with zlib (``app/diagram.py`` ``png_bytes``; no PIL);
  * ``render_loss_svg``      — per-batch loss curves;
  * ``render_topology_svg``  — the QPU-graph scatter (edge + node traces);
  * ``latent_strip_svg``     — the ±1 latent-vector strip of the model
    diagram (first five values, an ellipsis, the last, the size label);
  * ``model_data_html``      — the selected model's data card;
  * ``problem_details_html`` — the problem-details header/value table.

Each returns exactly the JAX function's string (or, for the PNG, pixels).
"""

from __future__ import annotations

import html as _html
from typing import Optional, Sequence

import numpy as np

from image_generation_tpu_torch.app import ui_config
from image_generation_tpu_torch.app.diagram import png_bytes

__all__ = [
    "render_heatmap_png",
    "render_loss_svg",
    "render_topology_svg",
    "latent_strip_svg",
    "problem_details_html",
    "model_data_html",
]


def render_heatmap_png(fig: dict, scale: int = 1) -> bytes:
    """Grey-scale PNG of a heatmap figure ({"data": [{"z": ...}]}).

    The figure's z rows are y-up (``figures.imshow_figure`` flips them);
    PNG rows are y-down, so flip back.  z is scaled by the figure's own
    ``zmax`` (255 for uint8 figures, 1.0 for older float ones); under
    ``reversescale`` bright = high z, else bright = low z.  ``scale`` > 1
    repeats each pixel (a nearest resize).
    """
    tr = fig["data"][0]
    z = np.asarray(tr["z"], np.float64)
    if z.ndim != 2 or z.size == 0:
        raise ValueError(f"heatmap z must be non-empty 2-D, got shape {z.shape}")
    z = np.flipud(z)
    zmax = float(tr.get("zmax", 1.0)) or 1.0
    v = np.clip(z / zmax, 0.0, 1.0)
    if not tr.get("reversescale", False):
        v = 1.0 - v
    px = np.round(v * 255).astype(np.uint8)
    if scale > 1:
        px = np.repeat(np.repeat(px, scale, axis=0), scale, axis=1)
    return png_bytes(px)


def render_loss_svg(
    fig: dict, color: Optional[str] = None, width: int = 600, height: int = 260
) -> str:
    """Loss-curve SVG: one polyline + min/max annotation (the drawLine
    contract the page used to implement in JS)."""
    color = color or ui_config.THEME_COLOR_SECONDARY
    ys = [float(v) for v in fig["data"][0]["y"]]
    if not ys:
        return f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}"></svg>'
    ymax, ymin = max(ys), min(ys)
    span = (ymax - ymin) or 1.0
    n = max(len(ys) - 1, 1)
    pts = " ".join(
        f"{(i / n) * (width - 20) + 10:.1f},"
        f"{height - 10 - ((v - ymin) / span) * (height - 20):.1f}"
        for i, v in enumerate(ys)
    )
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" points="{pts}"/>'
        f'<text x="12" y="16" font-size="11">max {ymax:.4f} min {ymin:.4f}</text>'
        "</svg>"
    )


def render_topology_svg(fig: dict, width: int = 500, height: int = 340) -> str:
    """QPU-topology SVG from an (edge trace, node trace) scatter figure.

    Edge trace x/y come in (x0, x1, None) triples (figures.topology_figure);
    node trace carries per-node marker colors.  Coordinates are normalized
    to [0, 1] by the figure writer; map into the viewport with an 8 px pad,
    y-up → y-down.
    """
    edges, nodes = fig["data"][0], fig["data"][1]

    def sx(x):
        return 8 + float(x) * (width - 16)

    def sy(y):
        return height - 8 - float(y) * (height - 16)

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
    ]
    ex, ey = edges["x"], edges["y"]
    for i in range(0, len(ex) - 1, 3):
        if ex[i] is None or ex[i + 1] is None:
            continue
        out.append(
            f'<line x1="{sx(ex[i]):.1f}" y1="{sy(ey[i]):.1f}" '
            f'x2="{sx(ex[i + 1]):.1f}" y2="{sy(ey[i + 1]):.1f}" '
            'stroke="#ccc" stroke-width="0.5"/>'
        )
    colors = nodes["marker"]["color"]
    per_node = isinstance(colors, (list, tuple))
    for i, (x, y) in enumerate(zip(nodes["x"], nodes["y"])):
        c = colors[i] if per_node else colors
        out.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="3" fill="{c}"/>')
    out.append("</svg>")
    return "".join(out)


def latent_strip_svg(
    values: Sequence[float],
    n_show: int = 5,
    block: int = 26,
    colors: Optional[Sequence[str]] = None,
) -> str:
    """The ±1 latent-vector strip: first ``n_show`` spins, an ellipsis, the
    last spin, and the vector-size label (reference generate_latent_vector,
    demo_interface.py:402-428 + the size brace at 596-600).  Orange = −1,
    teal = +1 (demo_configs GRAPH_COLORS order)."""
    colors = colors or ui_config.GRAPH_COLORS
    vals = [float(v) for v in values]
    if not vals:
        vals = [1.0, -1.0, -1.0, 1.0, -1.0, 1.0]  # reference fallback
    shown = vals[:n_show] + [vals[-1]]
    gap = 4
    n_cells = len(shown) + 1  # + ellipsis cell
    width = n_cells * (block + gap) + 40
    height = block + 18
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
    ]
    x = 0
    for i, v in enumerate(shown):
        if i == len(shown) - 1:  # ellipsis before the final value
            out.append(
                f'<text x="{x + block / 2:.0f}" y="{block * 0.75:.0f}" '
                f'text-anchor="middle" font-size="13">…</text>'
            )
            x += block + gap
        c = colors[1] if v > 0 else colors[0]
        label = "1" if v > 0 else "-1"
        out.append(
            f'<rect x="{x}" y="0" width="{block}" height="{block}" rx="4" fill="{c}"/>'
            f'<text x="{x + block / 2:.0f}" y="{block * 0.7:.0f}" text-anchor="middle" '
            f'font-size="12" fill="#fff">{label}</text>'
        )
        x += block + gap
    out.append(
        f'<text x="{x + 2}" y="{block * 0.7:.0f}" font-size="12" fill="#333">'
        f"×{len(vals)}</text>"
    )
    out.append("</svg>")
    return "".join(out)


def model_data_html(meta: dict) -> str:
    """The selected-model data card: QPU / Epochs and Latents / Batch Size
    in two flex columns next to the model dropdown (reference
    generate_model_data, demo_interface.py:179-202, populated on every model
    switch by check_qpu_and_update_model, demo_callbacks.py:207-294), plus
    the dataset origin when the checkpoint recorded one (beyond-reference:
    utils/data.DataSource.origin — which data actually trained the model)."""

    def p(label, key):
        v = meta.get(key)
        v = "—" if v is None else str(v)
        return f"<p><b>{label}: </b>{_html.escape(v)}</p>"

    left = p("QPU", "qpu") + p("Epochs", "n_epochs")
    right = p("Latents", "n_latents") + p("Batch Size", "batch_size")
    origin = meta.get("data_source")
    tail = (
        f'<div class="data-origin">{p("Data", "data_source")}</div>'
        if origin
        else ""
    )
    return (
        '<div class="model-details">'
        f"<div>{left}</div><div>{right}</div></div>{tail}"
    )


def problem_details_html(details: dict) -> str:
    """Header/value table (reference generate_problem_details_table,
    demo_interface.py:383-399: one <thead> row of the dict keys, one <tbody>
    row of the values)."""
    heads = "".join(f"<th>{_html.escape(str(k))}</th>" for k in details)
    cells = "".join(f"<td>{_html.escape(str(v))}</td>" for v in details.values())
    return (
        '<table class="problem-details-table">'
        f"<thead><tr>{heads}</tr></thead>"
        f"<tbody><tr>{cells}</tr></tbody></table>"
    )
