"""Plotly-schema figure JSON without the plotly dependency.

Port of ``image_generation_tpu/app/figures.py``: dicts with plotly's
schema (``{"data": [...], "layout": {...}}``) that any plotly front end,
and the bundled web UI, render unchanged.  The topology figures lay a
model's coupling graph out at its physical qubit coordinates
(``utils/topology.py`` positions) or, for checkpoints without them, with
the numpy spring layout (``utils/layout.py``), without networkx.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "imshow_figure",
    "loss_figure",
    "topology_figure",
    "model_topology_figure",
    "write_figure",
]

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


def topology_figure(
    graph,
    layout: dict,
    node_values: Optional[Sequence[float]] = None,
    colors=("#FF7006", "#17BEBB"),
) -> dict:
    """QPU-topology scatter: an edge trace (``graph.edges()`` order, each
    edge as x0, x1, None) and a node trace coloured by spin sign."""
    xe, ye = [], []
    for u, v in graph.edges():
        xe += [layout[u][0], layout[v][0], None]
        ye += [layout[u][1], layout[v][1], None]
    nodes = list(graph.nodes())
    xn = [layout[n][0] for n in nodes]
    yn = [layout[n][1] for n in nodes]
    if node_values is None:
        node_colors = [colors[1]] * len(nodes)
    else:
        node_colors = [colors[1] if v > 0 else colors[0] for v in node_values]
    return {
        "data": [
            {
                "type": "scatter",
                "mode": "lines",
                "x": xe,
                "y": ye,
                "line": {"width": 0.5, "color": "#888"},
                "hoverinfo": "none",
            },
            {
                "type": "scatter",
                "mode": "markers",
                "x": xn,
                "y": yn,
                "marker": {"size": 6, "color": node_colors},
                "hoverinfo": "text",
                "text": [str(n) for n in nodes],
            },
        ],
        "layout": {
            **_BARE_LAYOUT,
            "showlegend": False,
            "xaxis": {"visible": False},
            "yaxis": {"visible": False, "scaleanchor": "x"},
        },
    }


def write_figure(fig: dict, path) -> None:
    with open(path, "w") as f:
        json.dump(fig, f, separators=(",", ":"))  # compact: grids are ~1 MB


_FULL_GRAPH_CACHE: dict = {}


def model_topology_figure(model_dir, latent_values=None) -> dict:
    """Topology figure of a saved model's latent coupling graph, nodes
    coloured by ``latent_values`` (±1): drawn at the physical QPU
    coordinates when ``parameters.json`` carries ``physical_nodes``, else
    with the spring layout (checkpoints written by the reference)."""
    from pathlib import Path

    from image_generation_tpu_torch.io.torch_pth import grbm_from_state_dict, load_state_dict
    from image_generation_tpu_torch.utils.layout import spring_layout
    from image_generation_tpu_torch.utils.topology import Graph, graph_for_qpu

    model_dir = Path(model_dir)
    _, graph = grbm_from_state_dict(load_state_dict(model_dir / "grbm.pth"))
    g = Graph()  # GRBMGraph.to_networkx's calls: nodes 0..n-1, then the edge list
    for i in range(graph.n):
        g.add_node(i)
    for u, v in zip(graph.edge_i.tolist(), graph.edge_j.tolist()):
        g.add_edge(u, v)
    meta = {}
    pj = model_dir / "parameters.json"
    if pj.exists():
        meta = json.loads(pj.read_text())

    physical = meta.get("physical_nodes")
    layout = None
    if physical and len(physical) == graph.n:
        qpu = meta.get("qpu", "Advantage2_system1")
        full = _FULL_GRAPH_CACHE.get(qpu)
        if full is None:
            full = graph_for_qpu(qpu)
            _FULL_GRAPH_CACHE[qpu] = full
        pos = full.pos
        if all(p in pos for p in physical):
            raw = {i: pos[p] for i, p in enumerate(physical)}
            xs = [v[0] for v in raw.values()]
            ys = [v[1] for v in raw.values()]
            sx = (max(xs) - min(xs)) or 1.0
            sy = (max(ys) - min(ys)) or 1.0
            layout = {
                i: ((x - min(xs)) / sx, (y - min(ys)) / sy)
                for i, (x, y) in raw.items()
            }
    if layout is None:
        layout = {k: (float(v[0]), float(v[1])) for k, v in spring_layout(g, seed=0).items()}
    return topology_figure(g, layout, latent_values)
