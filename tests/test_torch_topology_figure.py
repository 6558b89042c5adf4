"""Port parity: plotting positions, ``graph_layout``, the numpy spring
layout and the model topology figures, without networkx, on the CPU.

The JAX package (networkx graphs, ``nx.spring_layout``) is the oracle:
the generators' positions are equal bit for bit for every entry of
``QPU_TOPOLOGIES``; ``graph_layout`` within 1e-12; the spring layout
within 1e-9 of ``nx.spring_layout(g, seed=0)`` (the same numpy steps);
``model_topology_figure`` of both shipped checkpoints (the physical-
coordinate branch for ``tpu_digits_40_epochs``, the spring-layout branch
for ``tpu_digits_10_epochs``, which has no ``physical_nodes``), with and
without latent values: every trace's ``x`` / ``y`` within 1e-9 with the
``None`` separators in place, colours and text equal.
"""

from pathlib import Path

import networkx as nx
import numpy as np
import pytest

from image_generation_tpu.app.figures import model_topology_figure as jax_model_figure
from image_generation_tpu.app.figures import topology_figure as jax_topology_figure
from image_generation_tpu.utils import topology as jtopo
from image_generation_tpu_torch.app import figures
from image_generation_tpu_torch.utils import topology as ttopo
from image_generation_tpu_torch.utils.layout import spring_layout

ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "runs" / "models"


def _port_graph(n, edges):
    g = ttopo.Graph()
    for i in range(n):
        g.add_node(i)
    for u, v in edges:
        g.add_edge(u, v)
    return g


def _nx_graph(n, edges):
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from(edges)
    return g


@pytest.mark.parametrize("qpu", sorted(ttopo.QPU_TOPOLOGIES))
def test_positions_equal_jax_bit_for_bit(qpu):
    jg = jtopo.graph_for_qpu(qpu)
    pg = ttopo.graph_for_qpu(qpu)
    jpos = nx.get_node_attributes(jg, "pos")
    assert list(jpos) == pg.nodes()
    for node, p in jpos.items():
        q = pg.pos[node]
        assert q == p and tuple(map(type, q)) == tuple(map(type, p)), (node, p, q)
    jl, pl = jtopo.graph_layout(jg), ttopo.graph_layout(pg)
    assert list(jl) == list(pl)
    err = max(max(abs(jl[n][0] - pl[n][0]), abs(jl[n][1] - pl[n][1])) for n in jl)
    assert err <= 1e-12


def _latent_edges(model):
    from image_generation_tpu_torch.io.torch_pth import grbm_from_state_dict, load_state_dict

    _, graph = grbm_from_state_dict(load_state_dict(MODELS / model / "grbm.pth"))
    return graph.n, list(zip(graph.edge_i.tolist(), graph.edge_j.tolist()))


def _ring_with_chords():
    return 12, [(i, (i + 1) % 12) for i in range(12)] + [(0, 5), (2, 9), (3, 7)]


@pytest.mark.parametrize("case", ["latent_256", "ring_12"])
def test_spring_layout_matches_networkx(case):
    n, edges = _latent_edges("tpu_digits_10_epochs") if case == "latent_256" else _ring_with_chords()
    want = nx.spring_layout(_nx_graph(n, edges), seed=0)
    got = spring_layout(_port_graph(n, edges), seed=0)
    assert list(got) == list(want)
    err = max(float(np.abs(np.asarray(got[k]) - want[k]).max()) for k in want)
    assert err <= 1e-9, err


def test_graph_layout_without_positions_uses_the_spring_layout():
    n, edges = _ring_with_chords()
    want = jtopo.graph_layout(_nx_graph(n, edges))
    got = ttopo.graph_layout(_port_graph(n, edges))
    assert list(got) == list(want)
    assert max(max(abs(got[k][0] - want[k][0]), abs(got[k][1] - want[k][1])) for k in want) <= 1e-9


def test_spring_layout_refuses_the_energy_method():
    """From 500 nodes networkx switches to its scipy "energy" method."""
    g = ttopo.zephyr_graph(4)  # 576 nodes
    assert g.number_of_nodes() >= 500
    with pytest.raises(NotImplementedError, match="energy"):
        spring_layout(g, seed=0)
    small = _port_graph(499, [(i, i + 1) for i in range(498)])
    assert len(spring_layout(small, seed=0, iterations=1)) == 499


def _assert_figures_match(want, got):
    assert len(want["data"]) == len(got["data"]) == 2
    for tw, tg in zip(want["data"], got["data"]):
        for key in ("x", "y"):
            assert len(tw[key]) == len(tg[key])
            for a, b in zip(tw[key], tg[key]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert abs(a - b) <= 1e-9, (key, a, b)
        rest_w = {k: v for k, v in tw.items() if k not in ("x", "y")}
        rest_g = {k: v for k, v in tg.items() if k not in ("x", "y")}
        assert rest_w == rest_g  # colours, text, line and marker styles
    assert want["layout"] == got["layout"]


@pytest.mark.parametrize("model", ["tpu_digits_40_epochs", "tpu_digits_10_epochs"])
@pytest.mark.parametrize("with_values", [False, True])
def test_model_topology_figure_matches_jax(model, with_values):
    import json

    meta = json.loads((MODELS / model / "parameters.json").read_text())
    assert ("physical_nodes" in meta) == (model == "tpu_digits_40_epochs")  # both branches
    values = None
    if with_values:
        values = np.where(np.random.default_rng(3).random(256) > 0.5, 1.0, -1.0).tolist()
    _assert_figures_match(jax_model_figure(MODELS / model, values),
                          figures.model_topology_figure(MODELS / model, values))


def test_topology_figure_of_a_generator_graph_matches_jax():
    jg, pg = jtopo.zephyr_graph(2), ttopo.zephyr_graph(2)
    vals = [1.0 if i % 2 else -1.0 for i in range(pg.number_of_nodes())]
    _assert_figures_match(jax_topology_figure(jg, jtopo.graph_layout(jg), vals),
                          figures.topology_figure(pg, ttopo.graph_layout(pg), vals))
