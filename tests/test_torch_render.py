"""Port parity: the server-side renderers (``app/render.py``), on the CPU.

Each SVG / HTML renderer returns the JAX renderer's string on the same
figure, dict or values; ``render_heatmap_png`` (zlib, no PIL in the port)
decodes, through PIL here, to JAX's pixels at scale 1 and 3, for a uint8
figure (zmax 255) and a float one (zmax 1.0), with and without
``reversescale``.  The contracts of ``tests/test_render.py`` run against
the port too.
"""

import io

import numpy as np
import pytest
from PIL import Image

from image_generation_tpu.app import render as jrender
from image_generation_tpu.app.figures import imshow_figure as jax_imshow
from image_generation_tpu.app.figures import loss_figure as jax_loss
from image_generation_tpu.app.figures import topology_figure as jax_topology_figure
from image_generation_tpu.utils import topology as jtopo
from image_generation_tpu_torch.app import render
from image_generation_tpu_torch.app.figures import imshow_figure, loss_figure, topology_figure
from image_generation_tpu_torch.utils import topology as ttopo


def _pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _heatmap(kind: str, reverse: bool) -> dict:
    img = np.random.default_rng(0).uniform(size=(9, 7))
    img[0, :3] = (0.0, 1.0, 0.5)
    if kind == "uint8":
        fig = imshow_figure(img[..., None])
    else:  # an older float figure: zmax 1.0
        fig = {"data": [{"z": np.flipud(img).tolist(), "zmin": 0.0, "zmax": 1.0}]}
    fig["data"][0]["reversescale"] = reverse
    return fig


@pytest.mark.parametrize("kind", ["uint8", "float"])
@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("scale", [1, 3])
def test_heatmap_png_pixels_equal_jax(kind, reverse, scale):
    fig = _heatmap(kind, reverse)
    png = render.render_heatmap_png(fig, scale=scale)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    got, want = _pixels(png), _pixels(jrender.render_heatmap_png(fig, scale=scale))
    assert got.shape == want.shape == (9 * scale, 7 * scale)
    np.testing.assert_array_equal(got, want)


def test_heatmap_png_roundtrip_and_errors():
    img = np.linspace(0, 1, 16, dtype=np.float64).reshape(4, 4)
    px = _pixels(render.render_heatmap_png(imshow_figure(img[..., None])))
    np.testing.assert_array_equal(px, np.round(img * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        render.render_heatmap_png({"data": [{"z": []}]})


@pytest.mark.parametrize("ys", [[3.0, 1.0, 2.0], [], [2.0, 2.0], list(np.linspace(5, 0.1, 40))])
def test_loss_svg_equals_jax(ys):
    for kw in ({}, {"color": "#112233", "width": 100, "height": 50}):
        assert render.render_loss_svg(loss_figure(ys), **kw) == \
            jrender.render_loss_svg(jax_loss(ys), **kw)


def test_topology_svg_equals_jax():
    jg, pg = jtopo.zephyr_graph(2), ttopo.zephyr_graph(2)
    vals = [1.0 if i % 3 else -1.0 for i in range(pg.number_of_nodes())]
    for v in (None, vals):
        want = jrender.render_topology_svg(jax_topology_figure(jg, jtopo.graph_layout(jg), v))
        got = render.render_topology_svg(topology_figure(pg, ttopo.graph_layout(pg), v))
        assert got == want
    svg = render.render_topology_svg(topology_figure(pg, ttopo.graph_layout(pg), vals))
    assert svg.count("<circle") == pg.number_of_nodes()
    assert svg.count("<line") == sum(1 for _ in pg.edges())


@pytest.mark.parametrize("values", [[1, -1, -1, 1, -1] + [1] * 250 + [-1], [], [1.0, -1.0, 1.0]])
def test_latent_strip_equals_jax(values):
    assert render.latent_strip_svg(values) == jrender.latent_strip_svg(values)


@pytest.mark.parametrize("meta", [
    {"qpu": "Advantage2_system1", "n_epochs": 10, "n_latents": 256, "batch_size": 128,
     "data_source": "mnist-idx"},
    {"qpu": "x<y"},
    {},
])
def test_model_data_html_equals_jax(meta):
    assert render.model_data_html(meta) == jrender.model_data_html(meta)


def test_problem_details_html_equals_jax():
    details = {"QPU": "Advantage2_system1", "Epoch": "3/10", "MSE <Loss>": 0.07, "n": 5}
    html = render.problem_details_html(details)
    assert html == jrender.problem_details_html(details)
    assert "<th>MSE &lt;Loss&gt;</th>" in html and html.count("<tr>") == 2


def test_renderers_consume_written_figures(tmp_path):
    from image_generation_tpu_torch.app.files import RunFiles

    rf = RunFiles(tmp_path)
    grid = np.random.default_rng(0).uniform(size=(8, 8, 1))
    rf.write_epoch(2, grid, grid, [1.0, 0.5], [2.0, 1.0])
    fig = rf.read_epoch_figure("generated", 2)
    assert _pixels(render.render_heatmap_png(fig)).shape == (8, 8)
    assert "<polyline" in render.render_loss_svg(rf.read_epoch_figure("loss_mse", 2))
