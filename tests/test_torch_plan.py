"""Port parity: the host-side plan layer and the config.

The PyTorch port copies the JAX package's numpy plan code and config
schema; these tests hold them to the same results on the shipped
checkpoint's graph and on small hardware subgraphs.  Plans must agree
exactly: every later parity test feeds one side's padded coordinates to
the other.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.io.torch_pth import grbm_from_state_dict as jax_grbm_from_sd
from image_generation_tpu.io.torch_pth import load_state_dict as jax_load_sd
from image_generation_tpu.models.grbm import GRBMGraph as JaxGraph
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.utils.coloring import greedy_coloring as jax_greedy
from image_generation_tpu.utils.subgraph import select_latent_graph
from image_generation_tpu.utils.topology import chimera_graph, zephyr_graph
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.utils.coloring import greedy_coloring

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"


def _checkpoint_graph():
    _, g = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    return g


def _graphs():
    """name → JAX GRBMGraph: the checkpoint's latent graph and two small
    hardware subgraphs."""
    chim, _ = select_latent_graph(chimera_graph(2, 2, 3), 12, 11)
    zeph, _ = select_latent_graph(zephyr_graph(3), 64, 3)
    return {
        "checkpoint": _checkpoint_graph(),
        "chimera12": JaxGraph.from_networkx(chim),
        "zephyr64": JaxGraph.from_networkx(zeph),
    }


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


def _port(g):
    return GRBMGraph(n=g.n, edge_i=g.edge_i, edge_j=g.edge_j)


def _assert_same_plan(tp, jp):
    assert tp.n == jp.n and tp.n_pad == jp.n_pad
    assert tp.blocks == jp.blocks
    assert tp.block_class == jp.block_class
    np.testing.assert_array_equal(tp.orig_to_perm, jp.orig_to_perm)
    np.testing.assert_array_equal(tp.perm_edge_i, jp.perm_edge_i)
    np.testing.assert_array_equal(tp.perm_edge_j, jp.perm_edge_j)
    np.testing.assert_array_equal(tp.valid_mask, jp.valid_mask)


def test_checkpoint_plan_shape(graphs):
    """The shipped checkpoint: 256 spins, 1,976 couplers, 5 color blocks,
    n_pad 640 at pad_to=128 (what the serving kernel is sized for)."""
    g = graphs["checkpoint"]
    plan = tgibbs.build_plan(_port(g))
    assert (plan.n, g.n_edges, len(plan.blocks), plan.n_pad) == (256, 1976, 5, 640)
    assert [v - s for s, v, _ in plan.blocks] == [72, 68, 67, 37, 12]


@pytest.mark.parametrize("name", ["checkpoint", "chimera12", "zephyr64"])
@pytest.mark.parametrize("pad_to,max_class", [(128, None), (16, None), (1, 8)])
def test_plan_matches_jax(graphs, name, pad_to, max_class):
    g = graphs[name]
    _assert_same_plan(
        tgibbs.build_plan(_port(g), pad_to=pad_to, max_class=max_class),
        jgibbs.build_plan(g, pad_to=pad_to, max_class=max_class),
    )


@pytest.mark.parametrize("name", ["checkpoint", "zephyr64"])
def test_class_spans_match_jax(graphs, name):
    g = graphs[name]
    assert tgibbs.class_spans(tgibbs.build_plan(_port(g), max_class=16)) == (
        jgibbs.class_spans(jgibbs.build_plan(g, max_class=16))
    )


@pytest.mark.parametrize("name", ["checkpoint", "chimera12", "zephyr64"])
def test_greedy_coloring_matches_jax(graphs, name):
    g = graphs[name]
    ref = jax_greedy(g.to_networkx())
    ours = greedy_coloring(g.n, g.edge_i, g.edge_j)
    assert ours.tolist() == [ref[v] for v in range(g.n)]


def test_greedy_coloring_is_proper_on_isolated_nodes():
    colors = greedy_coloring(5, [0, 1], [1, 2])
    assert colors.tolist() == [1, 0, 1, 0, 0]


def test_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainingConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == ref


@pytest.mark.parametrize("kwargs", [
    {},
    {"GRAPH_SHARDED": True},
    {"USE_PALLAS": False},
    {"ADAM_FACTORED_NU": True},
    {"PT_ADAPT": False},
    {"PT_BETAS": [0.25, 0.5, 1.0]},
    {"PT_NUM_BETAS": "auto"},
    {"USE_PALLAS": "maybe"},
    {"SAMPLER_MATMUL_DTYPE": "fp8"},
    {"ADAM_MOMENT_DTYPE": "float16"},
    {"PT_BETAS": [0.5, 0.25, 1.0]},
    {"PT_NUM_BETAS": 1},
    {"PT_ADAPT": "step"},
])
def test_config_validation_matches_jax(kwargs):
    def build(cls):
        try:
            return dataclasses.asdict(cls(**kwargs))
        except ValueError as e:
            return ("ValueError", str(e))

    assert build(TrainingConfig) == build(JaxConfig)


@pytest.mark.parametrize("dtype", ["auto", "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n", [256, 640, 2048, 6016])
def test_serving_and_dtype_policies_match_jax(dtype, n):
    ours = TrainingConfig(SAMPLER_MATMUL_DTYPE=dtype)
    ref = JaxConfig(SAMPLER_MATMUL_DTYPE=dtype)
    assert ours.for_serving(n).SAMPLER_MATMUL_DTYPE == ref.for_serving(n).SAMPLER_MATMUL_DTYPE
    t, j = ours.resolved_sampler_matmul_dtype(n), ref.resolved_sampler_matmul_dtype(n)
    assert (t is None) == (j is None)
    if t is not None:
        assert str(t).removeprefix("torch.") == np.dtype(j).name


def test_for_serving_dir_reads_checkpoint():
    assert TrainingConfig().for_serving_dir(MODEL).SAMPLER_MATMUL_DTYPE == "auto"
    assert TrainingConfig().for_serving_dir(MODEL) == TrainingConfig()


def test_yaml_round_trips_between_packages(tmp_path):
    kw = dict(NUM_READS=64, PT_BETAS=(0.5, 1.0), USE_PALLAS="off")
    TrainingConfig(**kw).to_yaml(tmp_path / "t.yaml")
    JaxConfig(**kw).to_yaml(tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    ours = TrainingConfig.from_yaml(tmp_path / "j.yaml", GIBBS_SWEEPS=3)
    ref = JaxConfig.from_yaml(tmp_path / "t.yaml", GIBBS_SWEEPS=3)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.GIBBS_SWEEPS == 3 and ours.USE_PALLAS == "off"
