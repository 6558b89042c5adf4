"""Port parity: QPU topologies, latent-graph selection and the graph cache.

The port builds its graphs without networkx; the selection of the latent
graph depends on node and neighbour iteration order, so everything here
is compared exactly: node order, edge order, the physical mapping, and
the sampling plan built on the flagship selection.
"""

import numpy as np
import pytest

from image_generation_tpu.models.grbm import GRBMGraph as JaxGRBMGraph
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.utils import subgraph as jsub
from image_generation_tpu.utils import topology as jtopo
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.utils import graph_cache as tcache
from image_generation_tpu_torch.utils import subgraph as tsub
from image_generation_tpu_torch.utils import topology as ttopo

SEED = 775321899904  # TrainingConfig.RANDOM_SEED


@pytest.fixture(scope="module")
def flagship():
    """The flagship selection in both packages: Advantage2_system1, 256
    latents, the default seed."""
    jlat, jmap = jsub.select_latent_graph(jtopo.graph_for_qpu("Advantage2_system1"), 256, SEED)
    tlat, tmap = tsub.select_latent_graph(ttopo.graph_for_qpu("Advantage2_system1"), 256, SEED)
    return jlat, jmap, tlat, tmap


@pytest.mark.parametrize("qpu", sorted(ttopo.QPU_TOPOLOGIES) + ["unknown_qpu"])
def test_graph_for_qpu_matches_networkx_order(qpu):
    j = jtopo.graph_for_qpu(qpu)
    t = ttopo.graph_for_qpu(qpu)
    assert t.nodes() == list(j.nodes())
    assert list(t.edges()) == list(j.edges())
    for n in list(j.nodes())[::97]:
        assert list(t.neighbors(n)) == list(j.neighbors(n))
    assert t.graph["family"] == j.graph["family"]


@pytest.mark.parametrize("make", [
    lambda m: m.chimera_graph(2, 3, 2),
    lambda m: m.pegasus_graph(3, fabric_only=False),
    lambda m: m.zephyr_graph(2, 2),
])
def test_small_topologies_match(make):
    j, t = make(jtopo), make(ttopo)
    assert t.nodes() == list(j.nodes()) and list(t.edges()) == list(j.edges())


def test_flagship_selection_matches_jax(flagship):
    jlat, jmap, tlat, tmap = flagship
    assert list(tmap.items()) == list(jmap.items())
    assert tlat.nodes() == list(jlat.nodes())
    assert list(tlat.edges()) == list(jlat.edges())


@pytest.mark.parametrize("n,seed", [(12, 11), (40, 3), (100, 0), (128, 5)])
def test_small_selections_match_jax(n, seed):
    """Below and above half the graph (the subgraph view iterates its node
    set in the first cases and the graph's order in the others; 128 is
    the whole graph, a copy)."""
    j, jmap = jsub.select_latent_graph(jtopo.chimera_graph(4, 4, 4), n, seed)
    t, tmap = tsub.select_latent_graph(ttopo.chimera_graph(4, 4, 4), n, seed)
    assert list(tmap.items()) == list(jmap.items())
    assert list(t.edges()) == list(j.edges())


def test_flagship_graph_and_plan_counts(flagship):
    """256 spins, 2,327 couplers, 6 color blocks of 63/62/70/44/14/3 real
    spins, n_pad 768 at pad_to 128, in both packages."""
    jlat, _, tlat, _ = flagship
    jg = JaxGRBMGraph.from_networkx(jlat)
    tg = tcache.graph_from_topology(tlat)
    np.testing.assert_array_equal(tg.edge_i, jg.edge_i)
    np.testing.assert_array_equal(tg.edge_j, jg.edge_j)
    jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    assert (tg.n, tg.n_edges, tplan.n_pad) == (256, 2327, 768)
    assert [v - s for s, v, _e in tplan.blocks] == [63, 62, 70, 44, 14, 3]
    assert tplan.blocks == jplan.blocks
    np.testing.assert_array_equal(tplan.orig_to_perm, jplan.orig_to_perm)


def test_graph_cache_round_trip_and_layout(tmp_path, monkeypatch):
    monkeypatch.setenv("IMGGEN_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("IMGGEN_NO_GRAPH_CACHE", raising=False)
    g1, phys1 = tcache.cached_latent_graph("Advantage2_prototype", 32, SEED)
    path = tmp_path / f"Advantage2_prototype_32_{SEED}_v2.npz"
    assert path.exists()
    with np.load(path) as z:
        assert sorted(z.files) == ["edge_i", "edge_j", "n", "physical"]
    g2, phys2 = tcache.cached_latent_graph("Advantage2_prototype", 32, SEED)
    np.testing.assert_array_equal(g1.edge_i, g2.edge_i)
    assert phys1 == phys2 and len(phys1) == 32
    # the same selection as the JAX package makes
    jlat, jmap = jsub.select_latent_graph(jtopo.graph_for_qpu("Advantage2_prototype"), 32, SEED)
    jg = JaxGRBMGraph.from_networkx(jlat)
    np.testing.assert_array_equal(g1.edge_i, jg.edge_i)
    assert phys1 == [p for p, _l in sorted(jmap.items(), key=lambda kv: kv[1])]
    # the switch turns the cache off
    monkeypatch.setenv("IMGGEN_NO_GRAPH_CACHE", "1")
    path.unlink()
    tcache.cached_latent_graph("Advantage2_prototype", 32, SEED)
    assert not path.exists()
