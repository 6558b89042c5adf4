"""Port parity: the graph-sharded sampler, its packing, K4's plain version
and graph-sharded training, on the CPU.

The port's ranks run as threads, each with its own gloo process group
over one in-memory store (``ProcessGroupGloo(PrefixStore(..., HashStore()),
rank, P)``) and its ``Mesh((1, P))``; the JAX side runs on its 8-device CPU
mesh (tests/conftest.py) with a (1, P) mesh, so both split the graph P
ways.  Inputs are made with numpy and handed to both.

Tolerances.  The sweep is bit-identical to the JAX sweep fed its own
threefry stream (``xla_stream_uniforms``) on the JAX tests' 64-spin Zephyr
fixture, whose couplings lie on a 1/256 grid: every partial sum is exact in
f32, so the order of the products and of the all-reduce cannot change a
field (tests/test_graph_sharded_pallas.py:31-44); ΔE within 1e-6
relative (the JAX body sums a masked window, the port the owned columns).
Energies within 1e-5 relative (f32 sums in another order).  Quantization
and packing are bit-identical.  The training step's MSE does not depend on
the sampler and is held at rtol 1e-4 against the JAX single-device step
(tests/test_graph_sharded.py:284); with JAX's draws fed, the chains follow
the chain rule of tests/test_torch_gibbs.py (≥ 98 % bit-identical) and the
NLL 1e-5.
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch
import torch.distributed as dist

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import block_sparse_sharded as jbss
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import gibbs_graph_sharded as jgs
from image_generation_tpu.ops.exact import exact_moments
from image_generation_tpu.ops.gibbs_graph_sharded_pallas import (
    make_pallas_update,
    xla_stream_uniforms,
)
from image_generation_tpu.ops.quant import quantize_coupling as jquantize
from image_generation_tpu.parallel.mesh import create_mesh as jcreate_mesh
from image_generation_tpu.training import step as jstep
from image_generation_tpu.utils.subgraph import select_latent_graph
from image_generation_tpu.utils.topology import zephyr_graph
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io import native_ckpt
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import block_sparse_sharded as tbss
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_graph_sharded as tgs
from image_generation_tpu_torch.ops.gibbs_cuda import philox_uniforms
from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
    philox_span_uniforms,
    span_update,
    span_update_reference,
)
from image_generation_tpu_torch.ops.quant import QuantCoupling, quantize_coupling
from image_generation_tpu_torch.parallel.mesh import Mesh, shard_train_state
from image_generation_tpu_torch.training.step import (
    make_sample_fns,
    make_train_fns,
    train_state_from_jax,
)
from image_generation_tpu_torch.training.trainer import Trainer
from test_torch_training import SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401
from torch_ranks import run_ranks

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread for this module (the suite runs
    six worker processes at once), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def medium():
    """The JAX tests' 64-spin Zephyr subgraph with h and J on a 1/256 grid
    (order-exact in f32): (JAX graph, JAX plan, port plan, hp, A) numpy."""
    g, _ = select_latent_graph(zephyr_graph(2), 64, 3)
    jg = jgrbm.GRBMGraph.from_networkx(g)
    rng = np.random.RandomState(7)
    h = (np.round(rng.uniform(-0.3, 0.3, jg.n) * 256) / 256).astype(np.float32)
    j = (np.round(rng.uniform(-0.5, 0.5, jg.n_edges) * 256) / 256).astype(np.float32)
    jplan = jgibbs.build_plan(jg)
    tplan = tgibbs.build_plan(tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j))
    hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    assert jplan.n_pad == tplan.n_pad and jplan.n_pad % 4 == 0
    return jg, jplan, tplan, np.asarray(hp), np.asarray(a), h, j


def _form(a_np, form, plan, mesh=None, chunk=16):
    """The port's coupling of this rank (``mesh``) or whole (None)."""
    if mesh is None:
        a = torch.from_numpy(a_np)
        return quantize_coupling(a) if form == "int8" else a
    lo, hi = mesh.window(plan.n_pad)
    rows = torch.from_numpy(a_np[lo:hi].copy())
    if form in ("int8", "packed_int8"):
        rows = quantize_coupling(rows, mesh=mesh)
    if form.startswith("packed"):
        rows = tbss.pack_coupling_graph_sharded(plan, rows, mesh, chunk)
    return rows


def _jax_form(a_np, form, plan, jmesh, chunk=16):
    """The JAX coupling (jitted: the eager packing runs op by op, ~10 s)."""
    def build(a):
        if form in ("int8", "packed_int8"):
            a = jquantize(a)
        if form.startswith("packed"):
            a = jbss.pack_coupling_graph_sharded(plan, a, jmesh, chunk=chunk)
        return a

    return jax.jit(build)(jnp.asarray(a_np))


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [2, 4])
@pytest.mark.parametrize("form", ["dense", "int8", "packed"])
def test_sweep_bit_identical_to_jax(medium, form, axis):
    """Fed the JAX body's own threefry stream, the port's sweep on P
    threaded ranks is bit-identical to ``gibbs_sweeps_graph_sharded`` on a
    (1, P) mesh (packed at chunk 16 with ΔE, as the JAX tests run it)."""
    _jg, jplan, tplan, hp, a, _h, _j = medium
    n_chains, n_sweeps = 32, 4
    key = jax.random.PRNGKey(3)
    s0 = np.asarray(jgibbs.random_spins(jax.random.PRNGKey(4), jplan, n_chains))
    jmesh = jcreate_mesh(axis, shape=(1, axis))
    track = form == "packed"
    ref = jax.jit(lambda c, s: jgs.gibbs_sweeps_graph_sharded(
        key, jnp.asarray(hp), c, jplan, s, n_sweeps, jmesh, track_delta_e=track))(
        _jax_form(a, form, jplan, jmesh), jnp.asarray(s0))
    u = _t(xla_stream_uniforms(key, jplan, n_chains, n_sweeps))

    def rank(mesh):
        lo, hi = mesh.window(tplan.n_pad)
        return tgs.gibbs_sweeps_graph_sharded(
            _t(hp), _form(a, form, tplan, mesh), tplan, _t(s0[:, lo:hi]), n_sweeps, mesh,
            uniforms=u, track_delta_e=track)

    outs = run_ranks(axis, rank)
    if track:
        ref, de_ref = ref
        des = [o[1] for o in outs]
        outs = [o[0] for o in outs]
        for de in des:
            np.testing.assert_allclose(de.numpy(), np.asarray(de_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(torch.cat(outs, 1).numpy(), np.asarray(ref))


def test_per_chain_beta_and_plain_update_match_jax(medium):
    """Per-chain β, through K4's plain version and through the plain
    update (``USE_PALLAS="off"``): both bit-identical to JAX."""
    _jg, jplan, tplan, hp, a, _h, _j = medium
    n_chains, n_sweeps = 16, 3
    beta = np.random.default_rng(2).uniform(0.3, 2.0, n_chains).astype(np.float32)
    key = jax.random.PRNGKey(9)
    s0 = np.asarray(jgibbs.random_spins(jax.random.PRNGKey(10), jplan, n_chains))
    jmesh = jcreate_mesh(2, shape=(1, 2))
    ref = jgs.gibbs_sweeps_graph_sharded(key, jnp.asarray(hp), jnp.asarray(a), jplan,
                                         jnp.asarray(s0), n_sweeps, jmesh, beta=jnp.asarray(beta))
    u = _t(xla_stream_uniforms(key, jplan, n_chains, n_sweeps))
    for use_kernel in (True, False):
        def rank(mesh):
            lo, hi = mesh.window(tplan.n_pad)
            return tgs.gibbs_sweeps_graph_sharded(
                _t(hp), _t(a[lo:hi].copy()), tplan, _t(s0[:, lo:hi]), n_sweeps, mesh,
                _t(beta), uniforms=u, use_kernel=use_kernel)

        np.testing.assert_array_equal(torch.cat(run_ranks(2, rank), 1).numpy(), np.asarray(ref))


def test_philox_stream_agrees_across_ranks_and_meshes(medium):
    """K4's Philox stream (its plain version here) is keyed by global
    column and row: the ranks of a graph axis draw the same update, and
    the sweep is the same chain at graph axis 2 and 4, equal to the plain
    sweep fed ``philox_uniforms`` (counter (column, row, sweep, 0))."""
    _jg, _jplan, tplan, hp, a, _h, _j = medium
    s0 = np.random.default_rng(3).choice([-1.0, 1.0], (8, tplan.n_pad)).astype(np.float32)
    seed_state = torch.Generator().manual_seed(5).get_state()

    def run(axis):
        def rank(mesh):
            lo, hi = mesh.window(tplan.n_pad)
            g = torch.Generator()
            g.set_state(seed_state)
            return tgs.gibbs_sweeps_graph_sharded(
                _t(hp), _t(a[lo:hi].copy()), tplan, _t(s0[:, lo:hi]), 3, mesh, generator=g)

        return torch.cat(run_ranks(axis, rank), 1)

    two, four = run(2), run(4)
    assert torch.equal(two, four)
    g = torch.Generator()
    g.set_state(seed_state)
    seed = int(torch.randint(0, 2**62, (1,), generator=g, dtype=torch.int64))
    u = _t(philox_uniforms(seed, 3, 8, tplan.n_pad))

    def fed(mesh):
        lo, hi = mesh.window(tplan.n_pad)
        return tgs.gibbs_sweeps_graph_sharded(_t(hp), _t(a[lo:hi].copy()), tplan,
                                              _t(s0[:, lo:hi]), 3, mesh, uniforms=u)

    assert torch.equal(torch.cat(run_ranks(2, fed), 1), two)


def test_philox_moments_match_exact():
    """Stationary moments of a 12-spin graph under K4's Philox stream,
    fed through the plain sweep on 2 ranks, against exact enumeration."""
    g = nx.cycle_graph(12)
    g.add_edges_from([(i, i + 4) for i in range(0, 8, 2)] + [(1, 7), (3, 9)])
    jg = jgrbm.GRBMGraph.from_networkx(g)
    tplan = tgibbs.build_plan(tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j),
                              pad_to=8)
    rng = np.random.default_rng(4)
    h = rng.uniform(-0.3, 0.3, jg.n).astype(np.float32)
    j = rng.uniform(-0.5, 0.5, jg.n_edges).astype(np.float32)
    hp, a = tgibbs.permuted_model(tplan, torch.from_numpy(h), torch.from_numpy(j))
    assert tplan.n_pad % 2 == 0
    chains, sweeps = 1024, 60
    s0 = torch.from_numpy(rng.choice([-1.0, 1.0], (chains, tplan.n_pad)).astype(np.float32))
    u = _t(philox_uniforms(12345, sweeps, chains, tplan.n_pad))

    def rank(mesh):
        lo, hi = mesh.window(tplan.n_pad)
        return tgs.gibbs_sweeps_graph_sharded(hp, a[lo:hi].contiguous(), tplan,
                                              s0[:, lo:hi].contiguous(), sweeps, mesh,
                                              uniforms=u)

    s = tgibbs.to_original(tplan, torch.cat(run_ranks(2, rank), 1)).double().numpy()
    e1, e2 = exact_moments(h, jg.edge_i, jg.edge_j, j)
    np.testing.assert_allclose(s.mean(0), e1, atol=0.1)
    np.testing.assert_allclose((s[:, jg.edge_i] * s[:, jg.edge_j]).mean(0), e2, atol=0.1)


# ---------------------------------------------------------------------------
# energies, quantization, packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [2, 4])
@pytest.mark.parametrize("lead", [(8,), (3, 4)])
@pytest.mark.parametrize("form", ["dense", "bf16", "int8", "packed", "packed_int8"])
def test_energies_match_jax(medium, form, lead, axis):
    """(C, n) chains and the (T, C, n) ladder on every coupling form, at
    graph axis 2 and 4: the port's reduce-scatter of the partial S@A
    (``Mesh.reduce_scatter``) against the JAX ``psum_scatter``."""
    _jg, jplan, tplan, hp, a, _h, _j = medium
    spins = np.random.default_rng(1).choice([-1.0, 1.0], lead + (tplan.n_pad,)).astype(np.float32)
    jmesh = jcreate_mesh(axis, shape=(1, axis))
    mm = jnp.bfloat16 if form == "bf16" else None
    ref = jax.jit(lambda c, s: jgs.ising_energies_graph_sharded(
        jnp.asarray(hp), c, s, jmesh, matmul_dtype=mm))(
        _jax_form(a, "dense" if form == "bf16" else form, jplan, jmesh), jnp.asarray(spins))

    def rank(mesh):
        lo, hi = mesh.window(tplan.n_pad)
        c = _form(a, "dense" if form == "bf16" else form, tplan, mesh)
        if form == "bf16":
            c = c.to(torch.bfloat16)
        return tgs.ising_energies_graph_sharded(_t(hp), c, _t(spins[..., lo:hi]), mesh,
                                                matmul_dtype=torch.bfloat16 if mm else None)

    outs = run_ranks(axis, rank)
    for e in outs:
        assert tuple(e.shape) == lead
        np.testing.assert_allclose(e.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [2, 4])
def test_shard_quantization_matches_whole_matrix(axis):
    """Each rank quantizes its rows at the all-reduced max|J|: scale and
    int8 rows bit-identical to JAX's ``quantize_coupling`` of the whole
    matrix (a matrix whose largest entry lies in one shard only)."""
    a = np.random.default_rng(axis).normal(size=(64, 64)).astype(np.float32)
    a = a + a.T
    a[5, 60] = a[60, 5] = 9.0
    ref = jquantize(jnp.asarray(a))

    def rank(mesh):
        lo, hi = mesh.window(64)
        return quantize_coupling(torch.from_numpy(a[lo:hi].copy()), mesh=mesh)

    outs = run_ranks(axis, rank)
    for qc in outs:
        assert float(qc.scale) == float(ref.scale)
    np.testing.assert_array_equal(torch.cat([qc.q for qc in outs]).numpy(), np.asarray(ref.q))


@pytest.mark.parametrize("axis,chunk", [(2, 16), (4, 16), (4, 32)])
@pytest.mark.parametrize("quant", [False, True])
def test_shard_packing_matches_jax(medium, axis, chunk, quant):
    """Per-rank panels and offsets equal the JAX shard's (rows
    [g·total·chunk, (g+1)·total·chunk) of its stacked panels, row g of its
    offsets), and ``sharded_chunk_meta`` equals JAX's."""
    _jg, jplan, tplan, _hp, a, _h, _j = medium
    jmesh = jcreate_mesh(axis, shape=(1, axis))
    form = "packed_int8" if quant else "packed"
    ref = _jax_form(a, form, jplan, jmesh, chunk)
    jmeta = jbss.sharded_chunk_meta(jplan, axis, chunk)
    tmeta = tbss.sharded_chunk_meta(tplan, axis, chunk)
    assert tmeta.kmax == jmeta.kmax and tmeta.occupancy == jmeta.occupancy
    np.testing.assert_array_equal(tmeta.offs, jmeta.offs)
    np.testing.assert_array_equal(tmeta.zero_head, jmeta.zero_head)
    outs = run_ranks(axis, lambda mesh: _form(a, form, tplan, mesh, chunk))
    rows = sum(tmeta.kmax) * chunk
    jp = np.asarray(ref.panels.astype(jnp.float32))
    for g, bsc in enumerate(outs):
        assert bsc.shard == g and bsc.n_shards == axis and bsc.kmax == jmeta.kmax
        assert bsc.offs == tuple(np.asarray(ref.offs)[g].tolist())
        np.testing.assert_array_equal(bsc.panels.to(torch.float32).numpy(),
                                      jp[g * rows:(g + 1) * rows])
        if quant:
            assert bsc.panels.dtype == torch.int8 and float(bsc.scale) == float(ref.scale)


def test_row_block_model_and_shard_train_state(medium):
    """``permuted_model_rows`` equals the rows of ``permuted_model`` bit for
    bit; ``shard_train_state`` cuts chains and coupling to the window and
    refuses a single-device packed coupling."""
    jg, _jplan, tplan, _hp, _a, h, j = medium
    hp, a = tgibbs.permuted_model(tplan, torch.from_numpy(h), torch.from_numpy(j))
    for lo, hi in ((0, tplan.n_pad // 4), (tplan.n_pad // 2, tplan.n_pad)):
        hp_r, rows = tgibbs.permuted_model_rows(tplan, torch.from_numpy(h), torch.from_numpy(j),
                                                lo, hi)
        assert torch.equal(hp_r, hp) and torch.equal(rows, a[lo:hi])
    from types import SimpleNamespace

    from image_generation_tpu_torch.ops.block_sparse import pack_coupling

    mesh = Mesh((1, 4), graph_index=1, graph_group=object(), backend="gloo")
    lo, hi = mesh.window(tplan.n_pad)
    ladder = torch.ones((3, 5, tplan.n_pad))
    st = shard_train_state(SimpleNamespace(chains=ladder, sampler_coupling=quantize_coupling(a)),
                           mesh, graph_sharded=True)
    assert st.chains.shape == (3, 5, hi - lo) and isinstance(st.sampler_coupling, QuantCoupling)
    assert torch.equal(st.sampler_coupling.q, quantize_coupling(a).q[lo:hi])
    with pytest.raises(ValueError, match="rebuild"):
        shard_train_state(SimpleNamespace(chains=ladder, sampler_coupling=pack_coupling(
            tplan, a, 16)), mesh, graph_sharded=True)


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_chain", [False, True])
def test_span_update_reference_matches_pallas_fed(per_chain):
    """``span_update_reference`` against ``make_pallas_update``'s fed
    kernel in interpret mode, bit for bit, at a span of 37 chains × 200
    columns with fields up to ±4."""
    rng = np.random.default_rng(11)
    fields = rng.uniform(-4, 4, (37, 200)).astype(np.float32)
    u = rng.random((37, 200)).astype(np.float32)
    beta = rng.uniform(0.2, 2.0, 37).astype(np.float32) if per_chain else np.float32(0.7)
    beta_col = beta.reshape(-1, 1) if per_chain else beta
    ref = make_pallas_update(interpret=True)(None, jnp.asarray(fields), jnp.asarray(beta_col),
                                             jnp.arange(37), jnp.asarray(u))
    out = span_update_reference(_t(fields), _t(beta), uniforms=_t(u))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # the wrapper's CPU branch is the plain version and counts nothing
    span_update.launches.clear()
    assert torch.equal(span_update(_t(fields), _t(beta), uniforms=_t(u)), out)
    assert not span_update.launches


def test_philox_span_uniforms_are_the_twin_at_an_offset():
    """The Philox entry's plain version draws ``philox_uniforms`` at the
    span's global rows, columns and sweep."""
    full = philox_uniforms(77, 3, 12, 40)
    np.testing.assert_array_equal(philox_span_uniforms(77, 2, 5, 7, 13, 20), full[2, 5:12, 13:33])
    fields = torch.zeros((7, 20))
    out = span_update_reference(fields, 1.0, seed=torch.tensor([77]), row0=5, col0=13, sweep=2)
    assert torch.equal(out, torch.where(torch.from_numpy(full[2, 5:12, 13:33]) < 0.5, 1.0, -1.0))
    with pytest.raises(ValueError, match="exactly one"):
        span_update_reference(fields, 1.0)


# ---------------------------------------------------------------------------
# dispatch and errors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid45():
    """The JAX tests' 45×45 grid (n_pad 2,048): 'auto' block sparsity
    applies, and the 4-way row shard (512 rows) fits chunk 128."""
    g = nx.grid_2d_graph(45, 45)
    g = nx.relabel_nodes(g, {v: i for i, v in enumerate(sorted(g.nodes()))})
    jg = jgrbm.GRBMGraph.from_networkx(g)
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    return jg, jgibbs.build_plan(jg), tg, tgibbs.build_plan(tg)


def _fake_mesh(axis=4):
    return Mesh((1, axis), graph_index=0, graph_group=object(), backend="gloo")


_GRID = dict(N_LATENTS=2025, NUM_READS=64, BATCH_SIZE=4, N_REPLICAS=2, GIBBS_SWEEPS=2,
             GIBBS_BURN_IN=2, SWEEP_BS_CHUNK=128)


@pytest.mark.parametrize("row_seed", ["off", "on"])
@pytest.mark.parametrize("bs", ["auto", "on", "off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("gs", ["on", "auto"])
def test_dispatch_matches_jax(grid45, gs, dtype, bs, row_seed):
    """``sampler_impl`` against JAX ``make_train_fns(mesh=(1, 4),
    USE_PALLAS="on")``, ``pallas`` spelled ``cuda`` and ``xla`` ``torch``;
    at "auto" the grid's coupling is far below 2 GiB, so JAX picks its
    chain-sharded kernels, and so does the port."""
    jg, jplan, tg, tplan = grid45
    kw = dict(_GRID, GRAPH_SHARDED=gs, SAMPLER_MATMUL_DTYPE=dtype, SWEEP_BLOCK_SPARSE=bs,
              PLRNG_ROW_SEED=row_seed)
    jmesh = jcreate_mesh(4, shape=(1, 4))
    for pallas in ("on", "off"):
        jfns = jstep.make_train_fns(JaxConfig(**kw, USE_PALLAS=pallas), jg, 10, jplan,
                                    mesh=jmesh)
        cfg = TrainingConfig(**kw, USE_PALLAS=pallas)
        fns = make_sample_fns(cfg, tg, tplan, device="cpu", mesh=_fake_mesh())
        assert fns.graph_sharded == jfns.graph_sharded == (gs == "on")
        assert fns.sampler_impl == jfns.sampler_impl.replace("pallas", "cuda").replace(
            "xla", "torch")


def test_graph_sharded_errors(grid45, medium):
    """The JAX package's refusals: "on" with no mesh, a graph axis that
    does not tile n_pad, a chunk larger than a row shard; a mesh whose
    axes lack their process groups."""
    _jg, _jplan, tg, tplan = grid45
    with pytest.raises(ValueError, match="no multi-device mesh"):
        make_sample_fns(TrainingConfig(GRAPH_SHARDED="on"), tg, tplan, device="cpu")
    with pytest.raises(ValueError, match="cannot partition"):
        make_sample_fns(TrainingConfig(GRAPH_SHARDED="on"), tg, tplan, device="cpu",
                        mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="does not fit"):
        make_sample_fns(TrainingConfig(**dict(_GRID, GRAPH_SHARDED="on", SWEEP_BLOCK_SPARSE="on",
                                              SWEEP_BS_CHUNK=1024)),
                        tg, tplan, device="cpu", mesh=_fake_mesh())
    with pytest.raises(ValueError, match="data axis"):
        Mesh((2, 2), graph_group=object())
    with pytest.raises(ValueError, match="world group"):
        Mesh((2, 2), graph_group=object(), data_group=object())
    m = Mesh((2, 2), data_index=1, graph_index=0, graph_group=object(), data_group=object(),
             world_group=object())
    assert (m.data, m.graph, m.size, m.rank) == (2, 2, 4, 2)
    _g, _jp, mplan, hp, a, _h, _j = medium
    with pytest.raises(ValueError, match="does not tile"):
        tgs.gibbs_sweeps_graph_sharded(_t(hp), _t(a), mplan, _t(np.ones((2, mplan.n_pad),
                                                                        np.float32)), 1,
                                       _fake_mesh(3))


def test_create_and_auto_mesh_over_an_initialised_world(tmp_path):
    """``auto_mesh`` is None without a process group and on a world of one
    rank (a Trainer then runs on one device); ``create_mesh`` takes the
    world's ranks, defaults to JAX's shape ((1, 1) here) and refuses a shape that does not
    cover the world."""
    from image_generation_tpu_torch.parallel.mesh import auto_mesh, create_mesh

    assert not dist.is_initialized() and auto_mesh() is None
    with pytest.raises(RuntimeError, match="init_process_group"):
        create_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        assert auto_mesh() is None
        mesh = create_mesh(backend="gloo")
        assert mesh.shape == (1, 1) and mesh.graph_group is None and mesh.window(64) == (0, 64)
        with pytest.raises(ValueError, match="ranks"):
            create_mesh(shape=(1, 2), backend="gloo")
        assert Trainer(TrainingConfig(), device="cpu", mesh="auto").mesh is None
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_pt_step_graph_sharded_matches_jax(graphs, jax_capture):  # noqa: F811
    """One scheduled PT step with ``GRAPH_SHARDED="on"`` on 2 ranks, from
    the JAX single-device state (``train_state_from_jax``) and fed its
    draws: the MSE equals the JAX step's (rtol 1e-4), the NLL is finite
    (and within 1e-5), the chains follow the chain rule, and the ranks
    agree."""
    jg, jplan, tg, tplan = graphs
    cfg = dict(SMALL, SAMPLER="pt", GIBBS_SWEEPS=2, SAMPLER_MATMUL_DTYPE="float32",
               PERSISTENT_CHAINS=True)
    jfns = jstep.make_train_fns(JaxConfig(**cfg, USE_PALLAS="off"), jg, 100, jplan)
    imgs = _images(8, 4)
    state = jax.jit(jfns.init)(jax.random.PRNGKey(8), jnp.asarray(imgs[:1]))
    feed0 = _step_feed(state, jplan, cfg, 8)
    new, m = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    feed0.spin_uniforms = _t(jax_capture["u"])

    def rank(mesh):
        tfns = make_train_fns(TrainingConfig(**cfg, GRAPH_SHARDED="on"), tg, 100, tplan,
                              device="cpu", mesh=mesh)
        assert tfns.sampler_impl == "torch_graph_sharded+plrng"
        ts = train_state_from_jax(tfns, state)
        lo, hi = mesh.window(tplan.n_pad)
        assert ts.chains.shape[-1] == hi - lo
        assert ts.sampler_coupling.shape == (hi - lo, tplan.n_pad)
        tm = tfns.step_body(ts, _t(imgs), 0, feed0)
        return tm, ts

    outs = run_ranks(2, rank)
    (tm, _), (tm1, _) = outs
    np.testing.assert_allclose(float(tm.mse), float(m.mse), rtol=1e-4)
    assert np.isfinite(float(tm.nll))
    np.testing.assert_allclose(float(tm.nll), float(m.nll), rtol=1e-5)
    for f in ("mse", "mmd", "dvae_loss", "nll"):
        assert float(getattr(tm, f)) == float(getattr(tm1, f)), f
    chains = torch.cat([ts.chains for _, ts in outs], -1).numpy()
    assert (chains == np.asarray(new.chains)).all(axis=-1).mean() >= 0.98
    np.testing.assert_array_equal(outs[0][1].chain_energies.numpy(),
                                  outs[1][1].chain_energies.numpy())
    for name in ("linear", "quadratic"):
        np.testing.assert_array_equal(getattr(outs[0][1].grbm_params, name).detach().numpy(),
                                      getattr(outs[1][1].grbm_params, name).detach().numpy())


def test_trainer_graph_sharded_epoch_save_and_sample(tmp_path):
    """``Trainer(mesh=...)`` with ``GRAPH_SHARDED="on"`` on 2 ranks: an
    epoch through the partitioned sampler (a packed int8 coupling at chunk
    16), ``save`` on rank 0 only, ``sample_spins`` equal on every rank;
    ``save_native`` writes the whole ladder (every rank's column window)
    and ``resume_native`` on the mesh gives each rank its window back."""
    cfg = TrainingConfig(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=2,
                         GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, QPU="Advantage2_prototype",
                         SAMPLER="pt", PT_NUM_BETAS=2, SAMPLER_MATMUL_DTYPE="int8",
                         SWEEP_BLOCK_SPARSE="on", SWEEP_BS_CHUNK=16, GRAPH_SHARDED="on",
                         COMPUTE_DTYPE="float32")

    def rank(mesh):
        t = Trainer(cfg, device="cpu", mesh=mesh)
        t.train_init(1)
        stats = t.train_epoch(0)
        path = t.save(tmp_path / "m")
        spins = t.sample_spins(6, 2)
        t.save_native(tmp_path / "ckpt")
        whole = native_ckpt.load_payload(tmp_path / "ckpt")["chains"]
        assert whole.shape == (2, 8, t.plan.n_pad)
        assert torch.equal(t.fns.local(whole), t.state.chains)
        back = Trainer(cfg, device="cpu", mesh=mesh)
        back.resume_native(tmp_path / "ckpt", n_epochs=1)
        assert torch.equal(back.state.chains, t.state.chains)
        assert torch.equal(back.state.chain_energies, t.state.chain_energies)
        assert type(back.state.sampler_coupling) is type(t.state.sampler_coupling)
        return t.fns.sampler_impl, stats, spins, type(t.state.sampler_coupling).__name__, path

    outs = run_ranks(2, rank)
    for impl, stats, spins, ctype, path in outs:
        assert impl == "torch_graph_sharded+plrng+int8+bs"
        assert ctype == "ShardedBlockSparseCoupling"
        assert np.isfinite(stats["mse"]) and stats["mse"] == outs[0][1]["mse"]
        assert spins.shape == (6, 32) and torch.equal(spins, outs[0][2])
        assert set(torch.unique(spins).tolist()) <= {-1.0, 1.0}
        assert path == tmp_path / "m"
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
        "dvae.pth", "grbm.pth", "losses.json", "parameters.json"]
