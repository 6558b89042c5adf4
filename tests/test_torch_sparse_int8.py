"""Port parity: the int8 sweep kernel's inputs and its plain version.

``ops/gibbs_sparse.py`` takes every int8 sweep (K1-int8, K2-int8,
K3-int8) as a sparse field gather over a static neighbour table per plan.
These CPU tests hold:

* the table: gathering the stored coupling at its offsets and scattering
  back rebuilds the dense int8 matrix exactly, for the flagship,
  2,048-latent and scaled plans, dense and packed at chunk 256 (the
  clamped, overlapping final chunk included);
* the contract it relies on: every int8 coupling ``build_sampler_model``
  builds is zero off the plan's edges (all its nonzeros sit at the
  table's offsets);
* the plain version against the JAX package on fed uniforms: the K1 route
  against ``gibbs_sweeps_pallas(interpret=True, uniforms=u)`` with a
  ``QuantCoupling``, the K3 route against ``gibbs_sweeps_pallas_hbm`` with
  int8 panels in interpret mode, with and without ΔE, at β = 1 and
  per-chain β, on the checkpoint's model and a |J| ≤ 1 model.  Int8
  fields are exact integers on both sides, so no chain may differ; ΔE
  within 1e-4 on the checkpoint's model and 1e-3·(1 + |E|) at |J| ≤ 1
  (f32 sums in another order);
* the launch-shape rule: 256, 1,024 and 2,048 chains fill at least one
  wave of blocks on the 132 SMs (and on other SM counts), and one block's
  shared memory fits 227 KB on every plan;
* the routes count a launch only where the kernel launches: CPU calls
  count nothing.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.io.torch_pth import grbm_from_state_dict as jax_grbm_from_sd
from image_generation_tpu.io.torch_pth import load_state_dict as jax_load_sd
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import block_sparse as jbs
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import quant as jquant
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu.ops.gibbs_pallas_hbm import gibbs_sweeps_pallas_hbm
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_sparse as gs
from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling, pack_coupling
from image_generation_tpu_torch.ops.gibbs_cuda import gibbs_sweeps_cuda
from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda
from image_generation_tpu_torch.ops.quant import QuantCoupling, quantize_coupling
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

SEED = 775321899904
MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
_PLANS = {  # name: (qpu, latents)
    "flagship": ("Advantage2_system1", 256),
    "latents2048": ("Advantage_system6", 2048),
    "scaled": ("Advantage_system6", 5640),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread for this module (the suite runs
    six worker processes at once), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def plans():
    """{name: (graph, plan)} of the three configurations' fresh graphs."""
    out = {}
    for name, (qpu, n) in _PLANS.items():
        g, _ = cached_latent_graph(qpu, n, SEED)
        out[name] = (g, tgibbs.build_plan(g))
    return out


def _random_int8(graph, plan, seed):
    rng = np.random.default_rng(seed)
    _hp, a = tgibbs.permuted_model(
        plan, _t(rng.uniform(-0.5, 0.5, graph.n).astype(np.float32)),
        _t(rng.uniform(-1.0, 1.0, graph.n_edges).astype(np.float32)))
    return quantize_coupling(a)


# ---------------------------------------------------------------------------
# the neighbour table and the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("name", list(_PLANS))
def test_table_gathers_and_rebuilds_the_dense_matrix(plans, name, chunk):
    """Gathering the stored coupling (dense, or packed at ``chunk``) at the
    table's offsets and scattering the values back at (neighbour, column)
    rebuilds the dense int8 matrix bit for bit; the table lists each
    directed nonzero once, within the plan's largest degree."""
    graph, plan = plans[name]
    qc = _random_int8(graph, plan, 1)
    stored = qc.q if chunk is None else pack_coupling(plan, qc, chunk).panels
    nbr, off = gs.neighbor_table(plan, chunk)
    used = off >= 0
    cols = np.broadcast_to(np.arange(plan.n_pad), nbr.shape)[used]
    rebuilt = torch.zeros_like(qc.q)
    rebuilt[_t(nbr[used]).long(), _t(cols).long()] = stored.reshape(-1)[_t(off[used]).long()]
    assert torch.equal(rebuilt, qc.q)
    assert used.sum() == 2 * graph.n_edges
    assert nbr.shape[0] == np.bincount(np.concatenate([graph.edge_i, graph.edge_j])).max()
    if chunk is not None and name != "flagship":  # 2,432 and 6,016: the final chunk clamps
        assert plan.n_pad % chunk != 0


def _stored_and_table(coupling):
    if isinstance(coupling, BlockSparseCoupling):
        return coupling.panels, gs.neighbor_table(coupling.plan, coupling.chunk)[1]
    return coupling.q, None


_INT8_CONFIGS = {  # name: (plan, overrides, serving?)
    "flagship_int8": ("flagship", dict(SAMPLER_MATMUL_DTYPE="int8"), False),
    "flagship_int8_pt": ("flagship", dict(SAMPLER_MATMUL_DTYPE="int8", SAMPLER="pt"), False),
    "latents2048_served": ("latents2048", {}, True),
    "scaled_served": ("scaled", {}, True),
    "scaled_served_dense": ("scaled", dict(SWEEP_BLOCK_SPARSE="off"), True),
}


@pytest.mark.parametrize("case", list(_INT8_CONFIGS))
def test_built_int8_coupling_is_zero_off_the_plans_edges(plans, case):
    """The contract the gather kernel relies on: every nonzero of the int8
    coupling the dispatch stores (``build_sampler_model``: permute,
    quantize, pack) sits at one of the table's offsets, for each
    configuration that reaches an int8 sweep."""
    name, overrides, serving = _INT8_CONFIGS[case]
    graph, plan = plans[name]
    qpu, n = _PLANS[name]
    cfg = TrainingConfig(QPU=qpu, N_LATENTS=n, **overrides)
    if serving:
        cfg = cfg.for_serving(n)
    fns = make_sample_fns(cfg, graph, plan, device="cpu")
    params = graph.init_params(torch.Generator().manual_seed(3), scale=1.0)
    _hp, coupling = fns.build_sampler_model(params)
    assert isinstance(coupling, (QuantCoupling, BlockSparseCoupling))
    chunk = coupling.chunk if isinstance(coupling, BlockSparseCoupling) else None
    stored = coupling.panels if chunk is not None else coupling.q
    assert stored.dtype == torch.int8
    _nbr, off = gs.neighbor_table(plan, chunk)
    at_edges = torch.zeros(stored.numel(), dtype=torch.bool)
    at_edges[_t(off[off >= 0]).long()] = True
    flat = stored.reshape(-1)
    assert int((flat[~at_edges] != 0).sum()) == 0
    assert int((flat[at_edges] != 0).sum()) > 0


def test_table_refuses_a_plan_coupling_a_span_to_itself():
    """An edge inside one color-class span would be read while the span is
    written: the table build refuses it."""
    blocks = ((0, 2, 128), (128, 130, 256))
    plan = tgibbs.GibbsPlan(n=4, n_pad=256, blocks=blocks, orig_to_perm=np.array([0, 1, 128, 129]),
                            perm_edge_i=np.array([0, 0]), perm_edge_j=np.array([1, 128]),
                            valid_mask=np.zeros(256, bool), block_class=(0, 1))
    with pytest.raises(ValueError, match="span"):
        gs.neighbor_table(plan)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt():
    """(JAX plan, port plan, {model: (hp, A) numpy}) on the checkpoint
    graph (n_pad 640: chunk 256 clamps its final chunk): its own scaled
    model and a |J| ≤ 1 model."""
    jparams, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    h, j = jgrbm.scaled_ising(jparams, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    rng = np.random.default_rng(0)
    raw = {
        "checkpoint": (np.asarray(h), np.asarray(j)),
        "strong": (rng.uniform(-0.5, 0.5, jg.n).astype(np.float32),
                   rng.uniform(-1.0, 1.0, jg.n_edges).astype(np.float32)),
    }
    models = {}
    for name, (hh, jj) in raw.items():
        hp, a = jgibbs.permuted_model(jplan, jnp.asarray(hh), jnp.asarray(jj))
        models[name] = (np.asarray(hp), np.asarray(a))
    return jplan, tplan, models


CHAINS, SWEEPS = 16, 4


@pytest.mark.parametrize("beta_kind", ["one", "per_chain"])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("model", ["checkpoint", "strong"])
@pytest.mark.parametrize("route", ["K1", "K3"])
def test_plain_gather_matches_jax(ckpt, route, model, track, beta_kind):
    """The gather's plain version (``gibbs_sweeps_sparse`` on CPU
    tensors, and through the route's wrapper) against the JAX Pallas
    kernel of that route in interpret mode, fed the same uniforms: every
    chain identical, ΔE within the stated tolerance."""
    jplan, tplan, models = ckpt
    hp, a = models[model]
    rng = np.random.default_rng(len(route) + CHAINS)
    s0 = rng.choice([-1.0, 1.0], (CHAINS, tplan.n_pad)).astype(np.float32)
    u = rng.random((SWEEPS, CHAINS, tplan.n_pad), dtype=np.float32)
    beta = (np.ones(CHAINS, np.float32) if beta_kind == "one"
            else rng.uniform(0.5, 2.0, CHAINS).astype(np.float32))
    jq, tq = jquant.quantize_coupling(jnp.asarray(a)), quantize_coupling(_t(a))
    args = (jnp.asarray(hp),)
    if route == "K1":
        jc, tc, wrapper = jq, tq, gibbs_sweeps_cuda
        ref = gibbs_sweeps_pallas(jax.random.PRNGKey(0), *args, jc, jplan, jnp.asarray(s0),
                                  SWEEPS, beta=jnp.asarray(beta), interpret=True,
                                  uniforms=jnp.asarray(u), track_delta_e=track)
    else:
        jc, tc, wrapper = jbs.pack_coupling(jplan, jq, 256), pack_coupling(tplan, tq, 256), \
            gibbs_sweeps_hbm_cuda
        ref = gibbs_sweeps_pallas_hbm(jax.random.PRNGKey(0), *args, jc, jplan, jnp.asarray(s0),
                                      SWEEPS, jnp.asarray(beta), interpret=True,
                                      uniforms=jnp.asarray(u), track_delta_e=track)
    b = 1.0 if beta_kind == "one" else _t(beta)
    ours = gs.gibbs_sweeps_sparse(_t(hp), tc, tplan, _t(s0), SWEEPS, b, uniforms=_t(u),
                                       track_delta_e=track)
    via = wrapper(_t(hp), tc, tplan, _t(s0), SWEEPS, b, uniforms=_t(u), track_delta_e=track)
    if track:
        (ours, de), (via, via_de), (ref, ref_de) = ours, via, ref
        assert torch.equal(de, via_de)
    assert torch.equal(ours, via)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.numpy() != s0).any(axis=1).all()  # the run moves every chain
    if track:
        err = np.abs(de.numpy() - np.asarray(ref_de))
        if model == "checkpoint":
            assert err.max() <= 1e-4, float(err.max())
        else:
            e = tgibbs.ising_energies(_t(hp), tq, ours).abs().numpy()
            assert (err <= 1e-3 * (1 + e)).all(), float(err.max())


def test_plain_gather_equals_the_dense_plain_versions(plans):
    """On the scaled plan the gather equals the dense plain versions bit
    for bit (integer fields, the same sigmoid and draws): K1's
    (``gibbs_sweeps_kernel_reference``) on the dense int8 matrix, K3's
    (``gibbs_sweeps_hbm_reference``) on the packed panels; and with no
    uniforms fed it draws the same stream from the generator."""
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_reference

    graph, plan = plans["scaled"]
    qc = _random_int8(graph, plan, 2)
    bsc = pack_coupling(plan, qc, 256)
    rng = np.random.default_rng(4)
    s0 = _t(rng.choice([-1.0, 1.0], (4, plan.n_pad)).astype(np.float32))
    hp = _t(rng.uniform(-0.5, 0.5, plan.n_pad).astype(np.float32))
    beta = _t(rng.uniform(0.5, 2.0, 4).astype(np.float32))
    dense = tgibbs.gibbs_sweeps_kernel_reference(hp, qc, plan, s0, 2, beta,
                                                 generator=torch.Generator().manual_seed(5),
                                                 track_delta_e=True)
    ours = gs.gibbs_sweeps_sparse(hp, qc, plan, s0, 2, beta,
                                       generator=torch.Generator().manual_seed(5),
                                       track_delta_e=True)
    assert torch.equal(ours[0], dense[0]) and torch.equal(ours[1], dense[1])
    u = _t(rng.random((2, 4, plan.n_pad), dtype=np.float32))
    packed = gibbs_sweeps_hbm_reference(hp, bsc, plan, s0, 2, beta, uniforms=u)
    assert torch.equal(gs.gibbs_sweeps_sparse(hp, bsc, plan, s0, 2, beta, uniforms=u), packed)


# ---------------------------------------------------------------------------
# the launch shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chains", [256, 1024, 2048])
@pytest.mark.parametrize("name", list(_PLANS))
def test_launch_shape_fills_a_wave_and_fits(plans, name, chains):
    """The chains per block G and threads per block: at least one full wave
    of blocks on the 132 SMs, G the largest that keeps one (so fewer
    blocks re-read the table), the spins plus the energy carry's partial
    sums within 227 KB, the threads a multiple of 32 and of G; on the
    scaled plan, whose live spans are wider than a 512-thread pass, one
    chain a block."""
    _graph, plan = plans[name]
    g, threads = gs.launch_shape(plan, chains)
    assert g in gs._CHAINS and -(-chains // g) >= gs._SMS
    assert gs._dynamic_smem(g, plan.n_pad) + gs._STATIC_SMEM <= 227 * 1024
    assert threads % 32 == 0 and threads % g == 0 and 32 <= threads <= 1024
    assert gs.supported(plan, chains)
    if name == "scaled":
        assert (g, threads) == (1, 512)
        return
    assert g == 16 or -(-chains // (2 * g)) < gs._SMS
    assert {256: 1, 1024: 4, 2048: 8}[chains] == g


def test_launch_shape_shrinks_for_a_wide_plan():
    """A plan too wide for 16 chains' spins in shared memory (the P32
    fabric's n_pad 23,936, here in 128-column blocks) takes the largest G
    that fits; below one wave of chains G is 1."""
    wide = tgibbs.GibbsPlan(n=23936, n_pad=23936,
                            blocks=tuple((128 * i, 128 * (i + 1), 128 * (i + 1))
                                         for i in range(187)),
                            orig_to_perm=np.zeros(0), perm_edge_i=np.zeros(0, np.int32),
                            perm_edge_j=np.zeros(0, np.int32), valid_mask=np.zeros(23936, bool))
    assert gs.launch_shape(wide, 4096)[0] == 8  # 16 x 23,936 B > 227 KB
    assert gs.launch_shape(wide, 64) == (1, 512)


@pytest.mark.parametrize("sms, chains, g", [(66, 256, 2), (114, 1024, 8), (264, 2048, 4)])
def test_launch_shape_follows_the_sm_count(plans, sms, chains, g):
    """The wave rule reads the card's SM count: half an H100's SMs take
    twice the chains a block at 256 chains, a PCIe H100's 114 SMs G = 8
    at 1,024 chains, twice the SMs half the G at 2,048.  The scaled plan's
    one chain a block does not depend on it."""
    _graph, plan = plans["latents2048"]
    assert gs.launch_shape(plan, chains, sms)[0] == g
    assert -(-chains // g) >= sms
    assert gs.launch_shape(plans["scaled"][1], chains, sms) == (1, 512)


@pytest.mark.parametrize("route", ["K1", "K3"])
def test_cpu_calls_count_no_launch(plans, route):
    """The routes' counters move only where the kernel launches: an int8
    call on CPU tensors runs the plain version and counts nothing."""
    graph, plan = plans["latents2048" if route == "K1" else "scaled"]
    qc = _random_int8(graph, plan, 3)
    wrapper, c = ((gibbs_sweeps_cuda, qc) if route == "K1"
                  else (gibbs_sweeps_hbm_cuda, pack_coupling(plan, qc, 256)))
    rng = np.random.default_rng(3)
    hp = _t(rng.uniform(-0.5, 0.5, plan.n_pad).astype(np.float32))
    s0 = _t(rng.choice([-1.0, 1.0], (2, plan.n_pad)).astype(np.float32))
    wrapper.launches.clear()
    out, _de = wrapper(hp, c, plan, s0, 2, generator=torch.Generator().manual_seed(1),
                       track_delta_e=True)
    assert out.shape == s0.shape and not wrapper.launches
