"""Port parity: the streaming route's f32 modes (K2-f32, K3-f32 and their
ΔE modes) on the sparse field gather, through its plain version, on the
CPU.

``ops/gibbs_hbm_cuda.py`` sends every mode of K2 and K3 to the gather of
``ops/gibbs_sparse.py``; in f32 its table word is the 8-byte
``{k, f32 bits}`` pair and the fields are f32 sums in the table's slot
order.  These CPU tests hold:

* the plain version through the route (``gibbs_sweeps_hbm_cuda`` on CPU
  tensors) against the JAX package,
  ``gibbs_sweeps_pallas_hbm(block_dtype=float32, interpret=True,
  uniforms=u)``: K2 on the dense matrix and K3 on panels packed at chunk
  128 and 256 (256 clamps the final chunk of the checkpoint's n_pad 640),
  with and without ΔE, at β = 1 and per-chain β, 3 sweeps run as 4.  The
  Pallas kernels add one f32 dot per column panel or chunk, another
  order, so the chain rule (≥ 98 % of chains bit-identical), one color
  step's fields within 1e-5, and on identical chains ΔE within
  1e-3·(1 + |E|);
* the words: decoded at dense and at panel offsets, they rebuild the
  stored f32 coupling bit for bit, special values included;
* on integer couplings every sum is exact, so the route equals the dense
  plain version (``gibbs_sweeps_hbm_reference``) bit for bit, spins and
  ΔE, and K3 equals K2; at |J| ≤ 1 on the 1,280-latent plan, the chain
  rule against it;
* ``_stored`` takes f32 panels and refuses f64;
* the dispatch of the 1,280-latent Advantage2_system1 configuration (n_pad
  1,664): too large for K1 (``selects_k1`` false, as the JAX
  ``supported_by_pallas``), so plain Gibbs and PT stream a dense f32
  coupling through ``cuda_hbm``, as JAX picks ``pallas_hbm``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.io.torch_pth import grbm_from_state_dict as jax_grbm_from_sd
from image_generation_tpu.io.torch_pth import load_state_dict as jax_load_sd
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import block_sparse as jbs
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas import supported_by_pallas
from image_generation_tpu.ops.gibbs_pallas_hbm import gibbs_sweeps_pallas_hbm
from image_generation_tpu.training import step as jstep
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_sparse as gs
from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling, pack_coupling
from image_generation_tpu_torch.ops.gibbs_cuda import selects_k1
from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
    gibbs_sweeps_hbm_cuda,
    gibbs_sweeps_hbm_reference,
)
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

SEED = 775321899904
MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98
LATENTS = 1280  # the default configuration's smallest size that K1 refuses in f32


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


def _f32_words(coupling, plan):
    """(neighbour positions, f32 values) of the gathered f32 words."""
    return gs._word_values(gs.table_words(coupling, plan), torch.float32)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt():
    """(JAX plan, port plan, hp, A) numpy of a |J| ≤ 1 model on the
    checkpoint graph (n_pad 640 in 5 colors: chunk 256 clamps its final
    chunk)."""
    _params, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
    rng = np.random.default_rng(20)
    hp, a = jgibbs.permuted_model(
        jplan, jnp.asarray(rng.uniform(-0.5, 0.5, jg.n).astype(np.float32)),
        jnp.asarray(rng.uniform(-1.0, 1.0, jg.n_edges).astype(np.float32)))
    return jplan, tplan, np.asarray(hp), np.asarray(a)


def _forms(jplan, tplan, a, chunk):
    """(JAX coupling, port coupling): the f32 matrix, or its panels at
    ``chunk``."""
    ja, ta = jnp.asarray(a), _t(a)
    if chunk is None:
        return ja, ta
    return jbs.pack_coupling(jplan, ja, chunk), pack_coupling(tplan, ta, chunk)


CHAINS = 16
_ROUTES = {"K2": None, "K3_128": 128, "K3_256": 256}


@pytest.mark.parametrize("beta_kind", ["one", "per_chain"])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("route", list(_ROUTES))
def test_plain_gather_matches_jax(ckpt, route, track, beta_kind):
    """The streaming route (``gibbs_sweeps_hbm_cuda`` on CPU tensors, 3
    sweeps run as 4) equals ``gibbs_sweeps_sparse`` at 4 sweeps, and
    against the JAX Pallas kernel in interpret mode on the same uniforms
    holds the chain rule and the ΔE rule."""
    jplan, tplan, hp, a = ckpt
    jc, tc = _forms(jplan, tplan, a, _ROUTES[route])
    rng = np.random.default_rng(len(route) + 10 * track + 100 * (beta_kind == "one"))
    s0 = rng.choice([-1.0, 1.0], (CHAINS, tplan.n_pad)).astype(np.float32)
    u = rng.random((4, CHAINS, tplan.n_pad), dtype=np.float32)
    beta = (np.ones(CHAINS, np.float32) if beta_kind == "one"
            else rng.uniform(0.5, 2.0, CHAINS).astype(np.float32))
    ref = gibbs_sweeps_pallas_hbm(jax.random.PRNGKey(0), jnp.asarray(hp), jc, jplan,
                                  jnp.asarray(s0), 3, jnp.asarray(beta),
                                  block_dtype=jnp.float32, interpret=True,
                                  uniforms=jnp.asarray(u), track_delta_e=track)
    b = 1.0 if beta_kind == "one" else _t(beta)
    via = gibbs_sweeps_hbm_cuda(_t(hp), tc, tplan, _t(s0), 3, b, uniforms=_t(u),
                                track_delta_e=track)
    ours = gs.gibbs_sweeps_sparse(_t(hp), tc, tplan, _t(s0), 4, b, uniforms=_t(u),
                                  track_delta_e=track)
    if track:
        (ours, de), (via, via_de), (ref, ref_de) = ours, via, ref
        assert torch.equal(de, via_de)
    assert torch.equal(ours, via)
    ref = np.asarray(ref)
    same = (ours.numpy() == ref).all(axis=1)
    assert same.mean() >= CHAIN_RULE, f"only {same.mean():.3f} of chains identical"
    assert (ours.numpy() != s0).any(axis=1).all()  # the run moves every chain
    if track:
        e = tgibbs.ising_energies(_t(hp), tc, _t(ref)).abs().numpy()
        err = np.abs(de.numpy() - np.asarray(ref_de))
        assert (err[same] <= 1e-3 * (1 + e[same])).all(), float(err[same].max())


@pytest.mark.parametrize("route", list(_ROUTES))
def test_color_step_fields_match_jax(ckpt, route):
    """One color step's fields, summed from the route's words in the
    kernel's slot order, against the JAX f32 product + h, within 1e-5, for
    every class span."""
    jplan, tplan, hp, a = ckpt
    _jc, tc = _forms(jplan, tplan, a, _ROUTES[route])
    s0 = np.random.default_rng(21).choice([-1.0, 1.0], (64, tplan.n_pad)).astype(np.float32)
    nbr, vals = _f32_words(tc, tplan)
    for c0, c1, _b0, _b1 in tgibbs.class_spans(tplan):
        ours = (gs.span_sums(_t(s0), nbr, vals, c0, c1) + _t(hp)[c0:c1]).numpy()
        ref = np.asarray(jnp.dot(jnp.asarray(s0), jnp.asarray(a)[:, c0:c1],
                                 precision=jax.lax.Precision.HIGHEST) + hp[c0:c1])
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the words and the dense plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans(ckpt):
    """{name: (graph, plan)}: the checkpoint's plan and the 1,280-latent
    Advantage2_system1 plan (n_pad 1,664)."""
    _jplan, tplan, _hp, _a = ckpt
    _params, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    g, _ = cached_latent_graph("Advantage2_system1", LATENTS, SEED)
    return {"checkpoint": (tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j), tplan),
            "latents1280": (g, tgibbs.build_plan(g))}


def _model(graph, plan, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        h = np.round(rng.normal(size=graph.n)).astype(np.float32)
        j = rng.choice([-1.0, 1.0], graph.n_edges).astype(np.float32)
    else:
        h = rng.uniform(-0.5, 0.5, graph.n).astype(np.float32)
        j = rng.uniform(-1.0, 1.0, graph.n_edges).astype(np.float32)
    return tgibbs.permuted_model(plan, _t(h), _t(j))


def _inputs(plan, chains, sweeps, seed):
    rng = np.random.default_rng(seed)
    s0 = _t(rng.choice([-1.0, 1.0], (chains, plan.n_pad)).astype(np.float32))
    u = _t(rng.random((sweeps, chains, plan.n_pad), dtype=np.float32))
    beta = _t(rng.uniform(0.5, 2.0, chains).astype(np.float32))
    return s0, u, beta


@pytest.mark.parametrize("chunk", [None, 128, 256])
@pytest.mark.parametrize("name", ["checkpoint", "latents1280"])
def test_words_rebuild_the_f32_coupling(plans, name, chunk):
    """Decoding the gathered words (dense, or at the panel offsets of chunk
    128 or the clamped 256) and scattering the values back at (neighbour,
    column) rebuilds the dense f32 matrix bit for bit, with special values
    (−0.0, a subnormal, the largest f32) on three edges; every directed
    edge has a word, and empty slots hold zero."""
    graph, plan = plans[name]
    _hp, a = _model(graph, plan, 22)
    i, j = _t(plan.perm_edge_i[:3]).long(), _t(plan.perm_edge_j[:3]).long()
    special = torch.tensor([-0.0, 1e-40, 3.4028235e38])
    a[i, j] = special
    a[j, i] = special
    stored = a if chunk is None else pack_coupling(plan, a, chunk)
    nbr, vals = _f32_words(stored, plan)
    used = _t(gs.neighbor_table(plan, chunk)[1]) >= 0
    cols = torch.arange(plan.n_pad).expand_as(nbr)
    rebuilt = torch.zeros(a.shape)
    rebuilt[nbr[used], cols[used]] = vals[used]
    assert torch.equal(rebuilt.view(torch.int32), a.view(torch.int32))
    assert int(used.sum()) == 2 * graph.n_edges
    assert bool((vals[~used] == 0).all() and (nbr[~used] == 0).all())


@pytest.mark.parametrize("name", ["checkpoint", "latents1280"])
def test_integer_coupling_is_bit_identical_to_the_dense_plain_version(plans, name):
    """Integer h and J = ±1: every sum is exact in any order, so the route
    on the dense f32 matrix (K2) and on its panels at chunk 256 (K3)
    equals ``gibbs_sweeps_hbm_reference`` bit for bit, spins and ΔE,
    per-chain β, 3 sweeps run as 4; unfed, it draws the same stream from
    the generator."""
    graph, plan = plans[name]
    hp, a = _model(graph, plan, 23, integer=True)
    s0, u, beta = _inputs(plan, 16, 4, 24)
    dense = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 3, beta, uniforms=u, track_delta_e=True)
    for c in (a, pack_coupling(plan, a, 256)):
        out = gibbs_sweeps_hbm_cuda(hp, c, plan, s0, 3, beta, uniforms=u, track_delta_e=True)
        assert torch.equal(out[0], dense[0]) and torch.equal(out[1], dense[1])
    drawn = gibbs_sweeps_hbm_cuda(hp, a, plan, s0, 3, beta,
                                  generator=torch.Generator().manual_seed(5))
    ref = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 3, beta,
                                     generator=torch.Generator().manual_seed(5))
    assert torch.equal(drawn, ref)


def test_route_holds_the_chain_rule_on_the_1280_latent_plan(plans):
    """|J| ≤ 1, per-chain β, ΔE on, on the 1,280-latent plan: the route on
    the dense f32 matrix (K2) and on its panels at chunk 256 (K3) against
    the dense plain version: ≥ 98 % of chains identical, ΔE within
    1e-3·(1 + |E|) on them; the two routes equal each other's plain
    versions (the gather's) at 2 sweeps."""
    graph, plan = plans["latents1280"]
    hp, a = _model(graph, plan, 25)
    s0, u, beta = _inputs(plan, 64, 2, 26)
    dense, dense_de = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 2, beta, uniforms=u,
                                                 track_delta_e=True)
    e = tgibbs.ising_energies(hp, a, dense).abs()
    for c in (a, pack_coupling(plan, a, 256)):
        out, de = gibbs_sweeps_hbm_cuda(hp, c, plan, s0, 2, beta, uniforms=u,
                                        track_delta_e=True)
        twin = gs.gibbs_sweeps_sparse_reference(hp, c, plan, s0, 2, beta, uniforms=u,
                                                track_delta_e=True)
        assert torch.equal(out, twin[0]) and torch.equal(de, twin[1])
        same = (out == dense).all(dim=1)
        assert float(same.float().mean()) >= CHAIN_RULE
        assert bool(((de - dense_de).abs()[same] <= 1e-3 * (1 + e[same])).all())


# ---------------------------------------------------------------------------
# what the gather takes, the dispatch, the counters
# ---------------------------------------------------------------------------

def test_stored_takes_f32_panels_and_refuses_f64(plans):
    """``_stored`` returns f32 panels with their chunk and no scale, the
    dense f32 matrix with neither; f64 panels and an f64 matrix raise
    TypeError, through the route too."""
    graph, plan = plans["checkpoint"]
    hp, a = _model(graph, plan, 27)
    panels = pack_coupling(plan, a, 128)
    mat, scale, chunk = gs._stored(panels, plan)
    assert mat is panels.panels and mat.dtype == torch.float32 and scale is None and chunk == 128
    mat, scale, chunk = gs._stored(a, plan)
    assert mat is a and scale is None and chunk is None
    f64 = BlockSparseCoupling(panels=panels.panels.double(), scale=None, plan=plan, chunk=128)
    s0 = torch.ones((2, plan.n_pad))
    for bad in (f64, a.double()):
        with pytest.raises(TypeError):
            gs._stored(bad, plan)
        with pytest.raises(TypeError):
            gibbs_sweeps_hbm_cuda(hp, bad, plan, s0, 2)


@pytest.fixture(scope="module")
def latents1280_graphs():
    tg, _ = cached_latent_graph("Advantage2_system1", LATENTS, SEED)
    jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
    return jg, jgibbs.build_plan(jg), tg, tgibbs.build_plan(tg)


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_1280_latent_default_config_streams_f32(latents1280_graphs, sampler):
    """The default configuration at 1,280 latents on Advantage2_system1:
    n_pad 1,664 (6 color blocks), "auto" keeps f32 below n_pad 2,048, the
    f32 coupling is too large for K1 (``selects_k1`` false for the
    effective chain count, as the JAX ``supported_by_pallas``), so plain
    Gibbs and PT dispatch ``cuda_hbm`` (the JAX ``pallas_hbm``) with a
    dense f32 (n_pad, n_pad) coupling: K2-f32."""
    jg, jplan, tg, tplan = latents1280_graphs
    assert tplan.n_pad == jplan.n_pad == 1664 and len(tplan.blocks) == 6
    tcfg = TrainingConfig(N_LATENTS=LATENTS, SAMPLER=sampler)
    jcfg = JaxConfig(N_LATENTS=LATENTS, SAMPLER=sampler, USE_PALLAS="on")
    assert tcfg.QPU == "Advantage2_system1" and tcfg.resolved_sampler_matmul_dtype(1664) is None
    eff = tcfg.PT_NUM_BETAS * tcfg.NUM_READS if sampler == "pt" else tcfg.NUM_READS
    assert not selects_k1(tplan, eff, 4)
    assert not supported_by_pallas(jplan, eff, coupling_itemsize=4)
    assert jstep.make_train_fns(jcfg, jg, 10, jplan).sampler_impl == "pallas_hbm"
    fns = make_sample_fns(tcfg, tg, tplan, device="cpu")
    assert fns.sampler_impl == "cuda_hbm"
    params = tg.init_params(torch.Generator().manual_seed(0))
    hp, coupling = fns.build_sampler_model(params)
    assert isinstance(coupling, torch.Tensor) and coupling.dtype == torch.float32
    assert tuple(coupling.shape) == (1664, 1664) and hp.shape == (1664,)
    # the contract the gather relies on: the coupling is zero off the plan's edges
    _nbr, off = gs.neighbor_table(tplan)
    at_edges = torch.zeros(coupling.numel(), dtype=torch.bool)
    at_edges[_t(off[off >= 0]).long()] = True
    assert int((coupling.reshape(-1)[~at_edges] != 0).sum()) == 0


@pytest.mark.parametrize("route", ["K2", "K3"])
def test_cpu_calls_count_no_launch(plans, route):
    """An f32 call on CPU tensors runs the gather's plain version and
    counts nothing on the streaming route's counter."""
    graph, plan = plans["latents1280"]
    hp, a = _model(graph, plan, 28)
    c = a if route == "K2" else pack_coupling(plan, a, 256)
    s0, _u, _beta = _inputs(plan, 2, 1, 29)
    gibbs_sweeps_hbm_cuda.launches.clear()
    out, de = gibbs_sweeps_hbm_cuda(hp, c, plan, s0, 1, generator=torch.Generator().manual_seed(1),
                                    track_delta_e=True)
    assert out.shape == s0.shape and de.shape == (2,) and not gibbs_sweeps_hbm_cuda.launches
