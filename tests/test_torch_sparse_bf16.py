"""Port parity: the gather sweep kernel's bf16 mode (K2-bf16, K3-bf16 and
their ΔE modes) through its plain version, on the CPU.

``ops/gibbs_sparse.py`` takes the streaming route's bf16 sweeps as a
sparse field gather: one (k << 16) | bf16-bits word a table slot, fields
summed in f32 in the table's slot order.  These CPU tests hold:

* the plain version against the JAX package,
  ``gibbs_sweeps_pallas_hbm(block_dtype=bfloat16, interpret=True,
  uniforms=u)``: K2 on the dense matrix and K3 on panels packed at chunk
  128 and 256 (256 clamps the final chunk of the checkpoint's n_pad 640),
  with and without ΔE, at β = 1 and per-chain β, 3 sweeps run as 4.  The
  two sum the fields in another order, so the chain rule (≥ 98 % of
  chains bit-identical), one color step's fields within 1e-5, and on
  identical chains ΔE within 1e-3·(1 + |E|);
* it against the dense plain version (``gibbs_sweeps_hbm_reference``) on
  the 2,048-latent and scaled plans under the chain rule; on an
  integer-valued coupling every sum is exact, so bit for bit, and K3
  equal to K2;
* the words: decoded, they rebuild the stored bf16 coupling exactly
  (dense and packed at the clamped chunk 256); a plan wider than the word
  holds (n_pad > 65,536) is refused;
* the contract the gather relies on: every bf16 coupling
  ``build_sampler_model`` builds for the 2,048-latent and scaled
  configurations is zero off the plan's edges;
* the cached table holds no values: two couplings on one plan each sample
  with their own;
* a color nothing couples into gets fields = h; CPU calls count no
  launch.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.io.torch_pth import grbm_from_state_dict as jax_grbm_from_sd
from image_generation_tpu.io.torch_pth import load_state_dict as jax_load_sd
from image_generation_tpu.ops import block_sparse as jbs
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas_hbm import gibbs_sweeps_pallas_hbm
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_sparse as gs
from image_generation_tpu_torch.ops.block_sparse import (
    BlockSparseCoupling,
    color_chunk_rows,
    pack_coupling,
)
from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
    gibbs_sweeps_hbm_cuda,
    gibbs_sweeps_hbm_reference,
)
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

SEED = 775321899904
MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98
_PLANS = {"latents2048": 2048, "scaled": 5640}  # Advantage_system6 latents


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


def _bf16_words(coupling, plan):
    """(neighbour positions, f32 values) of the gathered bf16 words."""
    return gs._word_values(gs.table_words(coupling, plan), torch.bfloat16)


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
    rng = np.random.default_rng(0)
    hp, a = jgibbs.permuted_model(
        jplan, jnp.asarray(rng.uniform(-0.5, 0.5, jg.n).astype(np.float32)),
        jnp.asarray(rng.uniform(-1.0, 1.0, jg.n_edges).astype(np.float32)))
    return jplan, tplan, np.asarray(hp), np.asarray(a)


def _forms(jplan, tplan, a, chunk):
    """(JAX coupling, port coupling): the bf16 matrix, or its panels at
    ``chunk``."""
    ja, ta = jnp.asarray(a).astype(jnp.bfloat16), _t(a).to(torch.bfloat16)
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
    rng = np.random.default_rng(len(route) + 10 * track)
    s0 = rng.choice([-1.0, 1.0], (CHAINS, tplan.n_pad)).astype(np.float32)
    u = rng.random((4, CHAINS, tplan.n_pad), dtype=np.float32)
    beta = (np.ones(CHAINS, np.float32) if beta_kind == "one"
            else rng.uniform(0.5, 2.0, CHAINS).astype(np.float32))
    ref = gibbs_sweeps_pallas_hbm(jax.random.PRNGKey(0), jnp.asarray(hp), jc, jplan,
                                  jnp.asarray(s0), 3, jnp.asarray(beta),
                                  block_dtype=jnp.bfloat16, interpret=True,
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
    kernel's slot order, against the JAX bf16 product (bf16 spins and
    coupling, f32 accumulation) + h, within 1e-5, for every class span."""
    jplan, tplan, hp, a = ckpt
    _jc, tc = _forms(jplan, tplan, a, _ROUTES[route])
    s0 = np.random.default_rng(3).choice([-1.0, 1.0], (64, tplan.n_pad)).astype(np.float32)
    ja = jnp.asarray(a).astype(jnp.bfloat16)
    nbr, vals = _bf16_words(tc, tplan)
    for c0, c1, _b0, _b1 in tgibbs.class_spans(tplan):
        ours = (gs.span_sums(_t(s0), nbr, vals, c0, c1) + _t(hp)[c0:c1]).numpy()
        ref = np.asarray(jnp.dot(jnp.asarray(s0, jnp.bfloat16), ja[:, c0:c1],
                                 preferred_element_type=jnp.float32) + hp[c0:c1])
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the plain version against the dense plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plans():
    """{name: (graph, plan)} of the 2,048-latent and scaled plans."""
    out = {}
    for name, n in _PLANS.items():
        g, _ = cached_latent_graph("Advantage_system6", n, SEED)
        out[name] = (g, tgibbs.build_plan(g))
    return out


def _model(graph, plan, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        h = np.round(rng.normal(size=graph.n)).astype(np.float32)
        j = rng.choice([-1.0, 1.0], graph.n_edges).astype(np.float32)
    else:
        h = rng.uniform(-0.5, 0.5, graph.n).astype(np.float32)
        j = rng.uniform(-1.0, 1.0, graph.n_edges).astype(np.float32)
    hp, a = tgibbs.permuted_model(plan, _t(h), _t(j))
    return hp, a.to(torch.bfloat16)


def _inputs(plan, chains, sweeps, seed):
    rng = np.random.default_rng(seed)
    s0 = _t(rng.choice([-1.0, 1.0], (chains, plan.n_pad)).astype(np.float32))
    u = _t(rng.random((sweeps, chains, plan.n_pad), dtype=np.float32))
    beta = _t(rng.uniform(0.5, 2.0, chains).astype(np.float32))
    return s0, u, beta


@pytest.mark.parametrize("name", list(_PLANS))
def test_plain_gather_holds_the_chain_rule_against_the_dense_plain_version(plans, name):
    """|J| ≤ 1, per-chain β, ΔE on: the gather's plain version on the
    dense bf16 matrix (K2) and on its panels at chunk 256 (K3) against
    ``gibbs_sweeps_hbm_reference`` on the dense matrix: ≥ 98 % of chains
    identical, ΔE within 1e-3·(1 + |E|) on them."""
    graph, plan = plans[name]
    hp, a = _model(graph, plan, 1)
    s0, u, beta = _inputs(plan, 64, 2, 2)
    dense, dense_de = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 2, beta, uniforms=u,
                                                 track_delta_e=True)
    e = tgibbs.ising_energies(hp, a, dense).abs()
    for c in (a, pack_coupling(plan, a, 256)):
        out, de = gs.gibbs_sweeps_sparse(hp, c, plan, s0, 2, beta, uniforms=u,
                                         track_delta_e=True)
        same = (out == dense).all(dim=1)
        assert float(same.float().mean()) >= CHAIN_RULE
        assert bool(((de - dense_de).abs()[same] <= 1e-3 * (1 + e[same])).all())


@pytest.mark.parametrize("name", list(_PLANS))
def test_integer_coupling_is_bit_identical_and_k3_equals_k2(plans, name):
    """Integer h and J = ±1: every sum is exact in any order, so the
    gather's plain version equals the dense plain version bit for bit,
    spins and ΔE, on the dense matrix and on its clamped panels; unfed, it
    draws the same stream from the generator."""
    graph, plan = plans[name]
    hp, a = _model(graph, plan, 3, integer=True)
    s0, u, beta = _inputs(plan, 16, 2, 4)
    dense = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 2, beta, uniforms=u, track_delta_e=True)
    k2 = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 2, beta, uniforms=u, track_delta_e=True)
    k3 = gs.gibbs_sweeps_sparse(hp, pack_coupling(plan, a, 256), plan, s0, 2, beta,
                                uniforms=u, track_delta_e=True)
    for out in (k2, k3):
        assert torch.equal(out[0], dense[0]) and torch.equal(out[1], dense[1])
    drawn = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 2, beta,
                                   generator=torch.Generator().manual_seed(5))
    ref = tgibbs.gibbs_sweeps_kernel_reference(hp, a, plan, s0, 2, beta,
                                               generator=torch.Generator().manual_seed(5))
    assert torch.equal(drawn, ref)


def test_unoccupied_color_takes_fields_h():
    """A color block nothing couples into (isolated spins split off by
    ``max_class``) gets fields = h: the gather's plain version on the
    dense bf16 matrix and on its packed panels equals the dense plain
    version bit for bit on an integer coupling."""
    rng = np.random.default_rng(5)
    ring = np.array([(i, (i + 1) % 200) for i in range(200)])
    graph = tgrbm.GRBMGraph(n=264, edge_i=ring[:, 0], edge_j=ring[:, 1])  # 64 isolated spins
    plan = tgibbs.build_plan(graph, pad_to=64, max_class=64)
    assert () in color_chunk_rows(plan, 64)  # an unoccupied color
    hp, a = tgibbs.permuted_model(plan, _t(np.round(rng.normal(size=264)).astype(np.float32)),
                                  _t(rng.choice([-1.0, 1.0], 200).astype(np.float32)))
    a = a.to(torch.bfloat16)
    s0, u, _beta = _inputs(plan, 32, 2, 6)
    ref = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 2, uniforms=u, track_delta_e=True)
    for c in (a, pack_coupling(plan, a, 64)):
        out = gibbs_sweeps_hbm_cuda(hp, c, plan, s0, 2, uniforms=u, track_delta_e=True)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


# ---------------------------------------------------------------------------
# the words, the contract, the cache, the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("name", list(_PLANS))
def test_words_rebuild_the_stored_coupling(plans, name, chunk):
    """Decoding the gathered words (dense, or packed at the clamped chunk
    256) and scattering the values back at (neighbour, column) rebuilds
    the dense bf16 matrix bit for bit; every directed edge has a word."""
    graph, plan = plans[name]
    _hp, a = _model(graph, plan, 7)
    stored = a if chunk is None else pack_coupling(plan, a, chunk)
    nbr, vals = _bf16_words(stored, plan)
    used = _t(gs.neighbor_table(plan, chunk)[1]) >= 0
    cols = torch.arange(plan.n_pad).expand_as(nbr)
    rebuilt = torch.zeros(a.shape, dtype=torch.bfloat16)
    rebuilt[nbr[used], cols[used]] = vals[used].to(torch.bfloat16)
    assert torch.equal(rebuilt.view(torch.int16), a.view(torch.int16))
    assert int(used.sum()) == 2 * graph.n_edges
    assert bool((vals[~used] == 0).all() and (nbr[~used] == 0).all())


def _wide_plan(n_pad):
    """A plan of one n_pad-wide block with no edges, for the word guard."""
    return tgibbs.GibbsPlan(n=n_pad, n_pad=n_pad, blocks=((0, n_pad, n_pad),),
                            orig_to_perm=np.arange(n_pad), perm_edge_i=np.zeros(0, np.int64),
                            perm_edge_j=np.zeros(0, np.int64), valid_mask=np.ones(n_pad, bool))


def test_word_guard_refuses_a_plan_too_wide():
    """A bf16 word holds a spin position in 16 bits: n_pad 65,536 is taken,
    65,664 refused, by the words and by the sweep (which checks before any
    launch); int8 words take the wider plan."""
    for n_pad, ok in ((1 << 16, True), ((1 << 16) + 128, False)):
        plan = _wide_plan(n_pad)
        panels = BlockSparseCoupling(panels=torch.zeros((128, n_pad), dtype=torch.bfloat16),
                                     scale=None, plan=plan, chunk=128)
        if ok:
            assert not bool(gs.table_words(panels, plan).any())
            continue
        with pytest.raises(ValueError, match="table word"):
            gs.table_words(panels, plan)
        with pytest.raises(ValueError, match="table word"):
            gs.gibbs_sweeps_sparse(torch.zeros(n_pad), panels, plan, torch.ones((1, n_pad)), 2)
        int8 = BlockSparseCoupling(panels=torch.zeros((128, n_pad), dtype=torch.int8),
                                   scale=torch.tensor(1.0), plan=plan, chunk=128)
        assert gs.table_words(int8, plan).shape == (1, n_pad)


_BF16_CONFIGS = {  # name: (plan, overrides)
    "latents2048_train": ("latents2048", {}),
    "scaled_train": ("scaled", dict(SAMPLER="pt", PT_NUM_BETAS=32, NUM_READS=64)),
    "scaled_train_dense": ("scaled", dict(SAMPLER="pt", PT_NUM_BETAS=32, NUM_READS=64,
                                          SWEEP_BLOCK_SPARSE="off")),
}


@pytest.mark.parametrize("case", list(_BF16_CONFIGS))
def test_built_bf16_coupling_is_zero_off_the_plans_edges(plans, case):
    """The contract the gather relies on: every nonzero of the bf16
    coupling the training dispatch stores (``build_sampler_model``:
    permute, cast, pack) sits at one of the table's offsets, for each
    configuration that reaches K2-bf16 or K3-bf16."""
    name, overrides = _BF16_CONFIGS[case]
    graph, plan = plans[name]
    fns = make_sample_fns(TrainingConfig(QPU="Advantage_system6", N_LATENTS=_PLANS[name],
                                         **overrides), graph, plan, device="cpu")
    params = graph.init_params(torch.Generator().manual_seed(3), scale=1.0)
    _hp, coupling = fns.build_sampler_model(params)
    chunk = coupling.chunk if isinstance(coupling, BlockSparseCoupling) else None
    stored = coupling.panels if chunk is not None else coupling
    assert stored.dtype == torch.bfloat16 and (chunk is not None) == (case == "scaled_train")
    _nbr, off = gs.neighbor_table(plan, chunk)
    at_edges = torch.zeros(stored.numel(), dtype=torch.bool)
    at_edges[_t(off[off >= 0]).long()] = True
    flat = stored.reshape(-1)
    assert int((flat[~at_edges] != 0).sum()) == 0
    assert int((flat[at_edges] != 0).sum()) > 0


def test_cached_table_holds_no_values(plans):
    """The (nbr, off) table is cached per (plan, chunk, device) and the
    values are gathered on every call: after a run on one coupling, a run
    on another coupling of the same plan equals that coupling's run on a
    fresh plan object (nothing cached), and differs from the first."""
    graph, plan = plans["latents2048"]
    fresh = tgibbs.build_plan(graph)
    (hp, a), (_hp2, b) = _model(graph, plan, 8), _model(graph, plan, 9)
    s0, u, beta = _inputs(plan, 8, 2, 10)
    first = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 2, beta, uniforms=u)
    second = gs.gibbs_sweeps_sparse(hp, b, plan, s0, 2, beta, uniforms=u)
    assert torch.equal(second, gs.gibbs_sweeps_sparse(hp, b, fresh, s0, 2, beta, uniforms=u))
    assert not torch.equal(first, second)
    assert not torch.equal(gs.table_words(a, plan), gs.table_words(b, plan))


@pytest.mark.parametrize("route", ["K2", "K3"])
def test_cpu_calls_count_no_launch(plans, route):
    """A bf16 call on CPU tensors runs the plain version and counts
    nothing on the streaming route's counter."""
    graph, plan = plans["scaled"]
    hp, a = _model(graph, plan, 11)
    c = a if route == "K2" else pack_coupling(plan, a, 256)
    s0, _u, _beta = _inputs(plan, 2, 1, 12)
    gibbs_sweeps_hbm_cuda.launches.clear()
    out, de = gibbs_sweeps_hbm_cuda(hp, c, plan, s0, 1, generator=torch.Generator().manual_seed(1),
                                    track_delta_e=True)
    assert out.shape == s0.shape and de.shape == (2,) and not gibbs_sweeps_hbm_cuda.launches
