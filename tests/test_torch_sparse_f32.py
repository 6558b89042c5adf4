"""Port parity: K1's f32 mode as the sparse field gather, through its
plain version, on the CPU.

``ops/gibbs_sparse.py`` takes K1 with a dense f32 coupling as a sparse
field gather: one 8-byte {neighbour, f32 bits} word a table slot, fields
summed in f32 in the table's slot order, then h.  These CPU tests hold:

* the words: decoded, they rebuild the stored f32 coupling bit for bit
  on the served checkpoint's plan (n_pad 640) and the fresh flagship plan
  (n_pad 768), special values (−0, subnormals, the largest finite)
  included;
* the plain version, through ``gibbs_cuda.gibbs_sweeps_cuda``'s CPU
  branch, against the JAX package's ``gibbs_sweeps_pallas(interpret=True,
  uniforms=u)``, with and without ΔE, at β = 1 and per-chain β.  The two
  sum the fields in another order, so the chain rule (≥ 98 % of chains
  bit-identical), one color step's fields within 1e-5, and on identical
  chains ΔE within 1e-4 (the checkpoint's model) or 1e-3·(1 + |E|)
  (|J| ≤ 1);
* it against the dense plain version (``gibbs_sweeps_kernel_reference``)
  under the chain rule, and bit for bit on an integer-valued coupling
  (every sum exact in any order), drawing the same stream unfed;
* the contract the gather relies on: every f32 and bf16 coupling
  ``build_sampler_model`` builds for the flagship configurations (plain
  Gibbs, PT, ``SAMPLER_MATMUL_DTYPE="bfloat16"``) is zero off the plan's
  edges;
* the cached table holds no values: two couplings on one plan each sample
  with their own; CPU calls count no launch;
* the live spans the kernel sweeps (``live_spans``): the fresh flagship
  plan (256 live columns of 768), the scaled plan (5,640 of 6,016), a plan
  with no padding (the padded spans), hand-built plans with padding inside
  a span or touched by an edge (the padded span), and the ``columns``
  counter's counts (a CPU call counts nothing).
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
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops import gibbs_sparse as gs
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

SEED = 775321899904
MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
GRAPHS = Path(__file__).resolve().parent.parent / "portbench" / "configs"
CHAIN_RULE = 0.98


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


@pytest.fixture(scope="module")
def plans():
    """{name: (JAX plan, port plan, {model: (hp, A) numpy})}: the served
    checkpoint's plan (n_pad 640, 5 colors) with its own scaled model and a
    |J| ≤ 1 model, and the fresh flagship plan (n_pad 768, 6 colors) with a
    |J| ≤ 1 model."""
    params, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    fg, _ = cached_latent_graph("Advantage2_system1", 256, SEED)
    out = {}
    for name, graph in (("checkpoint", jg), ("flagship", fg)):
        jgraph = jgrbm.GRBMGraph(n=graph.n, edge_i=graph.edge_i, edge_j=graph.edge_j)
        tgraph = tgrbm.GRBMGraph(n=graph.n, edge_i=graph.edge_i, edge_j=graph.edge_j)
        jplan, tplan = jgibbs.build_plan(jgraph), tgibbs.build_plan(tgraph)
        rng = np.random.default_rng(graph.n_edges)
        models = {"strong": (rng.uniform(-0.5, 0.5, graph.n).astype(np.float32),
                             rng.uniform(-1.0, 1.0, graph.n_edges).astype(np.float32))}
        if name == "checkpoint":
            h, j = jgrbm.scaled_ising(params, 0.05, (-4.0, 4.0), (-1.0, 1.0))
            models["own"] = (np.asarray(h), np.asarray(j))
        for m, (h, j) in list(models.items()):
            hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
            models[m] = (np.asarray(hp), np.asarray(a))
        out[name] = (jplan, tplan, models)
    assert (out["checkpoint"][1].n_pad, out["flagship"][1].n_pad) == (640, 768)
    return out


# ---------------------------------------------------------------------------
# the words
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["checkpoint", "flagship"])
def test_words_rebuild_the_stored_coupling(plans, name):
    """Decoding the gathered f32 words and scattering the values back at
    (neighbour, column) rebuilds the dense f32 matrix bit for bit; every
    directed edge has a word, every empty slot is zero."""
    _jplan, plan, models = plans[name]
    a = _t(models["strong"][1])
    nbr, vals = _f32_words(a, plan)
    used = _t(gs.neighbor_table(plan)[1]) >= 0
    cols = torch.arange(plan.n_pad).expand_as(nbr)
    rebuilt = torch.zeros_like(a)
    rebuilt[nbr[used], cols[used]] = vals[used]
    assert torch.equal(rebuilt.view(torch.int32), a.view(torch.int32))
    assert int(used.sum()) == 2 * len(plan.perm_edge_i)
    assert bool((vals[~used] == 0).all() and (nbr[~used] == 0).all())
    words = gs.table_words(a, plan)
    assert bool(((words >> 32) == nbr).all())  # the neighbour in the high 32 bits


def test_words_keep_every_f32_bit_pattern(plans):
    """Special values survive the word: −0, the smallest subnormal, the
    largest finite f32 and a negative value, each read back with its own
    bits, and the neighbour beside it unchanged."""
    _jplan, plan, models = plans["checkpoint"]
    a = _t(models["strong"][1]).clone()
    specials = torch.tensor([-0.0, 1e-45, 3.4028235e38, -1.5e-3], dtype=torch.float32)
    ei, ej = plan.perm_edge_i[:4], plan.perm_edge_j[:4]
    a[ei, ej] = specials
    a[ej, ei] = specials
    nbr, vals = _f32_words(a, plan)
    _n, off = gs.neighbor_table(plan)
    for k, c, v in zip(ei, ej, specials):
        slot = np.flatnonzero(off[:, c] == k * plan.n_pad + c)
        assert len(slot) == 1 and int(nbr[slot[0], c]) == k
        assert int(vals[slot[0], c].view(torch.int32)) == int(v.view(torch.int32))


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

CHAINS, SWEEPS = 16, 6
_CASES = {"checkpoint_own": ("checkpoint", "own"), "checkpoint_strong": ("checkpoint", "strong"),
          "flagship_strong": ("flagship", "strong")}


def _inputs(plan, chains, sweeps, seed, beta_kind="per_chain"):
    rng = np.random.default_rng(seed)
    s0 = rng.choice([-1.0, 1.0], (chains, plan.n_pad)).astype(np.float32)
    u = rng.random((sweeps, chains, plan.n_pad), dtype=np.float32)
    beta = (np.float32(1.0) if beta_kind == "one"
            else rng.uniform(0.5, 2.0, chains).astype(np.float32))
    return s0, u, beta


@pytest.mark.parametrize("beta_kind", ["one", "per_chain"])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_plain_gather_matches_pallas(plans, case, track, beta_kind):
    """K1-f32's plain version (the wrapper's CPU branch) against
    ``gibbs_sweeps_pallas(interpret=True, uniforms=u)``: the chain rule,
    the run moves every chain, and ΔE on identical chains within 1e-4
    (the checkpoint's own model) or 1e-3·(1 + |E|) (|J| ≤ 1)."""
    name, model = _CASES[case]
    jplan, tplan, models = plans[name]
    hp, a = models[model]
    s0, u, beta = _inputs(tplan, CHAINS, SWEEPS, len(case) + 10 * track, beta_kind)
    ref = gibbs_sweeps_pallas(jax.random.PRNGKey(0), jnp.asarray(hp), jnp.asarray(a), jplan,
                              jnp.asarray(s0), SWEEPS, beta=jnp.asarray(beta), interpret=True,
                              uniforms=jnp.asarray(u), track_delta_e=track)
    ours = gibbs_cuda.gibbs_sweeps_cuda(_t(hp), _t(a), tplan, _t(s0), SWEEPS,
                                        1.0 if beta_kind == "one" else _t(beta),
                                        uniforms=_t(u), track_delta_e=track)
    if track:
        (ours, de), (ref, ref_de) = ours, ref
    ref = np.asarray(ref)
    same = (ours.numpy() == ref).all(axis=1)
    assert same.mean() >= CHAIN_RULE, f"only {same.mean():.3f} of chains identical"
    assert (ours.numpy() != s0).any(axis=1).all()  # the run moves every chain
    if track:
        err = np.abs(de.numpy() - np.asarray(ref_de))[same]
        if model == "own":
            assert float(err.max()) <= 1e-4
        else:
            e = tgibbs.ising_energies(_t(hp), _t(a), _t(ref)).abs().numpy()[same]
            assert (err <= 1e-3 * (1 + e)).all(), float(err.max())


@pytest.mark.parametrize("case", list(_CASES))
def test_color_step_fields_match_jax(plans, case):
    """One color step's fields, summed from the f32 words in the kernel's
    slot order, against the JAX f32 product S · A[:, span] + h (full f32
    precision), within 1e-5, for every class span."""
    name, model = _CASES[case]
    _jplan, tplan, models = plans[name]
    hp, a = models[model]
    s0 = np.random.default_rng(3).choice([-1.0, 1.0], (64, tplan.n_pad)).astype(np.float32)
    nbr, vals = _f32_words(_t(a), tplan)
    for c0, c1, _b0, _b1 in tgibbs.class_spans(tplan):
        ours = (gs.span_sums(_t(s0), nbr, vals, c0, c1) + _t(hp)[c0:c1]).numpy()
        ref = np.asarray(jnp.dot(jnp.asarray(s0), jnp.asarray(a)[:, c0:c1],
                                 precision=jax.lax.Precision.HIGHEST) + hp[c0:c1])
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the plain version against the dense plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["checkpoint", "flagship"])
def test_plain_gather_holds_the_chain_rule_against_the_dense_plain_version(plans, name):
    """|J| ≤ 1, per-chain β, ΔE on: the gather's plain version against
    ``gibbs_sweeps_kernel_reference`` on the same dense f32 matrix: ≥ 98 %
    of chains identical, ΔE within 1e-3·(1 + |E|) on them."""
    _jplan, plan, models = plans[name]
    hp, a = map(_t, models["strong"])
    s0, u, beta = map(_t, _inputs(plan, 64, 4, 2))
    dense, dense_de = tgibbs.gibbs_sweeps_kernel_reference(hp, a, plan, s0, 4, beta, uniforms=u,
                                                           track_delta_e=True)
    out, de = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 4, beta, uniforms=u, track_delta_e=True)
    same = (out == dense).all(dim=1)
    assert float(same.float().mean()) >= CHAIN_RULE
    e = tgibbs.ising_energies(hp, a, dense).abs()
    assert bool(((de - dense_de).abs()[same] <= 1e-3 * (1 + e[same])).all())


@pytest.mark.parametrize("name", ["checkpoint", "flagship"])
def test_integer_coupling_is_bit_identical(plans, name):
    """Integer h and J = ±1: every sum is exact in any order, so the
    gather's plain version equals the dense plain version bit for bit,
    spins and ΔE, fed; unfed, it draws the same stream from the
    generator."""
    _jplan, plan, _models = plans[name]
    rng = np.random.default_rng(4)
    hp = torch.zeros(plan.n_pad)
    hp[_t(np.flatnonzero(plan.valid_mask))] = _t(np.round(rng.normal(size=plan.n))
                                                 .astype(np.float32))
    a = torch.zeros((plan.n_pad, plan.n_pad))
    ei, ej = _t(plan.perm_edge_i).long(), _t(plan.perm_edge_j).long()
    j = _t(rng.choice([-1.0, 1.0], len(ei)).astype(np.float32))
    a[ei, ej] = j
    a[ej, ei] = j
    s0, u, beta = map(_t, _inputs(plan, 16, 3, 5))
    dense = tgibbs.gibbs_sweeps_kernel_reference(hp, a, plan, s0, 3, beta, uniforms=u,
                                                 track_delta_e=True)
    ours = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 3, beta, uniforms=u, track_delta_e=True)
    assert torch.equal(ours[0], dense[0]) and torch.equal(ours[1], dense[1])
    drawn = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 3, beta,
                                   generator=torch.Generator().manual_seed(6))
    ref = tgibbs.gibbs_sweeps_kernel_reference(hp, a, plan, s0, 3, beta,
                                               generator=torch.Generator().manual_seed(6))
    assert torch.equal(drawn, ref)


# ---------------------------------------------------------------------------
# the contract, the cache, the counters
# ---------------------------------------------------------------------------

_FLAGSHIP_CONFIGS = {  # name: (overrides, stored dtype)
    "plain": ({}, torch.float32),
    "pt": (dict(SAMPLER="pt"), torch.float32),
    "bf16": (dict(SAMPLER_MATMUL_DTYPE="bfloat16"), torch.bfloat16),
    "bf16_pt": (dict(SAMPLER_MATMUL_DTYPE="bfloat16", SAMPLER="pt"), torch.bfloat16),
}


@pytest.mark.parametrize("case", list(_FLAGSHIP_CONFIGS))
def test_built_coupling_is_zero_off_the_plans_edges(case):
    """The contract the gather relies on: every nonzero of the f32 or bf16
    coupling the flagship dispatch stores (``build_sampler_model``:
    permute, cast) sits at one of the table's offsets, and the dispatch
    sends it to K1 (``cuda_vmem``)."""
    overrides, dtype = _FLAGSHIP_CONFIGS[case]
    graph, _ = cached_latent_graph("Advantage2_system1", 256, SEED)
    plan = tgibbs.build_plan(graph)
    fns = make_sample_fns(TrainingConfig(**overrides), graph, plan, device="cpu")
    assert fns.sampler_impl == "cuda_vmem"
    params = graph.init_params(torch.Generator().manual_seed(3), scale=1.0)
    _hp, coupling = fns.build_sampler_model(params)
    assert coupling.dtype == dtype and tuple(coupling.shape) == (plan.n_pad, plan.n_pad)
    _nbr, off = gs.neighbor_table(plan)
    at_edges = torch.zeros(coupling.numel(), dtype=torch.bool)
    at_edges[_t(off[off >= 0]).long()] = True
    flat = coupling.reshape(-1)
    assert int((flat[~at_edges] != 0).sum()) == 0
    assert int((flat[at_edges] != 0).sum()) > 0


def test_cached_table_holds_no_values(plans):
    """The (nbr, off) table is cached per (plan, chunk, device) and the
    values are gathered on every call: after a run on one f32 coupling, a
    run on another coupling of the same plan equals that coupling's run on
    a fresh plan object (nothing cached), and differs from the first."""
    _jplan, plan, models = plans["flagship"]
    graph, _ = cached_latent_graph("Advantage2_system1", 256, SEED)
    fresh = tgibbs.build_plan(graph)
    hp, a = map(_t, models["strong"])
    b = a * -0.5
    s0, u, beta = map(_t, _inputs(plan, 8, 2, 7))
    first = gs.gibbs_sweeps_sparse(hp, a, plan, s0, 2, beta, uniforms=u)
    second = gs.gibbs_sweeps_sparse(hp, b, plan, s0, 2, beta, uniforms=u)
    assert torch.equal(second, gs.gibbs_sweeps_sparse(hp, b, fresh, s0, 2, beta, uniforms=u))
    assert not torch.equal(first, second)
    assert not torch.equal(gs.table_words(a, plan), gs.table_words(b, plan))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_count_no_launch(plans, dtype):
    """An f32 or bf16 K1 call on CPU tensors runs the plain version, fed or
    drawn, with and without ΔE, and counts nothing."""
    _jplan, plan, models = plans["checkpoint"]
    hp, a = map(_t, models["own"])
    s0, u, _beta = map(_t, _inputs(plan, 2, 1, 8))
    gibbs_cuda.gibbs_sweeps_cuda.launches.clear()
    out = gibbs_cuda.gibbs_sweeps_cuda(hp, a.to(dtype), plan, s0, 1, uniforms=u)
    drawn, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a.to(dtype), plan, s0, 1,
                                             generator=torch.Generator().manual_seed(1),
                                             track_delta_e=True)
    assert out.shape == drawn.shape == s0.shape and de.shape == (2,)
    assert not gibbs_cuda.gibbs_sweeps_cuda.launches
    with pytest.raises(TypeError):
        gibbs_cuda.gibbs_sweeps_cuda(hp, a.double(), plan, s0, 1)


# ---------------------------------------------------------------------------
# the live spans
# ---------------------------------------------------------------------------

def _frozen_plan(name, **kw):
    """The plan of a benchmark configuration's frozen graph."""
    with np.load(GRAPHS / f"{name}.graph.npz") as z:
        graph = tgrbm.GRBMGraph(n=int(z["n"]), edge_i=z["edge_i"], edge_j=z["edge_j"])
    return tgibbs.build_plan(graph, **kw)


def test_live_spans_of_the_flagship_plan():
    """The fresh flagship plan (``flagship.graph.npz``): six 128-wide class
    spans holding 63, 62, 70, 44, 14 and 3 live columns; the kernel sweeps
    those and draws the other 512 once."""
    plan = _frozen_plan("flagship")
    spans = gs.live_spans(plan)
    assert [(c0, c1) for c0, _stop, c1 in spans] == [(128 * i, 128 * i + 128) for i in range(6)]
    assert [stop - c0 for c0, stop, _c1 in spans] == [63, 62, 70, 44, 14, 3]
    assert gs._device_table(plan, None, "cpu")[3] == (256, 512)


def test_live_spans_of_the_scaled_plan():
    """The scaled plan (``scaled.graph.npz``, 7 class spans of up to 11
    blocks): only each span's last block has padding, so 5,640 of its
    6,016 columns sweep, the panel table's counts alike."""
    plan = _frozen_plan("scaled")
    spans = gs.live_spans(plan)
    assert [(c0, c1) for c0, _stop, c1 in spans] == [
        (c0, c1) for c0, c1, _b0, _b1 in tgibbs.class_spans(plan)]
    assert [stop for _c0, stop, _c1 in spans] == [
        plan.blocks[b1 - 1][1] for _c0, _c1, _b0, b1 in tgibbs.class_spans(plan)]
    assert sum(stop - c0 for c0, stop, _c1 in spans) == plan.n == 5640
    assert gs._device_table(plan, 256, "cpu")[3] == (5640, 376)


def test_live_spans_without_padding_are_the_padded_spans(plans):
    """A plan with no padding (``pad_to=1``) sweeps exactly its class spans
    and draws nothing once; the served checkpoint's plan holds 256 live
    columns of 640."""
    plan = _frozen_plan("flagship", pad_to=1)
    assert plan.n_pad == plan.n
    assert gs.live_spans(plan) == tuple((c0, c1, c1) for c0, c1, _b0, _b1
                                        in tgibbs.class_spans(plan))
    assert gs._device_table(plan, None, "cpu")[3] == (plan.n, 0)
    served = plans["checkpoint"][1]
    assert [stop - c0 for c0, stop, _c1 in gs.live_spans(served)] == [72, 68, 67, 37, 12]
    assert gs._device_table(served, None, "cpu")[3] == (256, 384)


def _hand_plan(edges):
    """Three blocks of 4 columns, the first two one color class (span
    [0, 8)), the third another (span [8, 12)); 2 live columns a block."""
    ei, ej = (np.asarray(x, np.int32) for x in zip(*edges))
    valid = np.zeros(12, bool)
    valid[[0, 1, 4, 5, 8, 9]] = True
    return tgibbs.GibbsPlan(n=6, n_pad=12, blocks=((0, 2, 4), (4, 6, 8), (8, 10, 12)),
                            orig_to_perm=np.flatnonzero(valid).astype(np.int32),
                            perm_edge_i=ei, perm_edge_j=ej, valid_mask=valid,
                            block_class=(0, 0, 1))


def test_live_spans_keep_padding_inside_a_span_or_coupled():
    """A hand-built plan whose first span has padding inside it (block 0)
    keeps that span padded; its second span sweeps its two live columns.
    An edge touching a padding column keeps that span padded too."""
    plan = _hand_plan([(0, 8), (1, 9), (4, 8), (5, 9)])
    assert gs.live_spans(plan) == ((0, 8, 8), (8, 10, 12))
    assert gs._device_table(plan, None, "cpu")[3] == (10, 2)
    coupled = _hand_plan([(0, 8), (1, 9), (4, 11)])
    assert gs.live_spans(coupled) == ((0, 8, 8), (8, 12, 12))
    assert gs._device_table(coupled, None, "cpu")[3] == (12, 0)


def test_launch_threads_follow_the_widest_live_span(plans):
    """The threads a block: 512 for one chain a block, and for G = 2 and 4
    on the flagship plans (a pass of 512 covers their widest live span,
    72 and 70 columns); 1,024 at G = 8 and 16 there, G itself the fullest
    wave's.  The scaled plan (1,407 columns, wider than a 512-thread pass)
    takes one chain a block at every chain count."""
    shapes = {256: (1, 512), 512: (2, 512), 1024: (4, 512), 2048: (8, 1024), 4096: (16, 1024)}
    for plan in (plans["checkpoint"][1], _frozen_plan("flagship")):
        assert {c: gs.launch_shape(plan, c) for c in shapes} == shapes
    scaled = _frozen_plan("scaled")
    assert max(stop - c0 for c0, stop, _c1 in gs.live_spans(scaled)) == 1407
    assert {c: gs.launch_shape(scaled, c) for c in list(shapes) + [2304, 3840]} == {
        c: (1, 512) for c in list(shapes) + [2304, 3840]}


def test_cpu_calls_count_no_columns(plans):
    """The ``columns`` counter counts launches only: K1 and the streaming
    route's calls on CPU tensors (fed, drawn, with ΔE) leave it empty, as
    they leave ``launches``."""
    from image_generation_tpu_torch.ops import gibbs_hbm_cuda

    _jplan, plan, models = plans["checkpoint"]
    hp, a = map(_t, models["own"])
    s0, u, _beta = map(_t, _inputs(plan, 2, 2, 9))
    gs.gibbs_sweeps_sparse.columns.clear()
    gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 2, uniforms=u)
    gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 1, generator=torch.Generator().manual_seed(2),
                                 track_delta_e=True)
    gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda(hp, a, plan, s0, 2, uniforms=u)
    assert not gs.gibbs_sweeps_sparse.columns
