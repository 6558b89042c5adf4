"""Port parity: the sampler backends and the Trainer's generation surface.

Inputs are made with numpy from a seed (or drawn by JAX from its keys and
fed to the port) on the 32-latent Advantage2_prototype graph.  The JAX
package is the oracle:

  * ``GibbsSampler`` against the JAX backend (its XLA ``gibbs_sweeps``),
    with JAX's initial chains and the uniforms it draws for its span steps
    fed to the port: ≥ 98 % of chains identical (the port's CPU branch is
    the gather kernel's plain version, whose f32 sums run in another order,
    so a draw within an ulp of its probability can flip), energies within
    1e-4 on identical chains; ``PTSampler`` against ``pt_sample`` the same
    way, the round draws replayed;
  * ``ExactSampler`` moments against ``exact_moments`` on 8 spins within 5
    standard errors;
  * ``PersistentSampleCache``: the schedule, deque contents and ``reset``
    against JAX's with a deterministic fake backend;
  * ``generate_output`` decoding the same spins from ``train_state_from_jax``
    weights: images within 1e-5, grids of JAX's shape;
    ``generate_reconstructed_samples``: the interleave and the white
    separator column as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import exact as jexact
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.samplers import base as jbase
from image_generation_tpu.samplers import gibbs_sampler as jgs
from image_generation_tpu.samplers import persistent as jpersist
from image_generation_tpu.training import step as jstep
from image_generation_tpu.training.trainer import Trainer as JaxTrainer
from image_generation_tpu.utils.sampleset import SampleSet as JaxSampleSet
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops.exact import exact_sample
from image_generation_tpu_torch.samplers import (
    ExactSampler,
    GibbsSampler,
    PersistentSampleCache,
    PTSampler,
    get_sampler,
    get_sampler_and_graph,
    push_to_deque,
)
from image_generation_tpu_torch.training.step import make_train_fns, train_state_from_jax
from image_generation_tpu_torch.training.trainer import Trainer
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph
from image_generation_tpu_torch.utils.sampleset import SampleSet
from test_torch_pt import _jax_round_draws, _jax_sweep_uniforms, _t

SEED = 775321899904
CHAIN_RULE = 0.98
SMALL = dict(N_LATENTS=32, NUM_READS=16, BATCH_SIZE=16, DATASET_SIZE=64, N_REPLICAS=2,
             GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, PT_NUM_BETAS=3, COMPUTE_DTYPE="float32",
             QPU="Advantage2_prototype")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny tensor ops: one intra-op thread for this module (the suite
    runs six worker processes at once), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    tg, _ = cached_latent_graph("Advantage2_prototype", 32, SEED)
    jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
    return jg, jgibbs.build_plan(jg), tg


def _model(tg, strength: float, seed: int = 0):
    """A scaled, clipped (h, J) as numpy f32: |h| ≤ 0.5·strength, |J| ≤ strength."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, tg.n).astype(np.float32) * strength,
            rng.uniform(-1.0, 1.0, tg.n_edges).astype(np.float32) * strength)


def _same_chains(ours: SampleSet, ref) -> np.ndarray:
    assert ours.spins.shape == np.asarray(ref.spins).shape
    same = (ours.spins == np.asarray(ref.spins)).all(axis=1)
    assert same.mean() >= CHAIN_RULE
    np.testing.assert_allclose(ours.energies[same], np.asarray(ref.energies)[same],
                               rtol=0, atol=1e-4)
    return same


def test_get_sampler_table_matches_jax():
    for name, cls in (("gibbs", GibbsSampler), ("pt", PTSampler), ("exact", ExactSampler)):
        assert isinstance(get_sampler(name), cls) and cls.name == name
        assert type(jbase.get_sampler(name)).name == name
    with pytest.raises(ValueError) as ours:
        get_sampler("anneal")
    with pytest.raises(ValueError) as theirs:
        jbase.get_sampler("anneal")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("strength", [0.3, 1.0])
@pytest.mark.parametrize("persistent", [False, True])
def test_gibbs_sampler_matches_jax(graphs, strength, persistent):
    """Two calls (the second from the held chains when persistent), 64
    reads × 6 sweeps, JAX's chains and span uniforms fed to the port."""
    jg, jplan, tg = graphs
    h, j = _model(tg, strength)
    jsam = jgs.GibbsSampler(n_sweeps=6, persistent=persistent)
    tsam = GibbsSampler(n_sweeps=6, persistent=persistent)
    n0 = dict(gibbs_cuda.gibbs_sweeps_cuda.launches)
    for call, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 2)):
        ref = jsam.sample(jnp.asarray(h), jnp.asarray(j), jg, 64, key)
        k1, k2 = jax.random.split(key)
        init = None
        if call == 0 or not persistent:
            init = _t(np.asarray(jgibbs.random_spins(k1, jplan, 64)))
        ours = tsam.sample(_t(h), _t(j), tg, 64, None, init_spins=init,
                           uniforms=_t(_jax_sweep_uniforms(k2, jplan, 64, 6)))
        _same_chains(ours, ref)
        assert ours.info == ref.info
    # the CPU branch is the plain version: no launch counted
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == n0


def test_gibbs_sampler_runs_exactly_the_sweeps_asked_for(graphs):
    """One sweep differs from two: the count is not rounded up to even."""
    _, _, tg = graphs
    h, j = map(_t, _model(tg, 1.0))
    plan = tgibbs.build_plan(tg)
    init = tgibbs.random_spins(torch.Generator().manual_seed(1), plan, 32)
    u = torch.rand((3, 32, plan.n_pad), generator=torch.Generator().manual_seed(2))
    outs = [GibbsSampler().sample(h, j, tg, 32, None, n, init_spins=init, uniforms=u[:n]).spins
            for n in (1, 2, 3)]
    assert not np.array_equal(outs[0], outs[1]) and not np.array_equal(outs[1], outs[2])


def test_persistent_chains_keyed_by_the_graph_itself(graphs):
    _, _, tg = graphs
    h, j = map(_t, _model(tg, 0.3))
    sam = GibbsSampler(n_sweeps=2, persistent=True)
    sam.sample(h, j, tg, 8, torch.Generator().manual_seed(0))
    (held_graph, chains), = sam._chains.values()
    assert held_graph is tg and chains.shape == (8, tgibbs.build_plan(tg).n_pad)
    twin = tgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
    assert sam._held(sam._chains, twin) is None  # another graph object: fresh chains


def test_pt_sampler_matches_jax(graphs):
    """4 rungs × 8 reads, 3 rounds of 2 sweeps from JAX's initial ladder, each
    round's sweep and swap uniforms replayed from JAX's keys."""
    jg, jplan, tg = graphs
    h, j = _model(tg, 1.0, seed=4)
    betas = np.geomspace(0.25, 1.0, 4)
    kw = dict(n_rounds=3, sweeps_per_round=2, betas=betas)
    key = jax.random.PRNGKey(8)
    ref = jgs.PTSampler(**kw).sample(jnp.asarray(h), jnp.asarray(j), jg, 8, key)
    k_init, k_run = jax.random.split(key)
    init = _t(np.asarray(jgibbs.random_spins(k_init, jplan, 4 * 8))).reshape(4, 8, -1)
    feed = [_jax_round_draws(k, jplan, 4, 8, 2) for k in jax.random.split(k_run, 3)]
    ours = PTSampler(**kw).sample(_t(h), _t(j), tg, 8, None, init_spins=init, feed=feed)
    _same_chains(ours, ref)
    assert ours.info == ref.info


def test_pt_sampler_persistent_ladder_and_default_betas(graphs):
    _, _, tg = graphs
    h, j = map(_t, _model(tg, 0.5))
    sam = PTSampler(n_betas=3, n_rounds=1, sweeps_per_round=1, persistent=True)
    np.testing.assert_allclose(sam.betas.numpy(), np.geomspace(0.25, 1.0, 3), rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    a = sam.sample(h, j, tg, 4, g)
    (_, ladder), = sam._ladders.values()
    assert ladder.shape == (3, 4, tgibbs.build_plan(tg).n_pad)
    assert len(sam.sample(h, j, tg, 4, g)) == len(a) == 4
    assert len(sam.sample(h, j, tg, 6, g)) == 6  # another read count: a fresh ladder


def test_exact_sampler_moments_match_enumeration():
    """8 spins on a ring with chords, 20,000 reads: means and edge
    correlations within 5 standard errors of ``exact_moments``."""
    ei = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, 2], np.int32)
    ej = np.array([1, 2, 3, 4, 5, 6, 7, 0, 4, 6], np.int32)
    g = tgrbm.GRBMGraph(n=8, edge_i=ei, edge_j=ej)
    rng = np.random.default_rng(5)
    h = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    j = rng.uniform(-1.0, 1.0, 10).astype(np.float32)
    n = 20_000
    ss = ExactSampler().sample(_t(h), _t(j), g, n, torch.Generator().manual_seed(0))
    m1, m2 = jexact.exact_moments(h, ei, ej, j)  # the JAX package's oracle
    s = ss.spins.astype(np.float64)
    for emp, exact in ((s.mean(0), m1), ((s[:, ei] * s[:, ej]).mean(0), m2)):
        se = np.sqrt(np.maximum(1.0 - exact**2, 1e-12) / n)
        assert (np.abs(emp - exact) <= 5 * se).all()
    np.testing.assert_allclose(ss.energies, s @ h + (s[:, ei] * s[:, ej]) @ j, atol=1e-5)
    # the draw is the generator's: the same seed, the same samples
    again = exact_sample(torch.Generator().manual_seed(0), h, ei, ej, j, n)
    np.testing.assert_array_equal(again, ss.spins)


class _FakeBackend:
    """Deterministic reads: call k returns rows filled with k (±1 pattern
    by row), ignoring the key or generator."""

    name = "fake"

    def __init__(self, sampleset_cls):
        self.calls = 0
        self.cls = sampleset_cls

    def sample(self, h, q, graph, num_reads, key, **kw):
        self.calls += 1
        spins = np.where((np.arange(num_reads)[:, None] + self.calls + np.arange(graph.n)) % 3,
                         1.0, -1.0).astype(np.float32)
        return self.cls(spins=spins, energies=np.full(num_reads, float(self.calls)))


def test_persistent_cache_schedule_matches_jax(graphs):
    jg, _, tg = graphs
    h, j = _model(tg, 0.5)
    jb, tb = _FakeBackend(JaxSampleSet), _FakeBackend(SampleSet)
    jc = jpersist.PersistentSampleCache(jb, max_deque_size=24, iterations_before_resampling=3)
    tc = PersistentSampleCache(tb, max_deque_size=24, iterations_before_resampling=3)
    g = torch.Generator().manual_seed(0)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(0), 14)):
        if i == 9:
            jc.reset()
            tc.reset()
            assert tc.deque is None and tc.iterations_since_last_resampling == 0
        ref = jc.sample(jnp.asarray(h), jnp.asarray(j), jg, 8, key)
        ours = tc.sample(_t(h), _t(j), tg, 8, g)
        assert (tb.calls, tc.iterations_since_last_resampling, tc.current_deque_size) == (
            jb.calls, jc.iterations_since_last_resampling, jc.current_deque_size)
        np.testing.assert_array_equal(tc.deque, jc.deque)
        assert ours.info.get("sampler") == ref.info.get("sampler")
        if ours.info.get("sampler") == "cache":  # rows of the deque, their own energies
            assert all((tc.deque == row).all(1).any() for row in ours.spins)
            s = ours.spins
            np.testing.assert_allclose(
                ours.energies, s @ h + (s[:, tg.edge_i] * s[:, tg.edge_j]) @ j, atol=1e-5)
    d = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(push_to_deque(d, d + 10, 4), jpersist.push_to_deque(d, d + 10, 4))


def test_factory_builds_the_jax_graph():
    backend, kw, g, hr, jr = get_sampler_and_graph(16, 32, SEED, "Advantage2_prototype", "pt")
    tg, _ = cached_latent_graph("Advantage2_prototype", 32, SEED)
    assert isinstance(backend, PTSampler) and kw == {"num_reads": 16}
    assert (hr, jr) == ((-4.0, 4.0), (-1.0, 1.0))
    assert g.n == tg.n and np.array_equal(g.edge_i, tg.edge_i) and np.array_equal(g.edge_j, tg.edge_j)


# ---------------------------------------------------------------------------
# the Trainer's generation surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainers(graphs):
    """A JAX Trainer and a port Trainer around the same weights (the port's
    from ``train_state_from_jax``) and the same dataset images."""
    jg, jplan, tg = graphs
    imgs = (np.random.default_rng(0).random((32, 32, 32, 1)) > 0.6).astype(np.float32)
    jfns = jstep.make_train_fns(JaxConfig(**SMALL), jg, 10, jplan)
    # jitted: the eager init compiles op by op
    state = jax.jit(jfns.init)(jax.random.PRNGKey(7), jnp.asarray(imgs[:1]))
    jt = JaxTrainer(qpu="Advantage2_prototype", config=JaxConfig(**SMALL), mesh=None)
    jt.graph, jt.plan, jt.fns, jt.state = jg, jplan, jfns, state
    jt.images, jt._init_done = jnp.asarray(imgs), True
    tt = Trainer(TrainingConfig(**SMALL), device="cpu")
    tt.graph, tt.plan = tg, tgibbs.build_plan(tg)
    tt.fns = make_train_fns(tt.config, tg, 10, tt.plan, device="cpu")
    tt.state = train_state_from_jax(tt.fns, state)
    tt.dvae, tt.grbm_params, tt.images, tt._init_done = (tt.state.dvae, tt.state.grbm_params,
                                                           _t(imgs), True)
    return jt, tt


@pytest.mark.parametrize("sharpen", [False, True])
def test_generate_output_decodes_like_jax(trainers, monkeypatch, sharpen):
    jt, tt = trainers
    spins = np.random.default_rng(3).choice([-1.0, 1.0], (40, 32)).astype(np.float32)
    monkeypatch.setattr(jt, "sample_sampleset", lambda n=None: JaxSampleSet(spins=spins))
    monkeypatch.setattr(tt, "sample_sampleset", lambda n=None: SampleSet(spins=spins))
    ref, ours = jt.generate_output(do_sharpen=sharpen), tt.generate_output(do_sharpen=sharpen)
    assert ours["images"].shape == ref["images"].shape == (40, 32, 32, 1)
    np.testing.assert_allclose(ours["images"], np.asarray(ref["images"]), rtol=0, atol=1e-5)
    assert ours["grid"].shape == ref["grid"].shape
    np.testing.assert_array_equal(ours["latents"], spins)


def test_generate_reconstructed_samples_layout_matches_jax(trainers):
    jt, tt = trainers
    ref, ours = jt.generate_reconstructed_samples(), tt.generate_reconstructed_samples()
    assert ours["grid"].shape == ref["grid"].shape and ours["images"].shape == ref["images"].shape
    b = SMALL["BATCH_SIZE"]
    for out in (ours, np.asarray(ref["images"])):
        pairs = out["images"] if isinstance(out, dict) else out
        np.testing.assert_array_equal(pairs[0::2], tt.images[:b].numpy())  # originals
        assert (pairs[1::2, :, -1, :] == 1.0).all()  # the separator column
        assert ((pairs[1::2] >= 0) & (pairs[1::2] <= 1)).all()
    assert tt.generate_reconstucted_samples.__func__ is Trainer.generate_reconstructed_samples


def test_generate_loss_plot_matches_jax(trainers):
    jt, tt = trainers
    for t in (jt, tt):
        t.losses = {"mse_losses": [0.5, 0.4], "dvae_losses": [1.0, 0.9]}
    old = {"mse_losses": [0.7], "dvae_losses": [1.2]}
    assert tt.generate_loss_plot(old) == jt.generate_loss_plot(old)
    assert tt.generate_loss_plot() == jt.generate_loss_plot()


def test_sample_sampleset_resets_the_cache_on_new_parameters(trainers):
    """Training updates the GRBM in place: the cache must notice (the
    tensors' versions) as JAX's notices a new parameter leaf."""
    _, tt = trainers
    t = Trainer(TrainingConfig(**dict(SMALL, MAX_DEQUE_SIZE=16)), device="cpu")
    t.graph, t.plan, t.fns, t.state = tt.graph, tt.plan, tt.fns, tt.state
    t.grbm_params, t.dvae = tt.state.grbm_params, tt.state.dvae
    a = t.sample_sampleset(16)  # fills the deque (16 = its size)
    assert t.sampler_backend().current_deque_size == 16 and a.info["sampler"] == "gibbs"
    assert t.sample_sampleset(16).info["sampler"] == "cache"
    with torch.no_grad():
        t.grbm_params.linear.add_(0.0)  # an in-place update
    assert t.sample_sampleset(16).info["sampler"] == "gibbs"
    assert t.sample_sampleset(16).info["sampler"] == "cache"
    t.grbm_params = tgrbm.GRBMParams(t.grbm_params.linear.clone(), t.grbm_params.quadratic)
    assert t.sample_sampleset(16).info["sampler"] == "gibbs"  # other tensors


def test_pt_sample_sampleset_runs_the_live_ladder(graphs):
    _, _, tg = graphs
    t = Trainer(TrainingConfig(**dict(SMALL, SAMPLER="pt")), device="cpu")
    t.train_init(1)
    t.state.pt_betas = torch.tensor([0.3, 0.6, 1.0])
    ss = t.sample_sampleset(8)
    assert ss.info["sampler"] == "pt" and ss.spins.shape == (8, 32)
    np.testing.assert_array_equal(t.sampler_backend().backend.betas.numpy(),
                                  np.float32([0.3, 0.6, 1.0]))
