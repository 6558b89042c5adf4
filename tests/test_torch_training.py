"""Port parity: the training slice on the CPU.

Each module of the training path against the JAX package at a small size
(32 latents on Advantage2_prototype, batch 8, 2 replicas, a few sweeps),
then one full training step under both samplers and both
``PERSISTENT_CHAINS`` modes from the same state (``train_state_from_jax``),
then a short run.  Inputs are made with numpy; data passes as numpy.

Randomness of the step: the port is fed the draws JAX makes from its keys
(sweep and swap uniforms, computed here from the step's key split; the
straight-through uniforms, recorded from inside the JAX step), and both
sides run Dropout2d at rate 0: the JAX decoder's ``nn`` is swapped for
one whose ``Dropout`` has rate 0 inside the test, the port gets unit
channel masks.  Nothing in the JAX package changes.

The step's MSE is held at rtol 1e-5 against the mean of JAX's own
residual (recorded from inside the step) summed in f64: XLA's jitted f32
mean over the 16,384 residuals of a step is itself 1.8e-5 off that sum
(measured here), so against JAX's reported MSE the bound is 5e-5.

Tolerances (f32 on both sides, sums in another order): losses rtol 1e-5;
DVAE gradients within 1e-4 of each tensor's largest entry, plus 1e-7
(a weight's gradient sums over every position of its layer; measured:
1.4e-6 on a tensor whose largest entry is 0.08), and below 1e-5 for the
biases of convolutions that BatchNorm follows (zero in exact arithmetic); an Adam update from equal gradients 1e-7; BatchNorm running
statistics rtol 1e-5 with atol 1e-6 (measured: 1.8e-6 on 0.36, a mean
over 2,048 activations); GRBM parameters 1e-6; chains by the ≥ 98 % rule
of tests/test_torch_gibbs.py.
"""

import types
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.io.checkpoint import load_model_dir as jax_load_model_dir
from image_generation_tpu.io.torch_pth import dvae_state_dict_from_params
from image_generation_tpu.models import decoder as jdecoder
from image_generation_tpu.models import dvae as jdvae
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import block_sparse as jbs
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import mmd as jmmd
from image_generation_tpu.training import step as jstep
from image_generation_tpu.training.schedules import geomspace_lr as jax_geomspace_lr
from image_generation_tpu.utils import data as jdata
from image_generation_tpu.utils import subgraph as jsub
from image_generation_tpu.utils import topology as jtopo
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.torch_pth import dvae_state_dict_from_jax
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.models.dvae import DVAE
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import mmd as tmmd
from image_generation_tpu_torch.training.schedules import geomspace_lr
from image_generation_tpu_torch.training.step import (
    StepFeed,
    make_sample_fns,
    make_train_fns,
    train_state_from_jax,
)
from image_generation_tpu_torch.training.trainer import Trainer, TrainingError
from image_generation_tpu_torch.utils import data as tdata
from test_torch_pt import _jax_round_draws, _jax_sweep_uniforms

SEED = 775321899904
SMALL = dict(N_LATENTS=32, NUM_READS=16, BATCH_SIZE=8, N_REPLICAS=2, GIBBS_SWEEPS=3,
             GIBBS_BURN_IN=4, PT_NUM_BETAS=3, COMPUTE_DTYPE="float32",
             QPU="Advantage2_prototype")
DECODER_CHANNELS = (128, 64, 32, 1)
# biases of convolutions followed by batch-statistics BatchNorm: the
# normalisation removes them, so their gradient is 0 up to f32 noise
_BIAS_BEFORE_BN = {f"_encoder.conv.{i}.bias" for i in (0, 4, 8, 12)} | {
    f"_decoder.convtrans.{i}.bias" for i in (0, 5, 10, 15)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def graphs():
    jlat, _ = jsub.select_latent_graph(jtopo.graph_for_qpu("Advantage2_prototype"), 32, SEED)
    jg = jgrbm.GRBMGraph.from_networkx(jlat)
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    return jg, jgibbs.build_plan(jg), tg, tgibbs.build_plan(tg)


@pytest.fixture(scope="module")
def jax_capture():
    """Patches, for this module only: the JAX decoder's Dropout at rate 0,
    and recorders for the straight-through uniforms and the step's
    ``value_and_grad`` output (through ``jax.debug.callback``, so they
    work under jit)."""
    rec = {}
    nn0 = types.SimpleNamespace(**{k: getattr(flax_nn, k) for k in dir(flax_nn)
                                   if not k.startswith("__")})
    nn0.Dropout = lambda rate, **kw: flax_nn.Dropout(rate=0.0, **kw)
    orig_st = jdvae.spins_straight_through

    def st(logits, n_replicas, key):
        u = jax.random.uniform(key, (logits.shape[0], n_replicas, logits.shape[1]),
                               dtype=logits.dtype)
        jax.debug.callback(lambda x: rec.__setitem__("u", np.asarray(x)), u)
        return orig_st(logits, n_replicas, key)

    def value_and_grad(f, **kw):
        inner = jax.value_and_grad(f, **kw)

        def wrapped(*args):
            out = inner(*args)
            jax.debug.callback(
                lambda o: rec.__setitem__("vg", jax.tree.map(np.asarray, o)), out)
            return out

        return wrapped

    jax_ns = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                      if not k.startswith("__")})
    jax_ns.value_and_grad = value_and_grad

    def square(x):  # the step's only square: the MSE residual
        jax.debug.callback(lambda r: rec.__setitem__("residual", np.asarray(r)), x)
        return jnp.square(x)

    jnp_ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                      if not k.startswith("__")})
    jnp_ns.square = square
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdecoder, "nn", nn0)
        mp.setattr(jdvae, "spins_straight_through", st)
        mp.setattr(jstep, "jax", jax_ns)
        mp.setattr(jstep, "jnp", jnp_ns)
        yield rec


def _images(n, seed=0):
    return (np.random.default_rng(seed).random((n, 32, 32, 1)) > 0.6).astype(np.float32)


def _ones_masks(n):
    return [torch.ones((n, c)) for c in DECODER_CHANNELS]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_mmd_value_and_gradient_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, 32)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (16, 32)).astype(np.float32)
    jv, jgx = jax.value_and_grad(lambda a: jmmd.mmd_loss(a, jnp.asarray(y), jmmd.GaussianKernel(7)))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    tv = tmmd.mmd_loss(xt, _t(y), tmmd.GaussianKernel(7))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-7)
    d2 = tmmd.pairwise_sq_dists(_t(x), _t(y))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jmmd.pairwise_sq_dists(x, y)),
                               rtol=1e-5, atol=1e-4)
    k = tmmd.GaussianKernel(5, bandwidth=3.0)
    np.testing.assert_allclose(k(d2).numpy(), np.asarray(jmmd.GaussianKernel(5, bandwidth=3.0)(
        jnp.asarray(d2.numpy()))), rtol=1e-5)


def test_grbm_training_functions_match_jax(graphs):
    jg, _, tg, _ = graphs
    rng = np.random.default_rng(3)
    lin = rng.normal(size=jg.n).astype(np.float32)
    quad = rng.normal(size=jg.n_edges).astype(np.float32)
    data = rng.choice([-1.0, 1.0], (20, jg.n)).astype(np.float32)
    model = rng.choice([-1.0, 1.0], (12, jg.n)).astype(np.float32)
    jp = jgrbm.GRBMParams(jnp.asarray(lin), jnp.asarray(quad))
    tp = tgrbm.GRBMParams(_t(lin), _t(quad))
    np.testing.assert_array_equal(tg.coupling_matrix(_t(quad)).numpy(),
                                  np.asarray(jg.coupling_matrix(jnp.asarray(quad))))
    for ours, ref in zip(tgrbm.suff_stats(tg, _t(data)), jgrbm.suff_stats(jg, jnp.asarray(data))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tgrbm.nll_value(tp, tg, _t(data), _t(model))),
        float(jgrbm.nll_value(jp, jg, jnp.asarray(data), jnp.asarray(model))), rtol=1e-5)
    tgr = tgrbm.nll_grads(tg, _t(data), _t(model))
    jgr = jgrbm.nll_grads(jg, jnp.asarray(data), jnp.asarray(model))
    np.testing.assert_allclose(tgr.linear.numpy(), np.asarray(jgr.linear), atol=1e-6)
    np.testing.assert_allclose(tgr.quadratic.numpy(), np.asarray(jgr.quadratic), atol=1e-6)
    init = tg.init_params(torch.Generator().manual_seed(0))
    assert init.linear.shape == (jg.n,) and init.quadratic.shape == (jg.n_edges,)
    assert 0.005 < float(init.quadratic.std()) < 0.02


def test_geomspace_lr_matches_jax():
    for total in (1, 7, 100):
        ours, ref = geomspace_lr(1e-4, 1e-5, total), jax_geomspace_lr(1e-4, 1e-5, total)
        for k in (0, 1, 2, total // 2, total, total + 3):
            assert ours(k) == pytest.approx(float(ref(k)), rel=1e-6)


def test_adam_update_matches_optax_given_equal_gradients():
    """torch Adam(weight_decay) with the LR set per step against optax's
    add_decayed_weights → scale_by_adam and an explicit ``p − lr·u``,
    three steps of the same gradients."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(scale=s, size=(5, 7)).astype(np.float32) for s in (1.0, 1e-3, 10.0)]
    tx = optax.chain(optax.add_decayed_weights(0.01), optax.scale_by_adam())
    jp, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = _t(p0)
    topt = torch.optim.Adam([tp], lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    lr = geomspace_lr(1e-4, 1e-5, 3)
    for k, g in enumerate(grads):
        u, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = jp - lr(k) * u
        tp.grad = _t(g)
        topt.param_groups[0]["lr"] = lr(k)
        topt.step()
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", [None, "heaviside"])
def test_dvae_training_forward_matches_jax(jax_capture, mode):
    """Training mode with fed spin uniforms and dropout off: logits,
    spins, reconstruction and the BatchNorm running statistics (Flax's
    momentum 0.9 with the biased variance)."""
    reps = 1 if mode else 2
    imgs = _images(8, 1)
    jd = jdvae.DVAE(n_latents=32, latent_to_discrete=mode)
    v = jd.init({"params": jax.random.PRNGKey(0), "spins": jax.random.PRNGKey(1),
                 "dropout": jax.random.PRNGKey(2)}, jnp.asarray(imgs[:1]), train=False)
    stats = jax.tree.map(lambda x: x + 0.5, v["batch_stats"])  # non-trivial running stats
    (jl, js, jr), mut = jd.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(imgs),
                                 n_replicas=reps, train=True, mutable=["batch_stats"],
                                 rngs={"spins": jax.random.PRNGKey(3),
                                       "dropout": jax.random.PRNGKey(4)})
    td = DVAE(32, mode)
    td.load_state_dict(dvae_state_dict_from_jax(v["params"], stats))
    td.train()
    u = None if mode else _t(jax_capture["u"])
    with torch.no_grad():
        tl, ts, tr = td(_t(imgs), reps, spin_uniforms=u, dropout_masks=_ones_masks(8 * reps))
    # batch statistics over 32 values per channel at the last encoder layer
    # amplify the convolutions' f32 summation-order differences ~10×
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert (np.sign(ts.numpy()) == np.sign(np.asarray(js))).mean() > 0.999
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-4)
    want = dvae_state_dict_from_jax(v["params"], mut["batch_stats"])
    got = td.state_dict()
    for k, ref in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_dvae_gumbel_mode_is_not_ported():
    """The gumbel mode against JAX ``gumbel_spins``: the uniform map is
    JAX's ``uniform(minval, maxval)`` bit for bit (an affine map of the
    unit draw, not a clamp), the relaxed spins and their gradient from the
    same uniforms within 1e-6 (the gradient 1e-5, or 5e-6 where tanh
    saturates); an unknown mode raises JAX's ValueError."""
    from image_generation_tpu_torch.models.dvae import gumbel_spins, gumbel_uniforms

    key, shape = jax.random.PRNGKey(3), (8, 2, 32)
    unit = np.asarray(jax.random.uniform(key, shape))
    ref_u = np.asarray(jax.random.uniform(key, shape, minval=1e-6, maxval=1.0 - 1e-6))
    np.testing.assert_array_equal(gumbel_uniforms(_t(unit)).numpy(), ref_u)
    logits = np.random.default_rng(4).normal(size=(8, 32)).astype(np.float32)
    w = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda x: (jdvae.gumbel_spins(x, 2, key, 0.7) * w).sum())(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    out = gumbel_spins(x, 2, None, tau=0.7, uniforms=_t(ref_u))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jdvae.gumbel_spins(jnp.asarray(logits), 2, key, 0.7)),
                               rtol=0, atol=1e-6)
    # near saturation 1 − tanh² cancels to f32's ulp of 1 (×2/τ·|w| ≈ 10)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=5e-6)
    with pytest.raises(ValueError) as theirs:
        jdvae.DVAE(n_latents=32, latent_to_discrete="softmax").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    with pytest.raises(ValueError) as ours:
        DVAE(32, "softmax")
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------

def _step_feed(state, plan, cfg, n_images):
    """The draws JAX's ``step_body`` makes from ``state.rng``, as a
    ``StepFeed`` (the straight-through uniforms are added after the JAX
    step has recorded them)."""
    _rng, _k_spins, _k_drop, k_neg1, k_neg2, k_fresh = jax.random.split(state.rng, 6)
    pt = cfg["SAMPLER"] == "pt"
    t_dim, c_dim, sweeps = cfg["PT_NUM_BETAS"], cfg["NUM_READS"], cfg["GIBBS_SWEEPS"]

    def phase(k):
        if pt:
            return _jax_round_draws(k, plan, t_dim, c_dim, sweeps)
        return _t(_jax_sweep_uniforms(k, plan, c_dim, sweeps)), None

    (s1, w1), (s2, w2) = phase(k_neg1), phase(k_neg2)
    fresh = None
    if not cfg["PERSISTENT_CHAINS"]:
        fresh = _t(np.asarray(jgibbs.random_spins(k_fresh, plan, (t_dim if pt else 1) * c_dim)))
    return StepFeed(sweeps1=s1, swaps1=w1, sweeps2=s2, swaps2=w2, fresh_chains=fresh,
                    dropout_masks=_ones_masks(n_images * cfg["N_REPLICAS"]))


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_one_training_step_matches_jax(graphs, jax_capture, sampler, persistent):
    """A scheduled step (epoch 0, step 0: both negative phases and the
    GRBM update) from the same state on both sides."""
    jg, jplan, tg, tplan = graphs
    cfg = dict(SMALL, SAMPLER=sampler, PERSISTENT_CHAINS=persistent)
    jfns = jstep.make_train_fns(JaxConfig(**cfg), jg, 100, jplan)
    imgs = _images(8, 2)
    state = jfns.init(jax.random.PRNGKey(5), jnp.asarray(imgs[:1]))
    feed = _step_feed(state, jplan, cfg, 8)
    tfns = make_train_fns(TrainingConfig(**cfg), tg, 100, tplan, device="cpu")
    ts = train_state_from_jax(tfns, state)
    new, m = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    feed.spin_uniforms = _t(jax_capture["u"])
    tm = tfns.step_body(ts, _t(imgs), 0, feed)

    mse64 = float(np.mean(np.square(jax_capture["residual"].astype(np.float64))))
    np.testing.assert_allclose(float(tm.mse), mse64, rtol=1e-5)
    np.testing.assert_allclose(float(tm.dvae_loss), mse64 + float(m.mmd), rtol=1e-5)
    for name in ("mse", "dvae_loss"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(m, name)),
                                   rtol=5e-5, err_msg=name)
    for name in ("mmd", "nll"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(m, name)),
                                   rtol=1e-5, err_msg=name)
    assert float(tm.grbm_trained) == 1.0 and ts.opt_step == 1
    jgrads = dvae_state_dict_from_jax(jax_capture["vg"][1],
                                      jax.tree.map(np.zeros_like, state.batch_stats))
    for k, p in ts.dvae.named_parameters():
        ref = jgrads[k].numpy()
        if k in _BIAS_BEFORE_BN:  # zero in exact arithmetic: f32 noise only
            assert np.abs(ref).max() < 1e-5 and float(p.grad.abs().max()) < 1e-5, k
            continue
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()) + 1e-7, (k, err)
    want = dvae_state_dict_from_jax(new.dvae_params, new.batch_stats)
    got = ts.dvae.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(ts.grbm_params.linear.numpy(), np.asarray(new.grbm_params.linear),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.grbm_params.quadratic.numpy(),
                               np.asarray(new.grbm_params.quadratic), rtol=0, atol=1e-6)
    same = (ts.chains.numpy() == np.asarray(new.chains)).all(axis=-1)
    assert same.mean() >= 0.98
    if sampler == "pt":
        np.testing.assert_allclose(ts.chain_energies.numpy()[same],
                                   np.asarray(new.chain_energies)[same], atol=1e-5)
        np.testing.assert_allclose(tm.pt_accept.numpy(), np.asarray(m.pt_accept), atol=1e-6)
    np.testing.assert_array_equal(ts.sampler_coupling.numpy() != 0,
                                  np.asarray(new.sampler_coupling) != 0)


def test_short_run_tracks_jax(graphs):
    """Three epochs of 8 steps from the same state: the port's per-epoch
    mean MSE falls as JAX's does and ends within 20 % of it.  The random
    streams differ, so the check is statistical; both sides are
    deterministic on the CPU."""
    jg, jplan, tg, tplan = graphs
    cfg = dict(SMALL, BATCH_SIZE=16)
    imgs = np.asarray(jdata.prepare_images(jdata.load_mnist(128)))
    jfns = jstep.make_train_fns(JaxConfig(**cfg), jg, 24, jplan)
    state = jfns.init(jax.random.PRNGKey(0), jnp.asarray(imgs[:1]))
    tfns = make_train_fns(TrainingConfig(**cfg), tg, 24, tplan, device="cpu")
    ts = train_state_from_jax(tfns, state, seed=1)
    g = torch.Generator().manual_seed(2)
    jax_mse, port_mse = [], []
    for epoch in range(3):
        jb = jdata.permuted_epoch(jnp.asarray(imgs), 16, jax.random.PRNGKey(10 + epoch))
        state, jm = jfns.epoch(state, jb, jnp.asarray(epoch))
        jax_mse.append(float(np.mean(jm.mse)))
        _, tm = tfns.epoch(ts, tdata.permuted_epoch(_t(imgs), 16, g), epoch)
        port_mse.append(float(tm["mse"].mean()))
        assert tm["mse"].shape == (8,) and bool(torch.isfinite(tm["dvae_loss"]).all())
    assert jax_mse[2] < jax_mse[0] and port_mse[2] < port_mse[0], (jax_mse, port_mse)
    assert abs(port_mse[2] - jax_mse[2]) <= 0.2 * jax_mse[2], (jax_mse, port_mse)


# ---------------------------------------------------------------------------
# trainer, checkpoint, data, gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny port trainer, PT with PT_ADAPT, trained two epochs and saved."""
    t = Trainer(config=TrainingConfig(**dict(SMALL, DATASET_SIZE=48, SAMPLER="pt",
                                             PT_ADAPT="epoch")), device="cpu")
    seen = []
    t.train(2, epoch_cb=lambda e, s: seen.append(s))
    path = tmp_path_factory.mktemp("models") / "tiny_pt"
    t.save(path)
    return t, seen, path


def test_trainer_trains_and_adapts_ladder(trained):
    t, seen, _ = trained
    assert len(t.losses["mse_losses"]) == 2 * (48 // 8)
    assert np.isfinite(t.losses["dvae_losses"]).all()
    assert all(d >= m - 1e-5 for m, d in zip(t.losses["mse_losses"], t.losses["dvae_losses"]))
    s = seen[-1]
    assert 0.0 <= s["pt_accept_min"] <= s["pt_accept_mean"] <= 1.0
    assert 2 <= s["pt_recommended_num_betas"] <= 64
    assert len(s["pt_betas"]) == 3 and s["pt_betas"][-1] == pytest.approx(1.0)
    assert torch.allclose(t.state.pt_betas.double(), torch.tensor(s["pt_betas"], dtype=torch.float64),
                          atol=1e-5)
    assert t.state.opt_step == 12 and t.current_lrs()[0] < 1e-4
    spins = t.sample_spins(4, 6)
    assert spins.shape == (4, 32) and set(spins.unique().tolist()) <= {-1.0, 1.0}


def test_checkpoint_written_by_port_loads_in_jax(trained):
    t, _, path = trained
    params, stats, jgp, jg, parameters, losses = jax_load_model_dir(path)
    ours = {k: v.detach().numpy() for k, v in t.dvae.state_dict().items()}
    for k, ref in dvae_state_dict_from_params(params, stats).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(ref, ours[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(jgp.linear), t.grbm_params.linear.numpy())
    np.testing.assert_array_equal(np.asarray(jgp.quadratic), t.grbm_params.quadratic.numpy())
    np.testing.assert_array_equal(jg.edge_i, t.graph.edge_i)
    assert parameters["dateset_size"] == 48 and parameters["n_latents"] == 32
    assert parameters["physical_nodes"] == [int(p) for p in t.physical_nodes]
    assert parameters["data_source"] == t.data_source.origin
    assert losses == t.losses
    back = Trainer(device="cpu")
    back.load(path)
    assert back.n_latents == 32 and back.qpu == "Advantage2_prototype"
    for k, v in back.dvae.state_dict().items():
        assert torch.equal(v, t.dvae.state_dict()[k].to(v.dtype)), k
    assert torch.equal(back.grbm_params.quadratic, t.grbm_params.quadratic)


def test_tune_mode_keeps_loaded_weights(trained):
    _, _, path = trained
    t = Trainer(config=TrainingConfig(**dict(SMALL, DATASET_SIZE=16)), device="cpu")
    t.load(path)
    before = {k: v.clone() for k, v in t.dvae.state_dict().items()}
    quad = t.grbm_params.quadratic.clone()
    t.train_init(1)
    assert all(torch.equal(before[k], v) for k, v in t.dvae.state_dict().items())
    assert torch.equal(t.grbm_params.quadratic, quad) and t.state.opt_step == 0
    t.train(1)
    assert not torch.equal(t.grbm_params.quadratic, quad)


def test_rebuild_cache_and_sampler(graphs):
    """After new GRBM parameters: ``rebuild_cache`` recomputes only the
    sampler model; ``rebuild_sampler`` also re-burns the chains, and under
    PT re-anchors the carried energies to the new model."""
    _, _, tg, tplan = graphs
    fns = make_train_fns(TrainingConfig(**dict(SMALL, SAMPLER="pt")), tg, 10, tplan,
                         device="cpu")
    st = fns.init(0)
    chains = st.chains.clone()
    with torch.no_grad():
        st.grbm_params.quadratic.mul_(50.0)
    fns.rebuild_cache(st)
    hp, a = fns.build_sampler_model(st.grbm_params)
    assert torch.equal(st.sampler_coupling, a) and torch.equal(st.sampler_h, hp)
    assert torch.equal(st.chains, chains)
    fns.rebuild_sampler(st)
    assert not torch.equal(st.chains, chains)
    np.testing.assert_allclose(st.chain_energies.numpy(),
                               tgibbs.ising_energies(hp, a, st.chains).numpy(), atol=1e-5)


def test_trainer_refusals():
    t = Trainer(config=TrainingConfig(**SMALL), device="cpu")
    with pytest.raises(TrainingError):
        t.step(torch.zeros((8, 32, 32, 1)), 0)
    with pytest.raises(TrainingError):
        t.save_native("unused")
    sharded = Trainer(config=TrainingConfig(**dict(SMALL, SAMPLER="pt", PT_NUM_BETAS="auto",
                                                   GRAPH_SHARDED="on")), device="cpu")
    with pytest.raises(ValueError, match="graph-sharded"):
        sharded.train_init(1)


def test_entry_points_default_to_the_card(monkeypatch, graphs, tmp_path):
    """With no card visible, the entry points refuse to run unless they are
    given device='cpu'; they never move to the CPU quietly."""
    from image_generation_tpu_torch.app.warm import WarmGenerator

    _, _, tg, tplan = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainingConfig(**SMALL)
    for make in (lambda: Trainer(config=cfg), lambda: WarmGenerator(tmp_path),
                 lambda: make_train_fns(cfg, tg, 10, tplan),
                 lambda: make_sample_fns(cfg, tg, tplan)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert Trainer(config=cfg, device="cpu").device.type == "cpu"
    assert make_train_fns(cfg, tg, 10, tplan, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_resolved_block_sparse_matches_jax(mode, chunk):
    """On 2,048- and 4,096-spin random sparse plans (dense enough that
    "auto" refuses at one size and engages at the other): both packages
    agree, and the port's dispatcher packs the coupling (``cuda_hbm+bs``)
    exactly where it is True."""
    for n, deg in ((2048, 8), (4096, 2)):
        rng = np.random.default_rng(n)
        ei = rng.integers(0, n, n * deg // 2)
        ej = rng.integers(0, n, n * deg // 2)
        keep = ei != ej
        pairs = np.unique(np.sort(np.stack([ei[keep], ej[keep]], 1), 1), axis=0)
        jg = jgrbm.GRBMGraph(n=n, edge_i=pairs[:, 0], edge_j=pairs[:, 1])
        tg = tgrbm.GRBMGraph(n=n, edge_i=pairs[:, 0], edge_j=pairs[:, 1])
        jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
        kw = dict(SWEEP_BLOCK_SPARSE=mode, SWEEP_BS_CHUNK=chunk, SAMPLER_MATMUL_DTYPE="float32")
        ours = TrainingConfig(**kw).resolved_block_sparse(tplan)
        assert ours == JaxConfig(**kw).resolved_block_sparse(jplan)
        assert tplan.n_pad >= 2048
        impl = make_sample_fns(TrainingConfig(**kw), tg, tplan, device="cpu").sampler_impl
        assert impl == ("cuda_hbm+bs" if ours else "cuda_hbm")


def test_block_sparse_helpers_match_jax():
    from image_generation_tpu_torch.ops import block_sparse as tbs

    rng = np.random.default_rng(1)
    pairs = np.unique(np.sort(rng.integers(0, 700, (900, 2)), 1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    jplan = jgibbs.build_plan(jgrbm.GRBMGraph(n=700, edge_i=pairs[:, 0], edge_j=pairs[:, 1]))
    tplan = tgibbs.build_plan(tgrbm.GRBMGraph(n=700, edge_i=pairs[:, 0], edge_j=pairs[:, 1]))
    for chunk in (128, 192, 256, 1024):
        assert tbs.chunk_starts(tplan.n_pad, chunk) == jbs.chunk_starts(jplan.n_pad, chunk)
        assert tbs.color_chunk_rows(tplan, chunk) == jbs.color_chunk_rows(jplan, chunk)
        assert tbs.chunk_occupancy(tplan, chunk) == jbs.chunk_occupancy(jplan, chunk)


def test_data_matches_jax():
    a, b = tdata._synthetic_digits(32), jdata._synthetic_digits(32)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    src = jdata.DataSource(*jdata._synthetic_digits(64), origin="synthetic")
    resized = tdata._resize_bilinear(_t(src.images), 32).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(src.images)[..., None], (64, 32, 32, 1),
                                      "bilinear"))[..., 0]
    np.testing.assert_allclose(resized, ref, rtol=0, atol=1e-6)
    ours = tdata.prepare_images(src).numpy()[..., 0]
    theirs = np.asarray(jdata.prepare_images(src))[..., 0]
    differ = ours != theirs
    assert ours.shape == (64, 32, 32) and set(np.unique(ours)) <= {0.0, 1.0}
    assert (np.abs(ref[differ] - 0.5) <= 1e-6).all()
    assert tdata.load_mnist(10).origin == jdata.load_mnist(10).origin
    np.testing.assert_allclose(tdata.load_mnist(20).images, jdata.load_mnist(20).images,
                               rtol=0, atol=1e-6)
    batches = tdata.permuted_epoch(_t(ours[..., None]), 16, torch.Generator().manual_seed(0))
    assert batches.shape == (4, 16, 32, 32, 1)
    assert sorted(batches.reshape(64, -1).sum(1).tolist()) == sorted(
        _t(ours).reshape(64, -1).sum(1).tolist())
