"""Port parity: the training leftovers, on the CPU.

``training/optim.py`` ``AdamMoments`` against the JAX package's
``scale_by_adam_moments`` (after ``optax.add_decayed_weights``, the LR
applied as ``p − lr·u``), five steps on gradients made with numpy from a
seed: bf16 moments, a factored second moment, both, and the gating by
shape and size in torch orientation (a ``Linear.weight`` is the flax
kernel transposed); then one training step in the gumbel latent mode and
one with a factored ν against JAX ``make_train_fns`` fed the same draws;
the optimizer build; and native resume of each optimizer state.

Tolerances.  The optimizer's arithmetic is JAX's, elementwise in f32:
updates within 1e-6 relative or two ulps of the parameter they move
(each step starts from JAX's parameters and moments; the parameters are
of the size of one update, so p − lr·u rounds an update to ~1e-7 of
itself), f32 states within 1e-6 relative; bf16
moments within one bf16 ulp (an f32 value one ulp apart may round to the
next bf16), the factors (means of g², summed in another order) 1e-6
relative.  The steps follow tests/test_torch_training.py: losses rtol
5e-5 (MSE) / 1e-5, the GRBM 1e-6, chains by the 98 % rule, the factored
layer's ν factors 1e-3 relative (its gradient is held to 1e-4 of its
largest entry, and the factors are means of its square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.models import dvae as jdvae
from image_generation_tpu.training import step as jstep
from image_generation_tpu.training.optim import FactoredNu as JaxFactoredNu
from image_generation_tpu.training.optim import scale_by_adam_moments
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.training import step as tstep
from image_generation_tpu_torch.training.optim import (
    AdamMoments,
    FactoredNu,
    optimizer_state_bytes,
)
from image_generation_tpu_torch.training.step import make_train_fns, train_state_from_jax
from image_generation_tpu_torch.training.trainer import Trainer
from test_torch_training import SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401

LR, WD = 1e-3, 1e-2
# JAX kernel layouts; the port's tensors are the 2-D ones transposed
SHAPES = {"dense": (48, 40), "small": (4, 3), "vec": (300,), "conv": (16, 8, 3, 3)}
MIN_SIZE = 1024  # "dense" (1,920 elements) factors, "small" does not
MODES = {"bf16": (jnp.bfloat16, None), "factored": (None, MIN_SIZE),
         "both": (jnp.bfloat16, MIN_SIZE)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_layout(x):
    return np.ascontiguousarray(x.T) if x.ndim == 2 else x


def _bf16_ulp_close(ours: torch.Tensor, ref: np.ndarray) -> None:
    """Equal, or one bf16 step apart (the f32 values round to neighbours)."""
    a = ours.view(torch.int16).numpy().astype(np.int32)
    b = torch.tensor(np.asarray(ref, np.float32)).to(torch.bfloat16).view(torch.int16)
    assert np.abs(a - b.numpy().astype(np.int32)).max() <= 1


def _check_and_sync(opt, tp, adam, bf16: bool) -> None:
    """The port's moments against JAX's, then set to them (each step then
    starts from the same state)."""
    for k in SHAPES:
        st = opt.state[tp[k]]
        mu_ref = _torch_layout(np.asarray(adam.mu[k].astype(jnp.float32)))
        nu_ref = adam.nu[k]
        if bf16:
            assert st["exp_avg"].dtype == torch.bfloat16
            _bf16_ulp_close(st["exp_avg"], mu_ref)
        else:
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu_ref, rtol=1e-6, atol=1e-12)
        st["exp_avg"].copy_(torch.tensor(mu_ref))
        if isinstance(nu_ref, JaxFactoredNu):
            assert k == "dense" and isinstance(opt.nu(tp[k]), FactoredNu)
            for name, ref in (("nu_row", nu_ref.row), ("nu_col", nu_ref.col)):
                np.testing.assert_allclose(st[name].numpy(), np.asarray(ref), rtol=1e-6)
                st[name].copy_(torch.tensor(np.asarray(ref)))
        else:
            ref = _torch_layout(np.asarray(nu_ref.astype(jnp.float32)))
            if bf16:
                _bf16_ulp_close(st["exp_avg_sq"], ref)
            else:
                np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref, rtol=1e-6)
            st["exp_avg_sq"].copy_(torch.tensor(ref))
        assert st["step"] == int(adam.count)


@pytest.mark.parametrize("mode", list(MODES))
def test_adam_moments_match_scale_by_adam_moments(mode):
    """Five steps, each from the same parameters and moments on both sides
    (JAX's after the step before): the update, μ and ν (or its factors)."""
    moment_dtype, min_size = MODES[mode]
    rng = np.random.default_rng(0)
    # parameters of 1e-3, the size of one update: p − lr·u then rounds each
    # update to ~1e-7 of itself, so the updates compare at 1e-6
    p0 = {k: (1e-3 * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
    tx = optax.chain(optax.add_decayed_weights(WD),
                     scale_by_adam_moments(moment_dtype=moment_dtype, factored_nu_min_size=min_size))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.tensor(_torch_layout(v)) for k, v in p0.items()}
    opt = AdamMoments(list(tp.values()), lr=LR, weight_decay=WD,
                      moment_dtype=None if moment_dtype is None else torch.bfloat16,
                      factored_nu_min_size=min_size)
    for step in range(5):
        grads = {k: (rng.normal(size=s) * 10.0 ** (step % 3 - 1)).astype(np.float32)
                 for k, s in SHAPES.items()}
        u, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = {k: jp[k] - LR * u[k] for k in jp}
        before = {k: v.clone() for k, v in tp.items()}
        for k, v in tp.items():
            v.grad = torch.tensor(_torch_layout(grads[k]))
        opt.step()
        for k in SHAPES:  # p − lr·u rounds to p's ulp: two of them at most
            ulp2 = 2 * float(np.spacing(np.abs(before[k].numpy())).max())
            np.testing.assert_allclose((before[k] - tp[k]).numpy(),
                                       _torch_layout(np.asarray(LR * u[k])), rtol=1e-6,
                                       atol=ulp2, err_msg=k)
            tp[k].copy_(torch.tensor(_torch_layout(np.asarray(jp[k]))))
        _check_and_sync(opt, tp, jstate[1], moment_dtype is not None)
    assert opt.state[tp["vec"]]["step"] == 5


def test_factored_gating_by_shape_and_size():
    """Only 2-D parameters at or above the size factor (JAX
    tests/test_optim.py, in torch orientation: ``row`` keeps the JAX
    length, the weight's axis 1); the state is small."""
    params = {"big": torch.ones(32, 64), "small": torch.ones(8, 16), "vec": torch.ones(4096),
              "conv": torch.ones(64, 8, 3, 3)}
    jstate = scale_by_adam_moments(factored_nu_min_size=1024).init(
        {k: jnp.ones(tuple(reversed(v.shape)) if v.ndim == 2 else v.shape)
         for k, v in params.items()})
    opt = AdamMoments(list(params.values()), factored_nu_min_size=1024)
    for v in params.values():
        v.grad = torch.ones_like(v)
    opt.step()
    for k, v in params.items():
        nu = opt.nu(v)
        if k == "big":
            assert isinstance(nu, FactoredNu) and isinstance(jstate.nu[k], JaxFactoredNu)
            assert nu.row.shape == jstate.nu[k].row.shape == (64,)
            assert nu.col.shape == jstate.nu[k].col.shape == (32,)
        else:
            assert isinstance(nu, torch.Tensor) and nu.shape == v.shape
    dense = sum(4 * 2 * v.numel() for v in params.values())
    assert optimizer_state_bytes(opt) == dense - 4 * 32 * 64 + 4 * (32 + 64)


def test_optimizer_build_follows_the_jax_rule(graphs):  # noqa: F811
    """Stock ``torch.optim.Adam`` unless a lever is set; the factoring
    threshold is the JAX package's."""
    _jg, _jplan, tg, tplan = graphs
    assert tstep._FACTORED_NU_MIN == jstep._FACTORED_NU_MIN
    for kw, cls in (({}, torch.optim.Adam), ({"ADAM_MOMENT_DTYPE": "bfloat16"}, AdamMoments),
                    ({"ADAM_FACTORED_NU": "on"}, AdamMoments)):
        fns = make_train_fns(TrainingConfig(**SMALL, **kw), tg, 10, tplan, device="cpu")
        d, grbm = fns.new_optimizers(fns.new_dvae(), tg.init_params(torch.Generator()))
        assert type(d) is cls and type(grbm) is torch.optim.Adam
        if cls is AdamMoments:
            assert d.moment_dtype == (torch.bfloat16 if "ADAM_MOMENT_DTYPE" in kw else None)
            assert d.factored_nu_min_size == (
                tstep._FACTORED_NU_MIN if "ADAM_FACTORED_NU" in kw else None)


def _jax_step(cfg, graphs, imgs, seed, capture_gumbel=None):  # noqa: F811
    jg, jplan, tg, tplan = graphs
    jfns = jstep.make_train_fns(JaxConfig(**cfg), jg, 100, jplan)
    state = jax.jit(jfns.init)(jax.random.PRNGKey(seed), jnp.asarray(imgs[:1]))
    feed = _step_feed(state, jplan, cfg, imgs.shape[0])
    new, m = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    return state, feed, new, m


def test_gumbel_training_step_matches_jax(graphs, jax_capture, monkeypatch):  # noqa: F811
    """A scheduled gumbel step (τ = 0.7): JAX's mapped uniforms fed through
    ``StepFeed.spin_uniforms``; losses, the GRBM update (which sees the
    relaxed spins as data spins) and the chains as the plain step's."""
    rec = {}
    orig = jdvae.gumbel_spins

    def recorded(logits, n_replicas, key, tau=1.0):
        u = jax.random.uniform(key, (logits.shape[0], n_replicas, logits.shape[1]),
                               dtype=logits.dtype, minval=1e-6, maxval=1.0 - 1e-6)
        jax.debug.callback(lambda x: rec.__setitem__("u", np.asarray(x)), u)
        return orig(logits, n_replicas, key, tau)

    monkeypatch.setattr(jdvae, "gumbel_spins", recorded)
    cfg = dict(SMALL, SAMPLER="gibbs", PERSISTENT_CHAINS=True, LATENT_TO_DISCRETE="gumbel",
               GUMBEL_TAU=0.7)
    imgs = _images(8, 5)
    state, feed, new, m = _jax_step(cfg, graphs, imgs, 6)
    tfns = make_train_fns(TrainingConfig(**cfg), graphs[2], 100, graphs[3], device="cpu")
    assert tfns.new_dvae().gumbel_tau == 0.7
    ts = train_state_from_jax(tfns, state)
    feed.spin_uniforms = _t(rec["u"])
    tm = tfns.step_body(ts, _t(imgs), 0, feed)
    for name, tol in (("mse", 5e-5), ("dvae_loss", 5e-5), ("mmd", 1e-5), ("nll", 1e-5)):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(m, name)), rtol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(ts.grbm_params.linear.numpy(), np.asarray(new.grbm_params.linear),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.grbm_params.quadratic.numpy(),
                               np.asarray(new.grbm_params.quadratic), rtol=0, atol=1e-6)
    assert (ts.chains.numpy() == np.asarray(new.chains)).all(axis=-1).mean() >= 0.98


def test_factored_nu_training_step_matches_jax(graphs, jax_capture, monkeypatch):  # noqa: F811
    """A scheduled step with ``ADAM_FACTORED_NU="on"`` and the threshold
    lowered on both sides so the decoder's Linear(32 → 128) factors: its
    ν factors, kept in JAX's orientation, and the losses as JAX's."""
    monkeypatch.setattr(jstep, "_FACTORED_NU_MIN", 4096)
    monkeypatch.setattr(tstep, "_FACTORED_NU_MIN", 4096)
    cfg = dict(SMALL, SAMPLER="gibbs", PERSISTENT_CHAINS=True, ADAM_FACTORED_NU="on")
    imgs = _images(8, 7)
    state, feed, new, m = _jax_step(cfg, graphs, imgs, 8)
    tfns = make_train_fns(TrainingConfig(**cfg), graphs[2], 100, graphs[3], device="cpu")
    ts = train_state_from_jax(tfns, state)
    feed.spin_uniforms = _t(jax_capture["u"])
    tm = tfns.step_body(ts, _t(imgs), 0, feed)
    np.testing.assert_allclose(float(tm.mse), float(m.mse), rtol=5e-5)
    np.testing.assert_allclose(float(tm.mmd), float(m.mmd), rtol=1e-5)
    w = ts.dvae._decoder.increase_latent_dim.weight
    nu = ts.dvae_opt.nu(w)
    ref = new.dvae_opt[1].nu["decoder"]["increase_latent_dim"]["kernel"]
    assert isinstance(nu, FactoredNu) and isinstance(ref, JaxFactoredNu)
    assert nu.row.shape == ref.row.shape == (32,) and nu.col.shape == ref.col.shape == (128,)
    np.testing.assert_allclose(nu.row.numpy(), np.asarray(ref.row), rtol=1e-3)
    np.testing.assert_allclose(nu.col.numpy(), np.asarray(ref.col), rtol=1e-3)
    factored = [k for k, p in ts.dvae.named_parameters()
                if isinstance(ts.dvae_opt.nu(p), FactoredNu)]
    assert factored == ["_decoder.increase_latent_dim.weight"]


@pytest.mark.parametrize("levers", [
    dict(ADAM_MOMENT_DTYPE="bfloat16"),
    dict(ADAM_FACTORED_NU="on"),
    dict(ADAM_MOMENT_DTYPE="bfloat16", ADAM_FACTORED_NU="on"),
], ids=["bf16", "factored", "both"])
def test_native_resume_keeps_each_optimizer_state(tmp_path, monkeypatch, levers):
    """Two epochs in one go against one, a native checkpoint and the second
    in a fresh Trainer: bf16 moments come back bf16, factored ν as its two
    vectors, and the runs end equal."""
    from test_torch_trainer_extras import TINY, _states_equal

    monkeypatch.setattr(tstep, "_FACTORED_NU_MIN", 4096)
    cfg = TrainingConfig(**{**TINY, **levers})
    full = Trainer(config=cfg, device="cpu", mesh=None)
    full.train(2)
    part = Trainer(config=cfg, device="cpu", mesh=None)
    part.train_init(2)
    part.train_epoch(0)
    part.save_native(tmp_path)
    resumed = Trainer(config=cfg, device="cpu", mesh=None)
    resumed.resume_native(tmp_path, n_epochs=2)
    opt = resumed.state.dvae_opt
    w = resumed.state.dvae._decoder.increase_latent_dim.weight
    if "ADAM_MOMENT_DTYPE" in levers:
        assert opt.state[w]["exp_avg"].dtype == torch.bfloat16
    assert isinstance(opt.nu(w), FactoredNu) == ("ADAM_FACTORED_NU" in levers)
    resumed.train(2)
    _states_equal(full.state, resumed.state)
    assert resumed.losses == full.losses
