"""Port parity: the energy carry (K1-ΔE's plain version) and parallel tempering.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs the Pallas kernel in interpret mode with fed uniforms, as
its own tests do on the CPU.  Tolerances: the chain rule of
tests/test_torch_gibbs.py (≥ 98 % of chains bit-identical; the two order
their f32 sums differently, so a draw within an ulp of its probability
can flip); on identical chains ΔE and energies within 1e-5 absolute at
the checkpoint's model (|E| ~ 10: f32 sums in another order), and within
1e-5 + 1e-6·|x| at the |J| ≤ 1 model, whose |E| ~ 400 puts one f32 ulp at
3e-5; swap acceptance within 1e-6, plus 1e-5 relative at the |J| ≤ 1
model (that ulp times Δβ ≤ 0.3 moves e^{Δβ·ΔE} by up to 1e-5 of itself).
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
from image_generation_tpu.ops import pt_tune as jpt_tune
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops import pt_tune as tpt_tune
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse_reference

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98
_RTOL = {"checkpoint": 0.0, "strong": 1e-6}  # see the module docstring


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ckpt():
    """(JAX plan, port plan, {name: (hp, A) numpy}) on the checkpoint's
    graph: its scaled model and |J| ≤ 1."""
    jparams, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    jplan = jgibbs.build_plan(jg)
    tplan = tgibbs.build_plan(tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j))
    h, j = jgrbm.scaled_ising(jparams, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    rng = np.random.default_rng(0)
    models = {}
    for name, (hh, jj) in {
        "checkpoint": (h, j),
        "strong": (rng.uniform(-0.5, 0.5, jg.n).astype(np.float32),
                   rng.uniform(-1.0, 1.0, jg.n_edges).astype(np.float32)),
    }.items():
        hp, a = jgibbs.permuted_model(jplan, jnp.asarray(hh), jnp.asarray(jj))
        models[name] = (np.asarray(hp), np.asarray(a))
    return jplan, tplan, models


def _ladder(chains_per_rung, t_dim=8):
    """Per-chain β as PT passes it: the geometric ladder over [0.25, 1],
    each rung repeated over its chains."""
    return np.repeat(np.geomspace(0.25, 1.0, t_dim), chains_per_rung).astype(np.float32)


@pytest.mark.parametrize("model", ["checkpoint", "strong"])
@pytest.mark.parametrize("beta_kind", ["one", "ladder"])
def test_delta_e_plain_version_matches_pallas(ckpt, model, beta_kind):
    """``gibbs_sweeps_reference(track_delta_e=True)`` against the Pallas
    kernel's ``de_ref`` mode (interpret, fed uniforms), 64 chains × 8
    sweeps."""
    jplan, tplan, models = ckpt
    hp, a = models[model]
    rng = np.random.default_rng(11)
    s0 = rng.choice([-1.0, 1.0], (64, tplan.n_pad)).astype(np.float32)
    u = rng.random((8, 64, tplan.n_pad), dtype=np.float32)
    beta = np.float32(1.0) if beta_kind == "one" else _ladder(8)
    ref_s, ref_de = gibbs_sweeps_pallas(
        jax.random.PRNGKey(0), jnp.asarray(hp), jnp.asarray(a), jplan, jnp.asarray(s0), 8,
        beta=jnp.asarray(beta), interpret=True, uniforms=jnp.asarray(u), track_delta_e=True,
    )
    s, de = tgibbs.gibbs_sweeps_reference(_t(hp), _t(a), tplan, _t(s0), 8, _t(beta),
                                          uniforms=_t(u), track_delta_e=True)
    same = (s.numpy() == np.asarray(ref_s)).all(axis=1)
    assert same.mean() >= CHAIN_RULE
    rtol = _RTOL[model]
    np.testing.assert_allclose(de.numpy()[same], np.asarray(ref_de)[same], rtol=rtol, atol=1e-5)
    # ΔE is the energy change of the run
    e = tgibbs.ising_energies(_t(hp), _t(a), torch.stack([_t(s0), s]))
    np.testing.assert_allclose(de.numpy(), (e[1] - e[0]).numpy(), rtol=10 * rtol, atol=1e-4)


def test_cuda_wrapper_delta_e_on_cpu_is_plain_version(ckpt):
    _, tplan, models = ckpt
    hp, a = map(_t, models["strong"])
    rng = np.random.default_rng(4)
    s0 = _t(rng.choice([-1.0, 1.0], (16, tplan.n_pad)).astype(np.float32))
    u = _t(rng.random((3, 16, tplan.n_pad), dtype=np.float32))
    n0 = dict(gibbs_cuda.gibbs_sweeps_cuda.launches)
    s, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, tplan, s0, 3, uniforms=u, track_delta_e=True)
    # the plain version K1 runs on CPU tensors: the sparse field gather's
    rs, rde = gibbs_sweeps_sparse_reference(hp, a, tplan, s0, 3, uniforms=u, track_delta_e=True)
    assert torch.equal(s, rs) and torch.equal(de, rde)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == n0


@pytest.mark.parametrize("model", ["checkpoint", "strong"])
def test_ising_energies_match_jax(ckpt, model):
    _, tplan, models = ckpt
    hp, a = models[model]
    s = np.random.default_rng(2).choice([-1.0, 1.0], (3, 8, tplan.n_pad)).astype(np.float32)
    ref = np.asarray(jgibbs.ising_energies(jnp.asarray(hp), jnp.asarray(a), jnp.asarray(s)))
    ours = tgibbs.ising_energies(_t(hp), _t(a), _t(s)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=_RTOL[model], atol=1e-5)


def _jax_sweep_uniforms(key, plan, chains, n_sweeps):
    """The uniforms JAX's XLA ``gibbs_sweeps`` draws from ``key``: one key
    per sweep, folded with the color span's index."""
    u = np.zeros((n_sweeps, chains, plan.n_pad), np.float32)
    for i, k in enumerate(jax.random.split(key, n_sweeps)):
        for ci, (start, stop, _b0, _b1) in enumerate(jgibbs.class_spans(plan)):
            u[i, :, start:stop] = np.asarray(jax.random.uniform(
                jax.random.fold_in(k, ci), (chains, stop - start), dtype=jnp.float32))
    return u


def _jax_round_draws(key, plan, t_dim, c_dim, sweeps):
    """(sweep uniforms, (even, odd) swap uniforms) of one JAX ``pt_round``."""
    k_sweep, k_even, k_odd = jax.random.split(key, 3)
    swaps = tuple(_t(np.asarray(jax.random.uniform(k, (t_dim - 1, c_dim))))
                  for k in (k_even, k_odd))
    return _t(_jax_sweep_uniforms(k_sweep, plan, t_dim * c_dim, sweeps)), swaps


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("model", ["checkpoint", "strong"])
def test_pt_round_matches_jax(ckpt, model, carry):
    """One round at the 8-rung ladder, 8 chains per rung, 3 sweeps, with
    the sweep and swap uniforms JAX draws from its key fed to the port:
    spins, energies and the (T−1,) acceptance."""
    jplan, tplan, models = ckpt
    hp, a = models[model]
    t_dim, c_dim, sweeps = 8, 8, 3
    betas = np.geomspace(0.25, 1.0, t_dim).astype(np.float32)
    ladder = np.random.default_rng(5).choice([-1.0, 1.0], (t_dim, c_dim, tplan.n_pad))
    ladder = ladder.astype(np.float32)
    key = jax.random.PRNGKey(17)
    jh, ja, jl = jnp.asarray(hp), jnp.asarray(a), jnp.asarray(ladder)
    e0 = jgibbs.ising_energies(jh, ja, jl) if carry else None
    ref_s, ref_e, ref_acc = jgibbs.pt_round(key, jh, ja, jplan, jl, jnp.asarray(betas), sweeps,
                                            energies=e0, return_accept=True)
    u, swaps = _jax_round_draws(key, jplan, t_dim, c_dim, sweeps)
    s, e, acc = tgibbs.pt_round(
        None, _t(hp), _t(a), tplan, _t(ladder), _t(betas), sweeps,
        energies=_t(np.asarray(e0)) if carry else None, return_accept=True,
        uniforms=u, swap_uniforms=swaps,
    )
    same = (s.numpy() == np.asarray(ref_s)).all(axis=-1)
    assert same.mean() >= CHAIN_RULE
    np.testing.assert_allclose(e.numpy()[same], np.asarray(ref_e)[same], rtol=_RTOL[model],
                               atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=10 * _RTOL[model],
                               atol=1e-6)
    assert acc.shape == (t_dim - 1,) and (acc > 0).all()


def test_pt_sample_matches_jax(ckpt):
    """``pt_sample`` from a fed ladder, 3 rounds, the round draws replayed
    from JAX's keys (the port's rounds are driven one by one here)."""
    jplan, tplan, models = ckpt
    hp, a = models["checkpoint"]
    t_dim, c_dim, sweeps, rounds = 4, 8, 2, 3
    betas = np.geomspace(0.25, 1.0, t_dim).astype(np.float32)
    ladder = np.random.default_rng(6).choice([-1.0, 1.0], (t_dim, c_dim, tplan.n_pad))
    ladder = ladder.astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref_target, ref_ladder = jgibbs.pt_sample(
        key, jnp.asarray(hp), jnp.asarray(a), jplan, c_dim, jnp.asarray(betas), rounds, sweeps,
        init_spins=jnp.asarray(ladder))
    _k_init, k_run = jax.random.split(key)
    s, e = _t(ladder), tgibbs.ising_energies(_t(hp), _t(a), _t(ladder))
    for k in jax.random.split(k_run, rounds):
        u, swaps = _jax_round_draws(k, jplan, t_dim, c_dim, sweeps)
        s, e = tgibbs.pt_round(None, _t(hp), _t(a), tplan, s, _t(betas), sweeps, energies=e,
                               return_energies=True, uniforms=u, swap_uniforms=swaps)
    assert (s.numpy() == np.asarray(ref_ladder)).all(axis=-1).mean() >= CHAIN_RULE
    # the port's own pt_sample: shapes, ±1, and the target rung is the last
    target, full = tgibbs.pt_sample(torch.Generator().manual_seed(0), _t(hp), _t(a), tplan,
                                    c_dim, _t(betas), rounds, sweeps, init_spins=_t(ladder))
    assert target.shape == (c_dim, tplan.n_pad) and torch.equal(target, full[-1])
    assert set(full.unique().tolist()) <= {-1.0, 1.0}
    assert ref_target.shape == target.shape


def test_carried_energies_equal_recomputed_after_rounds(ckpt):
    """Five carried rounds: the carried energies equal ``ising_energies``
    recomputed on the final ladder within 1e-4 (tests/test_energy_carry.py's
    check)."""
    _, tplan, models = ckpt
    hp, a = map(_t, models["strong"])
    betas = _t(np.geomspace(0.25, 1.0, 8).astype(np.float32))
    g = torch.Generator().manual_seed(9)
    s = tgibbs.random_spins(g, tplan, 8 * 16).reshape(8, 16, -1)
    e = tgibbs.ising_energies(hp, a, s)
    for _ in range(5):
        s, e = tgibbs.pt_round(g, hp, a, tplan, s, betas, 2, energies=e, return_energies=True)
    np.testing.assert_allclose(e.numpy(), tgibbs.ising_energies(hp, a, s).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pt_tune_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    accept = rng.uniform(0.0, 1.0, 7)
    betas = np.geomspace(0.25, 1.0, 8)
    assert tpt_tune.recommend_num_betas(accept) == jpt_tune.recommend_num_betas(accept)
    np.testing.assert_array_equal(tpt_tune.respace_betas(betas, accept),
                                  jpt_tune.respace_betas(betas, accept))
