"""Port parity: the sampler's tensor half and the sweep kernel's plain twin.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs the Pallas kernel as its own tests do on the CPU: in
interpret mode with fed uniforms.

Chain tolerance: the two frameworks sum the fields in another order and
compute the sigmoid with different code, so a conditional probability can
differ by an ulp; a draw whose uniform falls inside that ulp flips
(probability ~1e-7 per draw) and its chain then diverges.  So at least 98%
of the chains must come out bit-identical over the run, and one color
step's fields must agree to 1e-5 absolute.
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
from image_generation_tpu.ops import exact as jexact
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu.utils.subgraph import select_latent_graph
from image_generation_tpu.utils.topology import chimera_graph
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import exact as texact
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops import gibbs_sparse

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ckpt():
    """(JAX plan, port plan, {name: (h, J) numpy}) on the checkpoint graph:
    its own scaled model, and the same plan with |J| up to 1."""
    jparams, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    h, j = jgrbm.scaled_ising(jparams, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    rng = np.random.default_rng(0)
    models = {
        "checkpoint": (np.asarray(h), np.asarray(j)),
        "strong": (rng.uniform(-0.5, 0.5, jg.n).astype(np.float32),
                   rng.uniform(-1.0, 1.0, jg.n_edges).astype(np.float32)),
    }
    return jgibbs.build_plan(jg), tgibbs.build_plan(tg), models


@pytest.fixture(scope="module")
def tiny():
    g, _ = select_latent_graph(chimera_graph(2, 2, 3), 12, 11)
    jg = jgrbm.GRBMGraph.from_networkx(g)
    rng = np.random.RandomState(0)
    h = rng.uniform(-0.3, 0.3, jg.n).astype(np.float32)
    j = rng.uniform(-0.5, 0.5, jg.n_edges).astype(np.float32)
    return jg, tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j), h, j


def test_scaled_ising_and_energy_match_jax(ckpt):
    jparams, jg = jax_grbm_from_sd(jax_load_sd(MODEL / "grbm.pth"))
    tparams = tgrbm.GRBMParams(_t(jparams.linear), _t(jparams.quadratic))
    tg = tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j)
    for pref in (0.05, 400.0):  # 400 drives couplings into the clip range
        jh, jj = jgrbm.scaled_ising(jparams, pref, (-4.0, 4.0), (-1.0, 1.0))
        th, tj = tgrbm.scaled_ising(tparams, pref, (-4.0, 4.0), (-1.0, 1.0))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))
    s = np.random.default_rng(1).choice([-1.0, 1.0], (8, jg.n)).astype(np.float32)
    np.testing.assert_allclose(
        tgrbm.energy(tparams, tg, _t(s)).numpy(),
        np.asarray(jgrbm.energy(jparams, jg, jnp.asarray(s))), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("model", ["checkpoint", "strong"])
def test_permuted_model_matches_jax(ckpt, model):
    jplan, tplan, models = ckpt
    h, j = models[model]
    jhp, ja = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    thp, ta = tgibbs.permuted_model(tplan, _t(h), _t(j))
    np.testing.assert_array_equal(thp.numpy(), np.asarray(jhp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_to_original_and_random_spins(ckpt):
    jplan, tplan, _ = ckpt
    g = torch.Generator().manual_seed(0)
    s = tgibbs.random_spins(g, tplan, 5)
    assert s.shape == (5, tplan.n_pad) and set(s.unique().tolist()) <= {-1.0, 1.0}
    np.testing.assert_array_equal(
        tgibbs.to_original(tplan, s).numpy(),
        np.asarray(jgibbs.to_original(jplan, jnp.asarray(s.numpy()))),
    )


def _inputs(plan, chains, sweeps, seed, beta_kind):
    rng = np.random.default_rng(seed)
    s0 = rng.choice([-1.0, 1.0], (chains, plan.n_pad)).astype(np.float32)
    u = rng.random((sweeps, chains, plan.n_pad), dtype=np.float32)
    beta = 1.0 if beta_kind == "one" else rng.uniform(0.5, 2.0, chains).astype(np.float32)
    return s0, u, beta


@pytest.mark.parametrize("model", ["checkpoint", "strong"])
@pytest.mark.parametrize("beta_kind", ["one", "per_chain"])
def test_reference_matches_pallas_interpret(ckpt, model, beta_kind):
    """64 chains × 16 sweeps, fed uniforms: the plain twin against the
    Pallas kernel in interpret mode (chain rule in the module docstring)."""
    jplan, tplan, models = ckpt
    h, j = models[model]
    s0, u, beta = _inputs(tplan, 64, 16, 7, beta_kind)
    jhp, ja = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    ref = np.asarray(gibbs_sweeps_pallas(
        jax.random.PRNGKey(0), jhp, ja, jplan, jnp.asarray(s0), 16,
        beta=jnp.asarray(beta), interpret=True, uniforms=jnp.asarray(u),
    ))
    thp, ta = tgibbs.permuted_model(tplan, _t(h), _t(j))
    ours = tgibbs.gibbs_sweeps_reference(
        thp, ta, tplan, _t(s0), 16, _t(beta) if beta_kind != "one" else 1.0,
        uniforms=_t(u),
    ).numpy()
    same = (ours == ref).all(axis=1).mean()
    assert same >= CHAIN_RULE, f"only {same:.3f} of chains identical"
    # the run does move the chains
    assert (ours != s0).any(axis=1).mean() > 0.9


@pytest.mark.parametrize("model", ["checkpoint", "strong"])
def test_color_step_fields_match_jax(ckpt, model):
    jplan, tplan, models = ckpt
    h, j = models[model]
    s0, _, _ = _inputs(tplan, 64, 1, 3, "one")
    jhp, ja = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    thp, ta = tgibbs.permuted_model(tplan, _t(h), _t(j))
    for c0, _v, c1 in tplan.blocks:
        ref = np.asarray(jnp.dot(jnp.asarray(s0), ja[:, c0:c1],
                                 preferred_element_type=jnp.float32) + jhp[c0:c1])
        ours = (_t(s0) @ ta[:, c0:c1] + thp[c0:c1]).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_reference_leaves_input_and_draws_from_generator(ckpt):
    _, tplan, models = ckpt
    thp, ta = tgibbs.permuted_model(tplan, *map(_t, models["strong"]))
    s0 = tgibbs.random_spins(torch.Generator().manual_seed(1), tplan, 16)
    keep = s0.clone()
    a = tgibbs.gibbs_sweeps_reference(thp, ta, tplan, s0, 3,
                                      generator=torch.Generator().manual_seed(5))
    b = tgibbs.gibbs_sweeps_reference(thp, ta, tplan, s0, 3,
                                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(s0, keep) and torch.equal(a, b) and not torch.equal(a, s0)


def test_reference_matches_exact_moments(tiny):
    """Generator-drawn uniforms: the twin's samples hold the exact Boltzmann
    moments (mirrors tests/test_gibbs_pallas.py's moment test)."""
    jg, tg, h, j = tiny
    plan = tgibbs.build_plan(tg)
    hp, a = tgibbs.permuted_model(plan, _t(h), _t(j))
    g = torch.Generator().manual_seed(0)
    out = tgibbs.gibbs_sweeps_reference(hp, a, plan, tgibbs.random_spins(g, plan, 512), 60,
                                        generator=g)
    s = tgibbs.to_original(plan, out).double().numpy()
    e1, e2 = jexact.exact_moments(h, jg.edge_i, jg.edge_j, j)
    np.testing.assert_allclose(s.mean(axis=0), e1, atol=0.15)
    np.testing.assert_allclose((s[:, tg.edge_i] * s[:, tg.edge_j]).mean(axis=0), e2, atol=0.15)


@pytest.mark.parametrize("beta", [1.0, 0.5, 2.0])
def test_exact_matches_jax(tiny, beta):
    jg, _, h, j = tiny
    for ours, ref in zip(texact.exact_moments(h, jg.edge_i, jg.edge_j, j, beta),
                         jexact.exact_moments(h, jg.edge_i, jg.edge_j, j, beta)):
        np.testing.assert_array_equal(ours, ref)
    assert texact.exact_log_z(h, jg.edge_i, jg.edge_j, j, beta) == jexact.exact_log_z(
        h, jg.edge_i, jg.edge_j, j, beta)


def test_cuda_wrapper_on_cpu_runs_plain_version(ckpt):
    """A CPU tensor takes the plain version inside the kernel wrapper (the
    sparse field gather's, which K1 runs on the card); the launch counter
    does not move."""
    _, tplan, models = ckpt
    thp, ta = tgibbs.permuted_model(tplan, *map(_t, models["strong"]))
    s0, u, _ = _inputs(tplan, 8, 2, 4, "one")
    n0 = dict(gibbs_cuda.gibbs_sweeps_cuda.launches)
    out = gibbs_cuda.gibbs_sweeps_cuda(thp, ta, tplan, _t(s0), 2, uniforms=_t(u))
    ref = gibbs_sparse.gibbs_sweeps_sparse_reference(thp, ta, tplan, _t(s0), 2, uniforms=_t(u))
    assert torch.equal(out, ref)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == n0
    # the energy carry too: (spins, ΔE) from the plain version
    out_de, de = gibbs_cuda.gibbs_sweeps_cuda(thp, ta, tplan, _t(s0), 2, uniforms=_t(u),
                                              track_delta_e=True)
    assert torch.equal(out_de, ref) and de.shape == (8,)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == n0


def test_kernel_gate_and_rows(ckpt):
    """K1's gate and launch shape on the checkpoint's plan: the gather's
    rule in every value type; serving (256·k chains, k = 1..16) selects
    every chains-per-block G the source instantiates, each shape fitting
    shared memory and the threads a multiple of 32 and of G; a plan too
    wide for 16 chains' int8 spins takes a smaller G."""
    _, tplan, _ = ckpt
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        assert gibbs_cuda.supported_by_kernel(tplan, 256, dtype)
        assert gibbs_cuda.supported_by_kernel(tplan, 4096, dtype)
        assert not gibbs_cuda.supported_by_kernel(tplan, 0, dtype)
    assert gibbs_sparse.launch_shape(tplan, 4096)[0] == 16
    assert gibbs_sparse.launch_shape(tplan, 256)[0] == 1
    shapes = {gibbs_sparse.launch_shape(tplan, 256 * k) for k in range(1, 17)}
    assert {g for g, _t in shapes} == set(gibbs_sparse._CHAINS)
    for g, threads in shapes:
        assert gibbs_sparse._fits(g, tplan.n_pad)
        assert threads % 32 == 0 and threads % g == 0 and 32 <= threads <= 1024
    # the P32 fabric's width: 16 chains' spins no longer fit shared memory
    wide = tgibbs.GibbsPlan(
        n=23936, n_pad=23936,
        blocks=tuple((128 * i, 128 * (i + 1), 128 * (i + 1)) for i in range(187)),
        orig_to_perm=np.arange(23936), perm_edge_i=np.zeros(0), perm_edge_j=np.zeros(0),
        valid_mask=np.ones(23936, bool),
    )
    assert not gibbs_sparse._fits(16, wide.n_pad)
    assert gibbs_sparse.launch_shape(wide, 4096)[0] == 8


def test_philox_known_answers():
    """The numpy twin of the kernel's generator against Philox4x32-10's
    published known-answer vectors (first output word)."""
    f = 0xFFFFFFFF
    assert int(gibbs_cuda._philox4x32_10(0, 0, 0, 0, 0, 0)) == 0x6627E8D5
    assert int(gibbs_cuda._philox4x32_10(f, f, f, f, f, f)) == 0x408F276D
    assert int(gibbs_cuda._philox4x32_10(
        0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0)) == 0xD16CFE09
    u = gibbs_cuda.philox_uniforms(123, 2, 3, 8)
    assert u.shape == (2, 3, 8) and u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all() and len(np.unique(u)) == u.size
    np.testing.assert_array_equal(u * 2**24, np.floor(u * 2**24))  # 24-bit grid
