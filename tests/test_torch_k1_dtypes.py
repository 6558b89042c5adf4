"""Port parity: K1 with a bf16 and an int8 coupling (K1-bf16, K1-int8), its
dispatch, and one parallel-tempering training step in each mode.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs the Pallas kernel as its own tests do on the CPU, in
interpret mode with fed uniforms: ``matmul_dtype=bfloat16`` for bf16, a
JAX ``quantize_coupling`` result for int8.  The port's side is
``gibbs_cuda.gibbs_sweeps_cuda`` on CPU tensors, which runs K1's plain
version, the sparse field gather's (``gibbs_sweeps_sparse_reference``:
int8 in the Pallas kernel's quantized units, h / scale and β · scale,
ΔE × scale).

Tolerances (tests/test_torch_gibbs.py's): at least 98 % of the chains
bit-identical over the run (the two sum the fields in another order and
compute the sigmoid with other code, so a draw within an ulp of its
probability can flip and its chain diverge); one color step's fields
within 1e-5; on identical chains ΔE within 1e-3·(1 + |E|).

Plans: the 32-latent Advantage2_prototype plan of the graph cache, and the
2,048-latent Advantage_system6 plan (n_pad 2,432, 7 color blocks), whose
served int8 model is the configuration that reaches K1-int8; both with a
random |J| ≤ 1 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.config import TrainingConfig as JaxConfig
from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import quant as jquant
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu.training import step as jstep
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops import gibbs_sparse as gs
from image_generation_tpu_torch.ops.quant import QuantCoupling, quantize_coupling
from image_generation_tpu_torch.training.step import (
    make_sample_fns,
    make_train_fns,
    train_state_from_jax,
)
from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph
from test_torch_training import SEED, SMALL, _images, _step_feed, _t, graphs, jax_capture  # noqa: F401

CHAIN_RULE = 0.98
_PLANS = {  # name: (qpu, latents, chains, sweeps) of the sweep checks
    "prototype32": ("Advantage2_prototype", 32, 16, 6),
    "latents2048": ("Advantage_system6", 2048, 8, 2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread for this module (the suite runs
    six worker processes at once, and a pool of threads spinning for work
    slows every small op), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plans():
    """{name: (JAX plan, port plan, hp, A)}: the same graph in both
    packages, a random |J| ≤ 1 model in padded coordinates (numpy)."""
    out = {}
    for name, (qpu, n, _c, _s) in _PLANS.items():
        tg, _ = cached_latent_graph(qpu, n, SEED)
        jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
        jplan, tplan = jgibbs.build_plan(jg), tgibbs.build_plan(tg)
        rng = np.random.default_rng(n)
        h = rng.uniform(-0.5, 0.5, tg.n).astype(np.float32)
        j = rng.uniform(-1.0, 1.0, tg.n_edges).astype(np.float32)
        hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
        out[name] = (jg, jplan, tg, tplan, np.asarray(hp), np.asarray(a))
    return out


def _couplings(a, dtype):
    """(JAX coupling argument, JAX matmul_dtype, port coupling)."""
    if dtype == "bf16":
        return jnp.asarray(a), jnp.bfloat16, _t(a).to(torch.bfloat16)
    return jquant.quantize_coupling(jnp.asarray(a)), None, quantize_coupling(_t(a))


@pytest.mark.parametrize("beta_kind", ["one", "per_chain"])
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("plan_name", list(_PLANS))
def test_k1_plain_version_matches_pallas(plans, plan_name, dtype, track, beta_kind):
    """K1-bf16 / K1-int8's plain version (through the wrapper's CPU
    branch) against ``gibbs_sweeps_pallas(interpret=True, uniforms=u)``."""
    _jg, jplan, _tg, tplan, hp, a = plans[plan_name]
    chains, sweeps = _PLANS[plan_name][2:]
    rng = np.random.default_rng(chains + sweeps)
    s0 = rng.choice([-1.0, 1.0], (chains, tplan.n_pad)).astype(np.float32)
    u = rng.random((sweeps, chains, tplan.n_pad), dtype=np.float32)
    beta = (np.float32(1.0) if beta_kind == "one"
            else rng.uniform(0.5, 2.0, chains).astype(np.float32))
    jc, mm, tc = _couplings(a, dtype)
    ref = gibbs_sweeps_pallas(jax.random.PRNGKey(0), jnp.asarray(hp), jc, jplan, jnp.asarray(s0),
                              sweeps, beta=jnp.asarray(beta), interpret=True,
                              uniforms=jnp.asarray(u), matmul_dtype=mm, track_delta_e=track)
    n0 = dict(gibbs_cuda.gibbs_sweeps_cuda.launches)
    ours = gibbs_cuda.gibbs_sweeps_cuda(_t(hp), tc, tplan, _t(s0), sweeps,
                                        _t(beta) if beta_kind != "one" else 1.0, uniforms=_t(u),
                                        track_delta_e=track)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == n0  # the CPU branch launches nothing
    if track:
        (ours, de), (ref, ref_de) = ours, ref
    same = (ours.numpy() == np.asarray(ref)).all(axis=1)
    assert same.mean() >= CHAIN_RULE, f"only {same.mean():.3f} of chains identical"
    assert (ours.numpy() != s0).any(axis=1).all()  # the run moves every chain
    if track:
        e = tgibbs.ising_energies(_t(hp), tc, ours).abs().numpy()
        err = np.abs(de.numpy() - np.asarray(ref_de))[same]
        assert (err <= 1e-3 * (1 + e[same])).all(), float(err.max())
        # ΔE is the energy change of the run under the model this mode samples
        e_run = tgibbs.ising_energies(_t(hp), tc, torch.stack([_t(s0), ours])).numpy()
        gap = np.abs(de.numpy() - (e_run[1] - e_run[0]))
        assert (gap <= 1e-4 * (1 + np.abs(e_run).max(0))).all(), float(gap.max())


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("plan_name", list(_PLANS))
def test_k1_color_step_fields_match_pallas_body(plans, plan_name, dtype):
    """One color step's fields in the kernel's units, every color block:
    the plain version's products against ``_color_update``'s
    (bf16: f32 accumulation of the cast spins; int8: int32, then + h/scale)."""
    _jg, _jplan, _tg, tplan, hp, a = plans[plan_name]
    s0 = np.random.default_rng(3).choice([-1.0, 1.0], (16, tplan.n_pad)).astype(np.float32)
    jc, _mm, tc = _couplings(a, dtype)
    if dtype == "int8":
        jmat, jh = jc.q, jnp.asarray(hp) / jc.scale
        th = _t(hp) / tc.scale
    else:
        jmat, jh, th = jc.astype(jnp.bfloat16), jnp.asarray(hp), _t(hp)
    products = tgibbs.block_products(tc, tplan, scaled=False)
    for b, (c0, _v, c1) in enumerate(tplan.blocks):
        lhs = jnp.asarray(s0).astype(jmat.dtype)
        f = jnp.dot(lhs, jmat[:, c0:c1],
                    preferred_element_type=jnp.int32 if dtype == "int8" else jnp.float32)
        ref = np.asarray(f.astype(jnp.float32) + jh[c0:c1])
        ours = (products(_t(s0), b) + th[c0:c1]).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_k1_int8_plain_version_works_in_quantized_units(plans):
    """The two plain versions of an int8 sweep differ only in rounding:
    K1's (quantized units) and ``USE_PALLAS="off"``'s (products × scale
    + h) give the same chains under the chain rule, and K1's energy change
    is the change of the dequantized model's energy."""
    _jg, _jplan, _tg, tplan, hp, a = plans["prototype32"]
    qc = quantize_coupling(_t(a))
    rng = np.random.default_rng(5)
    s0 = _t(rng.choice([-1.0, 1.0], (32, tplan.n_pad)).astype(np.float32))
    u = _t(rng.random((4, 32, tplan.n_pad), dtype=np.float32))
    k1, de = tgibbs.gibbs_sweeps_kernel_reference(_t(hp), qc, tplan, s0, 4, 1.5, uniforms=u,
                                                  track_delta_e=True)
    xla = tgibbs.gibbs_sweeps_reference(_t(hp), qc, tplan, s0, 4, 1.5, uniforms=u)
    assert (k1 == xla).all(dim=1).float().mean() >= CHAIN_RULE
    dense = qc.q.to(torch.float32) * qc.scale
    e = tgibbs.ising_energies(_t(hp), dense, torch.stack([s0, k1]))
    np.testing.assert_allclose(de.numpy(), (e[1] - e[0]).numpy(), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="uniforms"):
        tgibbs.gibbs_sweeps_kernel_reference(_t(hp), qc, tplan, s0, 3, uniforms=u)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_FLAGSHIP = ("Advantage2_system1", 256)
_SERVE2K = ("Advantage_system6", 2048)
_DISPATCH = {  # name: (graph, overrides, serving?, the JAX sampler_impl)
    "2048_trained": (_SERVE2K, {}, False, "pallas_hbm"),
    "2048_served": (_SERVE2K, {}, True, "pallas_vmem+int8"),
    "flagship_bf16": (_FLAGSHIP, dict(SAMPLER_MATMUL_DTYPE="bfloat16"), False, "pallas_vmem"),
    "flagship_bf16_pt": (_FLAGSHIP, dict(SAMPLER_MATMUL_DTYPE="bfloat16", SAMPLER="pt"), False,
                         "pallas_vmem"),
    "flagship_int8": (_FLAGSHIP, dict(SAMPLER_MATMUL_DTYPE="int8"), False, "pallas_vmem+int8"),
    "flagship_int8_pt": (_FLAGSHIP, dict(SAMPLER_MATMUL_DTYPE="int8", SAMPLER="pt"), False,
                         "pallas_vmem+int8"),
}


@pytest.fixture(scope="module")
def dispatch_graphs():
    out = {}
    for qpu, n in (_FLAGSHIP, _SERVE2K):
        tg, _ = cached_latent_graph(qpu, n, SEED)
        jg = jgrbm.GRBMGraph(n=tg.n, edge_i=tg.edge_i, edge_j=tg.edge_j)
        out[(qpu, n)] = (jg, jgibbs.build_plan(jg), tg, tgibbs.build_plan(tg))
    return out


@pytest.mark.parametrize("case", list(_DISPATCH))
def test_dispatch_reaches_k1_modes_as_jax(dispatch_graphs, case):
    """``sampler_impl`` of the configurations that reach K1-bf16 / K1-int8
    (and the 2,048-latent model trained, which streams through K2-bf16)
    against the JAX ``make_train_fns(USE_PALLAS="on")``, ``pallas``
    spelled ``cuda``; none of them raises, and the cached coupling is
    stored as the JAX package stores it."""
    (qpu, n), kw, serving, want = _DISPATCH[case]
    jg, jplan, tg, tplan = dispatch_graphs[(qpu, n)]
    jcfg = JaxConfig(QPU=qpu, N_LATENTS=n, USE_PALLAS="on", **kw)
    tcfg = TrainingConfig(QPU=qpu, N_LATENTS=n, **kw)
    if serving:
        jcfg, tcfg = jcfg.for_serving(n), tcfg.for_serving(n)
        assert tcfg.SAMPLER_MATMUL_DTYPE == jcfg.SAMPLER_MATMUL_DTYPE == "int8"
    assert jstep.make_train_fns(jcfg, jg, 10, jplan).sampler_impl == want
    fns = make_sample_fns(tcfg, tg, tplan, device="cpu")
    assert fns.sampler_impl == want.replace("pallas", "cuda")
    params = tg.init_params(torch.Generator().manual_seed(0))
    _hp, coupling = fns.build_sampler_model(params)
    if "int8" in want:
        assert isinstance(coupling, QuantCoupling) and coupling.q.dtype == torch.int8
    else:
        assert coupling.dtype == torch.bfloat16


def test_k1_kernel_gate_and_rows_by_dtype(plans):
    """K1 is the gather kernel in every mode: its gate takes the
    2,048-latent plan in f32, bf16 and int8 (the spins are held as int8
    whatever the coupling's type, so the shared memory a block takes does
    not depend on it), the serving chain counts select every chains-per-
    block G the source instantiates, and a bf16 table word refuses a plan
    wider than 65,536; the dispatch between K1 and the streaming route
    stays the JAX gate."""
    tplan = plans["latents2048"][3]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        assert gibbs_cuda.supported_by_kernel(tplan, 4096, dtype)
    assert gs._dynamic_smem(16, tplan.n_pad) == 16 * 2432
    shapes = {gs.launch_shape(tplan, 256 * k)[0] for k in (1, 2, 4, 8, 16)}
    assert shapes == set(gs._CHAINS)
    wide = tgibbs.GibbsPlan(n=65664, n_pad=65664, blocks=((0, 65664, 65664),),
                            orig_to_perm=np.arange(65664), perm_edge_i=np.zeros(0, np.int64),
                            perm_edge_j=np.zeros(0, np.int64), valid_mask=np.ones(65664, bool))
    assert not gibbs_cuda.supported_by_kernel(wide, 1, torch.bfloat16)
    assert gibbs_cuda.supported_by_kernel(wide, 1, torch.float32)
    assert [gibbs_cuda.selects_k1(tplan, 256, it) for it in (4, 2, 1)] == [False, False, True]


# ---------------------------------------------------------------------------
# one parallel-tempering step per mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_pt_step_through_k1_mode_matches_jax(graphs, jax_capture, dtype):  # noqa: F811
    """One scheduled PT step of a small config with a bf16 / int8 coupling,
    from the same state (``train_state_from_jax``) with the draws of the
    JAX step at ``USE_PALLAS="off"``: the port runs its dispatch,
    ``cuda_vmem[+int8]`` (on the CPU, K1's plain version).  Tolerances as
    tests/test_torch_scaled.py's step test: losses rtol 5e-5 (mse,
    dvae_loss) and 1e-5 (mmd, nll), GRBM parameters 1e-6, chains by the
    chain rule (int8 fields are formed in quantized units here and as
    products × scale by the XLA sweep), acceptance 1e-5; an unscheduled
    step then carries the ladder energies through K1's ΔE mode."""
    jg, jplan, tg, tplan = graphs
    cfg = dict(SMALL, SAMPLER="pt", GIBBS_SWEEPS=4, SAMPLER_MATMUL_DTYPE=dtype,
               PERSISTENT_CHAINS=True)
    jfns = jstep.make_train_fns(JaxConfig(**cfg, USE_PALLAS="off"), jg, 100, jplan)
    imgs = _images(8, 4)
    # jitted: the eager init compiles op by op (~20 s on a cold process)
    state = jax.jit(jfns.init)(jax.random.PRNGKey(7), jnp.asarray(imgs[:1]))
    feed = _step_feed(state, jplan, cfg, 8)
    tfns = make_train_fns(TrainingConfig(**cfg), tg, 100, tplan, device="cpu")
    assert tfns.sampler_impl == "cuda_vmem" + ("+int8" if dtype == "int8" else "")
    ts = train_state_from_jax(tfns, state)
    jcache = state.sampler_coupling
    if dtype == "int8":
        np.testing.assert_array_equal(ts.sampler_coupling.q.numpy(), np.asarray(jcache.q))
        # XLA may fold the jitted init's max|A| / 127 into a multiply: an ulp apart
        np.testing.assert_allclose(float(ts.sampler_coupling.scale), float(jcache.scale),
                                   rtol=2e-7)
    else:
        np.testing.assert_array_equal(ts.sampler_coupling.to(torch.float32).numpy(),
                                      np.asarray(jcache.astype(jnp.float32)))
    new, m = jfns.step(state, jnp.asarray(imgs), jnp.asarray(0))
    feed.spin_uniforms = _t(jax_capture["u"])
    tm = tfns.step_body(ts, _t(imgs), 0, feed)
    for name, rtol in (("mse", 5e-5), ("dvae_loss", 5e-5), ("mmd", 1e-5), ("nll", 1e-5)):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(m, name)),
                                   rtol=rtol, err_msg=name)
    np.testing.assert_allclose(ts.grbm_params.quadratic.numpy(),
                               np.asarray(new.grbm_params.quadratic), rtol=0, atol=1e-6)
    same = (ts.chains.numpy() == np.asarray(new.chains)).all(axis=-1)
    assert same.mean() >= CHAIN_RULE
    np.testing.assert_allclose(tm.pt_accept.numpy(), np.asarray(m.pt_accept), atol=1e-5)
    tfns.step_body(ts, _t(imgs), 6)
    e_rec = tgibbs.ising_energies(ts.sampler_h, ts.sampler_coupling, ts.chains)
    np.testing.assert_allclose(ts.chain_energies.numpy(), e_rec.numpy(), rtol=0,
                               atol=1e-5 * (1 + float(e_rec.abs().max())))
