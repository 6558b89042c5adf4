"""The gather kernel, which takes K1, K2 and K3 in every value type (f32,
bf16, int8), and K4 on the card: the CUDA kernels against their plain
versions.

These tests need a CUDA device and ``nvcc``; without a card they skip.
This file imports no JAX, so on the GPU machine (which has none) it runs
without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: a kernel and a plain version that sum the fields in another
order (the gather against the dense plain versions) differ by about an
ulp; a draw whose uniform falls within that ulp of its probability flips
(probability ~1e-7 per draw) and its chain then diverges.  So the rule
there is that at least 98% of the chains come out bit-identical.  On
identical chains ΔE agrees within 1e-4 (checkpoint model) or
1e-3·(1 + |E|) (|J| ≤ 1); on integer-valued couplings every sum is exact,
so the packed K3 equals the dense K2 bit for bit.  The gather kernel sums
exact integer fields (int8), or f32 fields in its plain version's slot
order (f32, bf16), so against its plain version every chain is expected
identical: the f32 and bf16 modes of K1 and the f32 modes of K2 / K3 are
held to that (no chain differing), the int8 modes to the same 98 %
(99.9 % against the dense plain versions) and the streaming bf16 modes
to 99.9 %.  K4's ΔE is summed in one fixed order, so repeated launches on
the same inputs give the same ΔE bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from image_generation_tpu_torch.io.checkpoint import load_model_dir
from image_generation_tpu_torch.models.grbm import GRBMGraph, scaled_ising
from image_generation_tpu_torch.ops import gibbs_cuda
from image_generation_tpu_torch.ops.exact import exact_moments
from image_generation_tpu_torch.ops.gibbs import (
    build_plan,
    gibbs_sweeps_kernel_reference,
    gibbs_sweeps_reference,
    permuted_model,
    random_spins,
    to_original,
)
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse_reference

pytestmark = pytest.mark.gpu

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ckpt(dev):
    _, params, graph, _, _ = load_model_dir(MODEL, dev)
    plan = build_plan(graph)
    h, j = scaled_ising(params, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    rng = np.random.default_rng(0)
    hs = torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev)
    js = torch.tensor(rng.uniform(-1, 1, graph.n_edges), dtype=torch.float32, device=dev)
    return plan, permuted_model(plan, h, j), permuted_model(plan, hs, js)


def _identical(a, b):
    return float((a == b).all(dim=1).float().mean())


def _differing(a, b):
    return int((~(a == b).all(dim=1)).sum())


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("chains", [256, 512, 1024, 2048, 4096, 2050, 37])
def test_fed_kernel_matches_plain(dev, ckpt, strong, chains):
    """K1-f32 at the default G of every serving group size (256·k chains:
    G = 1, 2, 4, 8, 16 on 132 SMs), at a chain count whose last thread
    block is partial (2050) and at one below a full grid (37): no chain
    differing from the gather's plain version, the chain rule against the
    dense plain version."""
    plan, model, strong_model = ckpt
    hp, a = strong_model if strong else model
    rng = np.random.default_rng(chains)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
    s_in = s0.clone()
    out = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, beta, uniforms=u)
    ref = gibbs_sweeps_sparse_reference(hp, a, plan, s0, 16, beta, uniforms=u)
    dense = gibbs_sweeps_kernel_reference(hp, a, plan, s0, 16, beta, uniforms=u)
    torch.cuda.synchronize()
    assert _differing(out, ref) == 0
    assert _identical(out, dense) >= CHAIN_RULE
    assert torch.equal(s0, s_in)  # the input is left as it was


def _ladder_beta(chains, dev):
    """Per-chain β as parallel tempering passes it: the default 8-rung
    geometric ladder over [0.25, 1], each rung repeated over its chains."""
    rungs = torch.tensor(np.geomspace(0.25, 1.0, 8), dtype=torch.float32, device=dev)
    return rungs.repeat_interleave(chains // 8)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("chains", [256, 2048])
def test_delta_e_matches_plain(dev, ckpt, strong, chains):
    """K1-ΔE, fed uniforms: no chain differing from the gather's plain
    version, and ΔE within 1e-4 (checkpoint model) or 1e-3·(1 + |E|)
    (|J| ≤ 1); 256 chains at β = 1, 2,048 at the 8-rung ladder's
    per-chain β."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies

    plan, model, strong_model = ckpt
    hp, a = strong_model if strong else model
    rng = np.random.default_rng(chains + 1)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = 1.0 if chains == 256 else _ladder_beta(chains, dev)
    out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, beta, uniforms=u, track_delta_e=True)
    ref, de_ref = gibbs_sweeps_sparse_reference(hp, a, plan, s0, 16, beta, uniforms=u,
                                                track_delta_e=True)
    torch.cuda.synchronize()
    same = (out == ref).all(dim=1)
    assert bool(same.all())
    err = (de - de_ref).abs()[same]
    if strong:
        e_abs = ising_energies(hp, a, ref).abs()[same]
        assert bool((err <= 1e-3 * (1 + e_abs)).all()), float(err.max())
    else:
        assert float(err.max()) <= 1e-4
    # the carry mode leaves the sampled spins as the plain mode draws them
    plain = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, beta, uniforms=u)
    assert torch.equal(plain, out)


def test_philox_delta_e_is_energy_difference(dev, ckpt):
    """In Philox mode ΔE equals E(out) − E(in), both computed in f64."""
    plan, _, (hp, a) = ckpt
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    s0 = random_spins(g, plan, 2048, dev)
    out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, _ladder_beta(2048, dev),
                                           generator=g, track_delta_e=True)

    def e64(s):
        s = s.double()
        return s @ hp.double() + 0.5 * (s * (s @ a.double())).sum(-1)

    diff = (de.double() - (e64(out) - e64(s0))).abs()
    assert float(diff.max()) <= 1e-3 * (1 + float(e64(s0).abs().max()))


def test_philox_stream_matches_numpy_twin(dev, ckpt):
    plan, _, (hp, a) = ckpt
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 128, dev)
    out = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 4, generator=g)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 128, plan.n_pad), device=dev)
    ref = gibbs_sweeps_sparse_reference(hp, a, plan, s0, 4, uniforms=u)
    assert _differing(out, ref) == 0


def test_philox_moments_match_exact(dev):
    edges = np.array([(i, (i + 1) % 10) for i in range(10)] + [(0, 5), (2, 7)])
    graph = GRBMGraph(n=10, edge_i=edges[:, 0], edge_j=edges[:, 1])
    plan = build_plan(graph)
    rng = np.random.default_rng(3)
    h = rng.uniform(-0.3, 0.3, 10).astype(np.float32)
    j = rng.uniform(-0.5, 0.5, len(edges)).astype(np.float32)
    hp, a = permuted_model(plan, torch.tensor(h, device=dev), torch.tensor(j, device=dev))
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    s = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, random_spins(g, plan, 4096, dev), 100,
                                     generator=g)
    s = to_original(plan, s).double().cpu().numpy()
    e1, e2 = exact_moments(h, graph.edge_i, graph.edge_j, j)
    np.testing.assert_allclose(s.mean(0), e1, atol=0.06)
    np.testing.assert_allclose((s[:, graph.edge_i] * s[:, graph.edge_j]).mean(0), e2, atol=0.06)


def test_launch_counter_and_refusals(dev, ckpt):
    """One count per launch, keyed by mode; refusals launch nothing."""
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    plan, (hp, a), _ = ckpt
    s0 = torch.ones((32, plan.n_pad), device=dev)
    k = gibbs_cuda.gibbs_sweeps_cuda
    k.launches.clear()
    k(hp, a, plan, s0, 1)
    with pytest.raises(TypeError):
        k(hp, a.double(), plan, s0, 1)
    with pytest.raises(TypeError):
        k(hp, a.to(torch.int8), plan, s0, 1)  # int8 comes with its scale
    with pytest.raises(ValueError):
        k(hp, a.t(), plan, s0, 1)
    with pytest.raises(ValueError):
        k(hp, a, plan, s0[:, :-4], 1, track_delta_e=True)
    with pytest.raises(TypeError):
        k(hp.double(), a, plan, s0, 1, track_delta_e=True)
    out, de = k(hp, a, plan, s0, 1, track_delta_e=True)
    k(hp, a.to(torch.bfloat16), plan, s0, 1)
    q_out, q_de = k(hp, quantize_coupling(a), plan, s0, 1, track_delta_e=True)
    assert dict(k.launches) == {"K1-f32": 1, "K1-f32-dE": 1, "K1-bf16": 1, "K1-int8-dE": 1}
    assert out.shape == s0.shape and de.shape == (32,) and de.dtype == torch.float32
    assert q_out.dtype == torch.float32 and q_de.dtype == torch.float32


def test_warm_server_runs_through_kernel(dev, tmp_path):
    from image_generation_tpu_torch.app.warm import WarmGenerator

    w = WarmGenerator(tmp_path, config_overrides={"NUM_READS": 16, "GIBBS_BURN_IN": 4},
                      device=dev)
    gibbs_cuda.gibbs_sweeps_cuda.launches.clear()
    out = w.serve(MODEL)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == {"K1-f32": 1}
    assert w._trainer.fns.sampler_impl == "cuda_vmem"
    img = out["images"]
    assert img.shape == (16, 32, 32, 1) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0


def test_sample_fn_kernel_matches_plain_pipeline(dev):
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.step import make_sample_fns

    _, params, graph, _, _ = load_model_dir(MODEL, dev)
    plan = build_plan(graph)
    fns = make_sample_fns(TrainingConfig(), graph, plan, dev)
    plain = make_sample_fns(TrainingConfig(USE_PALLAS="off"), graph, plan, dev)
    rng = np.random.default_rng(9)
    init = torch.tensor(rng.choice([-1.0, 1.0], (64, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((20, 64, plan.n_pad), dtype=np.float32), device=dev)
    a = fns.sample_fn(None, params, 64, 20, init_spins=init, uniforms=u)
    b = plain.sample_fn(None, params, 64, 20, init_spins=init, uniforms=u)
    assert a.shape == (64, graph.n) and _identical(a, b) >= CHAIN_RULE


@pytest.mark.parametrize("sampler", ["gibbs", "pt"])
def test_training_step_on_card_matches_cpu(dev, sampler):
    """One scheduled training step (both negative phases, the GRBM update)
    from the same state and fed draws on the card (bf16 autocast, K1 /
    K1-ΔE) and on the CPU (f32, the plain sweep): finite, chains under the
    chain rule, losses within bf16 tolerance (rtol 2e-2).  The quasi-NLL
    is a mean energy of the 32 straight-through data spin vectors; at the
    initial near-zero logits a bf16 logit crosses its uniform for some
    tens of the 8,192 spins, each moving it by ~1e-3, and cuDNN's choice
    of algorithm changes which: within 0.2 relative plus 0.02 (measured on
    the H100: 0.0063 on 0.17 and 0.031 on 0.29)."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.models.grbm import GRBMParams
    from image_generation_tpu_torch.training.step import StepFeed, make_train_fns

    _, _, graph, _, _ = load_model_dir(MODEL, "cpu")
    plan = build_plan(graph)
    cfg = TrainingConfig(NUM_READS=32, BATCH_SIZE=16, N_REPLICAS=2, GIBBS_SWEEPS=4,
                         GIBBS_BURN_IN=4, SAMPLER=sampler, PT_NUM_BETAS=4)
    cpu = make_train_fns(cfg.replace(COMPUTE_DTYPE="float32"), graph, 10, plan, device="cpu")
    card = make_train_fns(cfg, graph, 10, plan, device=dev)
    s_cpu = cpu.init(3)
    dvae = card.new_dvae()
    dvae.load_state_dict(s_cpu.dvae.state_dict())
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    s_card = card.state_from(
        dvae, GRBMParams(s_cpu.grbm_params.linear.to(dev), s_cpu.grbm_params.quadratic.to(dev)),
        s_cpu.chains.to(dev), g, burn_in=False, chain_energies=s_cpu.chain_energies.to(dev),
        pt_betas=s_cpu.pt_betas.to(dev))
    rng = np.random.default_rng(1)
    chains = s_cpu.chains[..., 0].numel()
    t_c = 4 if sampler == "pt" else 1

    def draws():
        u = rng.random((4, chains, plan.n_pad), dtype=np.float32)
        w = tuple(rng.random((t_c - 1, 32), dtype=np.float32) for _ in range(2))
        return u, (w if sampler == "pt" else None)

    (u1, w1), (u2, w2) = draws(), draws()
    spin_u = rng.random((16, 2, graph.n), dtype=np.float32)
    masks = [np.ones((32, c), np.float32) for c in (128, 64, 32, 1)]
    images = (rng.random((16, 32, 32, 1)) > 0.6).astype(np.float32)

    def feed(d):
        t = lambda x: torch.tensor(x, device=d)  # noqa: E731
        return StepFeed(sweeps1=t(u1), sweeps2=t(u2),
                        swaps1=tuple(map(t, w1)) if w1 else None,
                        swaps2=tuple(map(t, w2)) if w2 else None,
                        spin_uniforms=t(spin_u), dropout_masks=[t(m) for m in masks])

    n0 = sum(gibbs_cuda.gibbs_sweeps_cuda.launches.values())
    m_cpu = cpu.step_body(s_cpu, torch.tensor(images), 0, feed("cpu"))
    m_card = card.step_body(s_card, torch.tensor(images, device=dev), 0, feed(dev))
    torch.cuda.synchronize()
    n1 = sum(gibbs_cuda.gibbs_sweeps_cuda.launches.values())
    assert n1 == n0 + 2  # both negative phases through the kernel
    for name, rtol, atol in (("mse", 2e-2, 1e-4), ("mmd", 2e-2, 1e-4),
                             ("dvae_loss", 2e-2, 1e-4), ("nll", 0.2, 2e-2)):
        a, b = float(getattr(m_card, name)), float(getattr(m_cpu, name))
        assert np.isfinite(a) and abs(a - b) <= rtol * abs(b) + atol, (name, a, b)
    same = (s_card.chains.cpu() == s_cpu.chains).all(-1).float().mean()
    assert float(same) >= CHAIN_RULE


# ---------------------------------------------------------------------------
# K1 with a bf16 and an int8 coupling
# ---------------------------------------------------------------------------

def _k1_coupling(a, form):
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    if form == "int8":
        return quantize_coupling(a)
    return a.to(torch.bfloat16) if form == "bf16" else a


@pytest.fixture(scope="module")
def plan2k(dev):
    """The 2,048-latent Advantage_system6 plan (n_pad 2,432, blocks up to
    512 wide) with a |J| ≤ 1 model: the plan K1-int8 serves."""
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    graph, _ = cached_latent_graph("Advantage_system6", 2048, 775321899904)
    plan = build_plan(graph)
    rng = np.random.default_rng(2)
    hs = torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev)
    js = torch.tensor(rng.uniform(-1, 1, graph.n_edges), dtype=torch.float32, device=dev)
    return plan, permuted_model(plan, hs, js)


def _k1_shapes():
    """Every (chains per block G, threads) K1's launch-shape sweeps time."""
    from image_generation_tpu_torch.ops.gibbs_sparse import _CHAINS

    return [(g, t) for g in _CHAINS for t in (128, 256, 512, 1024)]


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("chains", [256, 1030, 37])
def test_k1_modes_match_plain(dev, ckpt, plan2k, form, chains, track):
    """K1-f32 / K1-bf16 / K1-int8 (and their ΔE modes) against the gather's
    plain version, fed uniforms and per-chain β, on the checkpoint's plan
    and the 2,048-latent plan, at the default launch shape and (f32, bf16)
    at every G and threads: f32 and bf16 no chain differing, int8 the
    chain rule; ΔE within 1e-3·(1 + |E|) on identical chains."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies

    for plan, (hp, a) in ((ckpt[0], ckpt[2]), plan2k):
        coupling = _k1_coupling(a, form)
        rng = np.random.default_rng(chains)
        s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                          device=dev)
        u = torch.tensor(rng.random((3, chains, plan.n_pad), dtype=np.float32), device=dev)
        beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
        ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                            track_delta_e=track)
        rule = CHAIN_RULE if form == "int8" else 1.0
        # the int8 launch shapes: the gather tests below
        for shape in [None] + (_k1_shapes() if form != "int8" else []):
            out = gibbs_cuda.gibbs_sweeps_cuda(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                               track_delta_e=track, _shape=shape)
            torch.cuda.synchronize()
            if not track:
                assert _identical(out, ref) >= rule, shape
                continue
            same = (out[0] == ref[0]).all(dim=1)
            assert float(same.float().mean()) >= rule, shape
            e_abs = ising_energies(hp, coupling, ref[0]).abs()[same]
            assert bool(((out[1] - ref[1]).abs()[same] <= 1e-3 * (1 + e_abs)).all())


@pytest.mark.parametrize("form", ["f32", "bf16"])
@pytest.mark.parametrize("chains", [37, 2050])
def test_k1_every_shape_fed_philox_and_delta_e(dev, plan2k, form, chains):
    """K1-f32 / K1-bf16 at every (G, threads), on 37 and 2,050 chains
    (partial last blocks), per-chain β: fed with ΔE and in Philox mode,
    against the gather's plain version (fed ``philox_uniforms`` for the
    Philox stream): no chain differing, ΔE within 1e-3·(1 + |E|)."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies

    plan, (hp, a) = plan2k
    coupling = _k1_coupling(a, form)
    rng = np.random.default_rng(chains + 7)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.random((3, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
    ref, de_ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                                track_delta_e=True)
    e_abs = ising_energies(hp, coupling, ref).abs()
    g = torch.Generator(device=dev)
    for shape in _k1_shapes():
        out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                               track_delta_e=True, _shape=shape)
        torch.cuda.synchronize()
        assert _differing(out, ref) == 0, shape
        assert bool(((de - de_ref).abs() <= 1e-3 * (1 + e_abs)).all()), shape
        g.manual_seed(shape[0] * 1024 + shape[1])
        probe = torch.Generator(device=dev)
        probe.set_state(g.get_state())
        seed = int(gibbs_cuda.draw_seed(probe, dev).item())
        drawn = gibbs_cuda.gibbs_sweeps_cuda(hp, coupling, plan, s0, 3, beta, generator=g,
                                             _shape=shape)
        u_ph = torch.tensor(gibbs_cuda.philox_uniforms(seed, 3, chains, plan.n_pad), device=dev)
        assert _differing(drawn, gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 3, beta,
                                                               uniforms=u_ph)) == 0, shape


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_k1_modes_philox_match_numpy_twin(dev, plan2k, form):
    """Philox mode against the gather's plain version fed
    ``philox_uniforms`` (f32 and bf16: no chain differing; int8: the chain
    rule), and ΔE against the f64 energy change of the model the mode
    samples."""
    from image_generation_tpu_torch.ops.quant import dequantize_coupling

    plan, (hp, a) = plan2k
    coupling = _k1_coupling(a, form)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 256, dev)
    out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, coupling, plan, s0, 4, generator=g,
                                           track_delta_e=True)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 256, plan.n_pad), device=dev)
    ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, uniforms=u)
    assert _identical(out, ref) >= (CHAIN_RULE if form == "int8" else 1.0)
    dense = (dequantize_coupling(coupling) if form == "int8" else coupling.float()).double()

    def e64(s):
        s = s.double()
        return s @ hp.double() + 0.5 * (s * (s @ dense)).sum(-1)

    diff = (de.double() - (e64(out) - e64(s0))).abs()
    assert float(diff.max()) <= 1e-3 * (1 + float(e64(s0).abs().max()))


# ---------------------------------------------------------------------------
# the streaming kernels K2 (dense) and K3 (packed)
# ---------------------------------------------------------------------------

def _stream_coupling(a, form, chunk, plan):
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    c = {"f32": a, "bf16": a.to(torch.bfloat16), "int8": quantize_coupling(a)}[form]
    return pack_coupling(plan, c, chunk) if chunk else c


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("chunk", [None, 128, 256])  # None: dense (K2); 256 clamps at n_pad 640
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_stream_kernel_matches_plain(dev, ckpt, form, chunk, track):
    """Every mode of K2 and K3 on the checkpoint's plan (blocks up to 512
    wide), |J| ≤ 1, per-chain β, 1,030 chains (a partial last block at
    every G > 1), 3 sweeps run as 4: through the route at its default
    launch shape and through the gather at every (chains per block,
    threads) it can take, against the gather's plain version (f32: no
    chain differing; bf16: ≥ 99.9 %; int8: the chain rule) and against the dense plain
    version (the chain rule), ΔE within 1e-3·(1 + |E|)."""
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )
    from image_generation_tpu_torch.ops.gibbs_sparse import _CHAINS, gibbs_sweeps_sparse

    plan, _, (hp, a) = ckpt
    coupling = _stream_coupling(a, form, chunk, plan)
    rng = np.random.default_rng(7)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (1030, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((4, 1030, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, 1030), dtype=torch.float32, device=dev)
    twin = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                         track_delta_e=track)
    dense = gibbs_sweeps_hbm_reference(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                       track_delta_e=track)
    outs = [gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                  track_delta_e=track)]
    for shape in [(g, t) for g in _CHAINS for t in (128, 256, 512, 1024)]:
        outs.append(gibbs_sweeps_sparse(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                        track_delta_e=track, _shape=shape))
    torch.cuda.synchronize()
    for out in outs:
        frac = _gather_check(out, twin, hp, coupling,
                             rule=CHAIN_RULE if form == "int8" else 0.999)
        if form == "f32":
            assert frac == 1.0
        _gather_check(out, dense, hp, coupling)


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_stream_k3_equals_k2_on_integer_couplings(dev, ckpt, form):
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda

    plan = ckpt[0]
    rng = np.random.default_rng(8)
    graph_n = int(plan.valid_mask.sum())
    h = torch.tensor(np.round(rng.normal(size=graph_n)), dtype=torch.float32, device=dev)
    j = torch.tensor(rng.choice([-1.0, 1.0], len(plan.perm_edge_i)), dtype=torch.float32,
                     device=dev)
    hp, a = permuted_model(plan, h, j)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (512, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((4, 512, plan.n_pad), dtype=np.float32), device=dev)
    k2 = gibbs_sweeps_hbm_cuda(hp, _stream_coupling(a, form, None, plan), plan, s0, 4,
                               uniforms=u, track_delta_e=True)
    for chunk in (128, 256):
        k3 = gibbs_sweeps_hbm_cuda(hp, _stream_coupling(a, form, chunk, plan), plan, s0, 4,
                                   uniforms=u, track_delta_e=True)
        torch.cuda.synchronize()
        assert torch.equal(k2[0], k3[0]) and torch.equal(k2[1], k3[1])


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_stream_philox_matches_numpy_twin(dev, ckpt, form):
    """Philox mode of K3 against the dense plain version (the chain rule)
    and the gather's (f32: no chain differing) fed ``philox_uniforms`` for
    the even sweep count."""
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )

    plan, _, (hp, a) = ckpt
    coupling = _stream_coupling(a, form, 256, plan)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 256, dev)
    out, de = gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, 3, generator=g, track_delta_e=True)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 256, plan.n_pad), device=dev)
    ref = gibbs_sweeps_hbm_reference(hp, coupling, plan, s0, 3, uniforms=u)
    assert _identical(out, ref) >= CHAIN_RULE
    twin = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, uniforms=u)
    assert _identical(out, twin) >= CHAIN_RULE and (form != "f32" or _differing(out, twin) == 0)


def test_stream_unoccupied_color_and_counters(dev):
    """A packed plan with a color nothing couples into (fields = h) against
    the dense kernel, bit for bit on integer couplings; the counters move
    once per launch by kernel and mode; refusals launch nothing."""
    from image_generation_tpu_torch.ops.block_sparse import color_chunk_rows, pack_coupling
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda as k

    rng = np.random.default_rng(9)
    ring = np.array([(i, (i + 1) % 200) for i in range(200)])
    graph = GRBMGraph(n=264, edge_i=ring[:, 0], edge_j=ring[:, 1])  # 64 isolated spins
    plan = build_plan(graph, pad_to=64, max_class=64)
    assert () in color_chunk_rows(plan, 64)
    h = torch.tensor(np.round(rng.normal(size=264)), dtype=torch.float32, device=dev)
    j = torch.tensor(rng.choice([-1.0, 1.0], 200), dtype=torch.float32, device=dev)
    hp, a = permuted_model(plan, h, j)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (300, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((2, 300, plan.n_pad), dtype=np.float32), device=dev)
    k.launches.clear()
    k2 = k(hp, a, plan, s0, 2, uniforms=u, track_delta_e=True)
    k3 = k(hp, pack_coupling(plan, a, 64), plan, s0, 2, uniforms=u, track_delta_e=True)
    k3b = k(hp, pack_coupling(plan, a.to(torch.bfloat16), 64), plan, s0, 2, uniforms=u)
    torch.cuda.synchronize()
    assert torch.equal(k2[0], k3[0]) and torch.equal(k2[1], k3[1]) and torch.equal(k3b, k3[0])
    assert dict(k.launches) == {"K2-f32-dE": 1, "K3-f32-dE": 1, "K3-bf16": 1}
    with pytest.raises(TypeError):
        k(hp, a.double(), plan, s0, 2, uniforms=u)
    with pytest.raises(ValueError):
        k(hp, a, plan, s0, 3, uniforms=u)  # 3 sweeps run as 4: u is too short
    with pytest.raises(ValueError):
        k(hp, a.t(), plan, s0, 2, uniforms=u)
    assert sum(k.launches.values()) == 3


# ---------------------------------------------------------------------------
# the gather kernel (K1-int8, K2-int8, K3-int8; K2-bf16, K3-bf16)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_plans(dev):
    """{name: (plan, hp, QuantCoupling, packed int8 panels at chunk 256)}
    for the 2,048-latent and the scaled plan, |J| ≤ 1 models."""
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.ops.quant import quantize_coupling
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    out = {}
    for name, n in (("latents2048", 2048), ("scaled", 5640)):
        graph, _ = cached_latent_graph("Advantage_system6", n, 775321899904)
        plan = build_plan(graph)
        rng = np.random.default_rng(n)
        hp, a = permuted_model(
            plan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1, 1, graph.n_edges), dtype=torch.float32, device=dev))
        qc = quantize_coupling(a)
        out[name] = (plan, hp, qc, pack_coupling(plan, qc, 256))
    return out


def _gather_check(out, ref, hp, coupling, rule=CHAIN_RULE):
    """The chain rule, and ΔE within 1e-3·(1 + |E|) on identical chains."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies

    track = isinstance(out, tuple)
    spins, spins_ref = (out[0], ref[0]) if track else (out, ref)
    same = (spins == spins_ref).all(dim=1)
    assert float(same.float().mean()) >= rule
    if track:
        e_abs = ising_energies(hp, coupling, spins_ref).abs()[same]
        assert bool(((out[1] - ref[1]).abs()[same] <= 1e-3 * (1 + e_abs)).all())
    return float(same.float().mean())


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("chains", [256, 1024, 2048])
@pytest.mark.parametrize("name", ["latents2048", "scaled"])
def test_gather_kernel_matches_its_plain_version(dev, int8_plans, name, chains, track):
    """Fed uniforms, β = 1 at 256 chains and per-chain β above, 6 sweeps,
    the dense int8 matrix and (scaled plan) the packed panels, at the
    default launch shape of 256·k chains."""
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse,
        gibbs_sweeps_sparse_reference,
    )

    plan, hp, qc, bsc = int8_plans[name]
    rng = np.random.default_rng(chains + 1)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.random((6, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = (1.0 if chains == 256 else
            torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev))
    for coupling in ((qc, bsc) if name == "scaled" else (qc,)):
        out = gibbs_sweeps_sparse(hp, coupling, plan, s0, 6, beta, uniforms=u,
                                       track_delta_e=track)
        ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 6, beta, uniforms=u,
                                                 track_delta_e=track)
        torch.cuda.synchronize()
        _gather_check(out, ref, hp, coupling)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", ["latents2048", "scaled"])
def test_gather_kernel_philox_matches_numpy_twin(dev, int8_plans, name, track):
    """Philox mode against the plain version fed ``philox_uniforms`` (K1's
    counter and key), with and without ΔE."""
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse,
        gibbs_sweeps_sparse_reference,
    )

    plan, hp, qc, bsc = int8_plans[name]
    coupling = bsc if name == "scaled" else qc
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 512, dev)
    out = gibbs_sweeps_sparse(hp, coupling, plan, s0, 4, generator=g, track_delta_e=track)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 512, plan.n_pad), device=dev)
    ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, uniforms=u,
                                             track_delta_e=track)
    _gather_check(out, ref, hp, coupling)


@pytest.mark.parametrize("route", ["K1", "K3"])
def test_gather_routes_match_the_dense_plain_version(dev, int8_plans, route):
    """One case per route at its serving shape (256 chains), fed uniforms:
    K1-int8 through ``gibbs_sweeps_cuda`` on the 2,048-latent plan against
    ``gibbs_sweeps_kernel_reference``, K3-int8 through
    ``gibbs_sweeps_hbm_cuda`` on the scaled panels against
    ``gibbs_sweeps_hbm_reference``; each launch counted under its mode."""
    from image_generation_tpu_torch.ops.gibbs import gibbs_sweeps_kernel_reference
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )

    plan, hp, qc, bsc = int8_plans["latents2048" if route == "K1" else "scaled"]
    rng = np.random.default_rng(31)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (256, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((16, 256, plan.n_pad), dtype=np.float32), device=dev)
    if route == "K1":
        wrapper, coupling, dense, mode = (gibbs_cuda.gibbs_sweeps_cuda, qc,
                                          gibbs_sweeps_kernel_reference, "K1-int8")
    else:
        wrapper, coupling, dense, mode = (gibbs_sweeps_hbm_cuda, bsc, gibbs_sweeps_hbm_reference,
                                          "K3-int8")
    wrapper.launches.clear()
    out = wrapper(hp, coupling, plan, s0, 16, uniforms=u)
    ref = dense(hp, coupling, plan, s0, 16, uniforms=u)
    torch.cuda.synchronize()
    _gather_check(out, ref, hp, coupling, rule=0.999)
    assert dict(wrapper.launches) == {mode: 1}


def test_gather_kernel_every_shape_and_refusals(dev, int8_plans):
    """Every chains-per-block G the source instantiates, at 512 and 1,024
    threads, on 37 and 2,050 chains (partial last blocks), ΔE on, against
    the plain version; shapes the kernel does not take raise before a
    launch."""
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse,
        gibbs_sweeps_sparse_reference,
    )

    plan, hp, qc, _ = int8_plans["latents2048"]
    for chains in (37, 2050):
        rng = np.random.default_rng(chains)
        s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                          device=dev)
        u = torch.tensor(rng.random((3, chains, plan.n_pad), dtype=np.float32), device=dev)
        beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
        ref = gibbs_sweeps_sparse_reference(hp, qc, plan, s0, 3, beta, uniforms=u,
                                                 track_delta_e=True)
        for g in (1, 2, 4, 8, 16):
            for threads in (512, 1024):
                out = gibbs_sweeps_sparse(hp, qc, plan, s0, 3, beta, uniforms=u,
                                               track_delta_e=True, _shape=(g, threads))
                torch.cuda.synchronize()
                _gather_check(out, ref, hp, qc)
    s0 = torch.ones((64, plan.n_pad), device=dev)
    for shape in ((3, 512), (2, 48), (1, 2048), (32, 1024)):
        with pytest.raises(ValueError):
            gibbs_sweeps_sparse(hp, qc, plan, s0, 1, _shape=shape)
    with pytest.raises(TypeError):
        gibbs_sweeps_sparse(hp, qc.q, plan, s0, 1)  # int8 comes with its scale
    with pytest.raises(ValueError):
        gibbs_sweeps_sparse(hp, qc, plan, s0, 3, uniforms=torch.rand((2, 64, plan.n_pad),
                                                                         device=dev))


@pytest.fixture(scope="module")
def bf16_plans(dev):
    """{name: (plan, hp, dense bf16 coupling, bf16 panels at chunk 256)}
    for the 2,048-latent and the scaled plan, |J| ≤ 1 models."""
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    out = {}
    for name, n in (("latents2048", 2048), ("scaled", 5640)):
        graph, _ = cached_latent_graph("Advantage_system6", n, 775321899904)
        plan = build_plan(graph)
        rng = np.random.default_rng(n + 1)
        hp, a = permuted_model(
            plan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1, 1, graph.n_edges), dtype=torch.float32, device=dev))
        a = a.to(torch.bfloat16)
        out[name] = (plan, hp, a, pack_coupling(plan, a, 256))
    return out


def _ladder_32(chains, dev):
    """The scaled configuration's 32-rung ladder, one β per chain."""
    from image_generation_tpu_torch.config import TrainingConfig

    betas = TrainingConfig(PT_NUM_BETAS=32, PT_BETA_MIN=0.2).initial_pt_betas()
    return torch.tensor(betas, dtype=torch.float32, device=dev).repeat_interleave(chains // 32)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("chains", [256, 2048])
@pytest.mark.parametrize("name", ["latents2048", "scaled"])
def test_bf16_gather_kernel_matches_its_plain_version(dev, bf16_plans, name, chains, track):
    """K2-bf16 (the dense matrix) and K3-bf16 (its panels) through the
    gather kernel against its plain version, fed uniforms, β = 1 at 256
    chains and the 32-rung ladder's β at 2,048, 4 sweeps, at the default
    launch shape and at every (chains per block, threads) the wrapper can
    take: ≥ 99.9 % of chains identical (all expected: the same f32 sums in
    the same order), ΔE within 1e-3·(1 + |E|)."""
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        _CHAINS,
        gibbs_sweeps_sparse,
        gibbs_sweeps_sparse_reference,
    )

    plan, hp, a, bsc = bf16_plans[name]
    rng = np.random.default_rng(chains + 2)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.random((4, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = 1.0 if chains == 256 else _ladder_32(chains, dev)
    shapes = [None] + [(g, t) for g in _CHAINS for t in (512, 1024)]
    for coupling in (a, bsc):
        ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                            track_delta_e=track)
        for shape in shapes:
            out = gibbs_sweeps_sparse(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                      track_delta_e=track, _shape=shape)
            torch.cuda.synchronize()
            _gather_check(out, ref, hp, coupling, rule=0.999)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", ["latents2048", "scaled"])
def test_bf16_gather_kernel_philox_matches_numpy_twin(dev, bf16_plans, name, track):
    """Philox mode (K2-bf16 on the 2,048-latent plan, K3-bf16 on the scaled
    panels) against the plain version fed ``philox_uniforms``."""
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse,
        gibbs_sweeps_sparse_reference,
    )

    plan, hp, a, bsc = bf16_plans[name]
    coupling = bsc if name == "scaled" else a
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 512, dev)
    out = gibbs_sweeps_sparse(hp, coupling, plan, s0, 4, generator=g, track_delta_e=track)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 512, plan.n_pad), device=dev)
    ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, uniforms=u,
                                        track_delta_e=track)
    _gather_check(out, ref, hp, coupling, rule=0.999)


def test_bf16_routes_match_the_dense_plain_version(dev, bf16_plans):
    """The streaming route at the paths' shapes, fed uniforms, against the
    dense plain version ``gibbs_sweeps_hbm_reference`` (another summation
    order: the chain rule): the 2,048-latent training refresh (dense, 256
    chains x 16 sweeps, K2-bf16) and the scaled PT refresh (packed, 2,048
    chains at the ladder's β, 3 sweeps run as 4, ΔE, K3-bf16-dE); each
    launch counted once under its mode."""
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )

    gibbs_sweeps_hbm_cuda.launches.clear()
    for name, chains, sweeps, track in (("latents2048", 256, 16, False), ("scaled", 2048, 3, True)):
        plan, hp, a, bsc = bf16_plans[name]
        coupling = a if name == "latents2048" else bsc
        rng = np.random.default_rng(sweeps)
        s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                          device=dev)
        u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
        beta = 1.0 if chains == 256 else _ladder_32(chains, dev)
        out = gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, sweeps, beta, uniforms=u,
                                    track_delta_e=track)
        ref = gibbs_sweeps_hbm_reference(hp, coupling, plan, s0, sweeps, beta, uniforms=u,
                                         track_delta_e=track)
        torch.cuda.synchronize()
        _gather_check(out, ref, hp, coupling)
    assert dict(gibbs_sweeps_hbm_cuda.launches) == {"K2-bf16": 1, "K3-bf16-dE": 1}


def test_bf16_gather_refuses_without_fallback(dev, bf16_plans):
    """What the gather does not take raises before a launch, and the route
    counts nothing: an f64 matrix, f16 panels, a launch shape that does not
    fit, a non-contiguous coupling, a plan wider than a bf16 table word
    holds."""
    from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse

    from image_generation_tpu_torch.ops.block_sparse import pack_coupling

    plan, hp, a, _ = bf16_plans["latents2048"]
    s0 = torch.ones((64, plan.n_pad), device=dev)
    for other in (a.double(), pack_coupling(plan, a.half(), 256)):
        with pytest.raises(TypeError):
            gibbs_sweeps_sparse(hp, other, plan, s0, 2)
    for shape in ((3, 512), (2, 48), (1, 2048), (32, 1024)):
        with pytest.raises(ValueError):
            gibbs_sweeps_sparse(hp, a, plan, s0, 2, _shape=shape)
    gibbs_sweeps_hbm_cuda.launches.clear()
    with pytest.raises(ValueError):
        gibbs_sweeps_hbm_cuda(hp, a.t(), plan, s0, 2)
    wide = type(plan)(n=65664, n_pad=65664, blocks=((0, 65664, 65664),),
                      orig_to_perm=np.arange(65664), perm_edge_i=np.zeros(0, np.int64),
                      perm_edge_j=np.zeros(0, np.int64), valid_mask=np.ones(65664, bool))
    panels = BlockSparseCoupling(panels=torch.zeros((128, 65664), dtype=torch.bfloat16,
                                                    device=dev), scale=None, plan=wide, chunk=128)
    with pytest.raises(ValueError, match="table word"):
        gibbs_sweeps_hbm_cuda(torch.zeros(65664, device=dev), panels, wide,
                              torch.ones((1, 65664), device=dev), 2)
    assert not gibbs_sweeps_hbm_cuda.launches


@pytest.fixture(scope="module")
def f32_plans(dev):
    """{name: (plan, hp, dense f32 coupling, f32 panels at chunk 256)} for
    the 1,280-latent Advantage2_system1 plan (n_pad 1,664, the default
    configuration's K2-f32 path) and the scaled plan, |J| ≤ 1 models."""
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    out = {}
    for name, qpu, n in (("latents1280", "Advantage2_system1", 1280),
                         ("scaled", "Advantage_system6", 5640)):
        graph, _ = cached_latent_graph(qpu, n, 775321899904)
        plan = build_plan(graph)
        rng = np.random.default_rng(n + 3)
        hp, a = permuted_model(
            plan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1, 1, graph.n_edges), dtype=torch.float32, device=dev))
        out[name] = (plan, hp, a, pack_coupling(plan, a, 256))
    return out


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("chains", [256, 2048])
@pytest.mark.parametrize("name", ["latents1280", "scaled"])
def test_f32_gather_kernel_matches_its_plain_version(dev, f32_plans, name, chains, track):
    """K2-f32 (the dense matrix) and K3-f32 (its panels) through the
    gather kernel against its plain version, fed uniforms, β = 1 at 256
    chains and the 32-rung ladder's β at 2,048, 4 sweeps, at the default
    launch shape and at every (chains per block, threads) the wrapper can
    take: no chain differing (the same f32 sums in the same order), ΔE
    within 1e-3·(1 + |E|)."""
    from image_generation_tpu_torch.ops.gibbs_sparse import _CHAINS, gibbs_sweeps_sparse

    plan, hp, a, bsc = f32_plans[name]
    rng = np.random.default_rng(chains + 4)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.random((4, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = 1.0 if chains == 256 else _ladder_32(chains, dev)
    shapes = [None] + [(g, t) for g in _CHAINS for t in (512, 1024)]
    for coupling in (a, bsc):
        ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                            track_delta_e=track)
        for shape in shapes:
            out = gibbs_sweeps_sparse(hp, coupling, plan, s0, 4, beta, uniforms=u,
                                      track_delta_e=track, _shape=shape)
            torch.cuda.synchronize()
            assert _gather_check(out, ref, hp, coupling) == 1.0


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", ["latents1280", "scaled"])
def test_f32_gather_kernel_philox_matches_numpy_twin(dev, f32_plans, name, track):
    """Philox mode (K2-f32 on the 1,280-latent plan, K3-f32 on the scaled
    panels) against the plain version fed ``philox_uniforms``: no chain
    differing."""
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda

    plan, hp, a, bsc = f32_plans[name]
    coupling = bsc if name == "scaled" else a
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    probe = torch.Generator(device=dev)
    probe.set_state(g.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 512, dev)
    out = gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, 3, generator=g, track_delta_e=track)
    u = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 512, plan.n_pad), device=dev)
    ref = gibbs_sweeps_sparse_reference(hp, coupling, plan, s0, 4, uniforms=u,
                                        track_delta_e=track)
    assert _gather_check(out, ref, hp, coupling) == 1.0


def test_f32_routes_match_the_dense_plain_version(dev, f32_plans):
    """The streaming route at the paths' shapes, fed uniforms, against the
    dense plain version ``gibbs_sweeps_hbm_reference`` (another summation
    order: the chain rule): the 1,280-latent plain Gibbs refresh (dense,
    256 chains x 16 sweeps, K2-f32), its PT refresh (8 rungs x 256 chains
    at the ladder's β, 16 sweeps, ΔE, K2-f32-dE) and the scaled PT refresh
    (packed, 2,048 chains, 3 sweeps run as 4, ΔE, K3-f32-dE); each launch
    counted once under its mode."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )

    ladder8 = torch.tensor(TrainingConfig().initial_pt_betas(), dtype=torch.float32,
                           device=dev).repeat_interleave(256)
    gibbs_sweeps_hbm_cuda.launches.clear()
    for name, chains, sweeps, track in (("latents1280", 256, 16, False),
                                        ("latents1280", 2048, 16, True),
                                        ("scaled", 2048, 3, True)):
        plan, hp, a, bsc = f32_plans[name]
        coupling = a if name == "latents1280" else bsc
        rng = np.random.default_rng(sweeps + chains)
        s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                          device=dev)
        u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
        beta = (1.0 if chains == 256 else
                ladder8 if name == "latents1280" else _ladder_32(chains, dev))
        out = gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, sweeps, beta, uniforms=u,
                                    track_delta_e=track)
        ref = gibbs_sweeps_hbm_reference(hp, coupling, plan, s0, sweeps, beta, uniforms=u,
                                         track_delta_e=track)
        torch.cuda.synchronize()
        _gather_check(out, ref, hp, coupling)
    assert dict(gibbs_sweeps_hbm_cuda.launches) == {"K2-f32": 1, "K2-f32-dE": 1, "K3-f32-dE": 1}


def test_f32_gather_refuses_without_fallback(dev, f32_plans):
    """No dense kernel is left: what the gather does not take in f32
    raises before a launch, and the route counts nothing: f64 panels and an
    f64 matrix, panels cut for another plan, a launch shape that does not
    fit, a non-contiguous coupling, too few fed uniforms for the even
    sweep count."""
    from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse

    plan, hp, a, bsc = f32_plans["latents1280"]
    other_plan = f32_plans["scaled"][0]
    s0 = torch.ones((64, plan.n_pad), device=dev)
    gibbs_sweeps_hbm_cuda.launches.clear()
    f64 = BlockSparseCoupling(panels=bsc.panels.double(), scale=None, plan=plan, chunk=256)
    for bad in (f64, a.double()):
        with pytest.raises(TypeError):
            gibbs_sweeps_hbm_cuda(hp, bad, plan, s0, 2)
    with pytest.raises(ValueError, match="another plan"):
        gibbs_sweeps_hbm_cuda(hp, f32_plans["scaled"][3], plan, s0, 2)
    with pytest.raises(ValueError):
        gibbs_sweeps_hbm_cuda(hp, a.t(), plan, s0, 2)
    with pytest.raises(ValueError):
        gibbs_sweeps_hbm_cuda(hp, a, plan, s0, 3, uniforms=torch.rand((3, 64, plan.n_pad),
                                                                         device=dev))
    for shape in ((3, 512), (2, 48), (1, 2048), (32, 1024)):
        with pytest.raises(ValueError):
            gibbs_sweeps_sparse(hp, bsc, plan, s0, 2, _shape=shape)
    assert other_plan.n_pad != plan.n_pad and not gibbs_sweeps_hbm_cuda.launches


# ---------------------------------------------------------------------------
# the span update K4 and the graph-sharded sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 37, 2048])
@pytest.mark.parametrize("per_chain", [False, True])
def test_span_update_fed_matches_plain(dev, rows, per_chain):
    """K4's fed entry against ``span_update_reference`` bit for bit, with
    the uniforms a strided view of a (sweeps, rows, n_pad) array (the span's
    columns) and a 600-wide span (three column tiles, a ragged edge)."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
        span_update,
        span_update_reference,
    )

    rng = np.random.default_rng(rows)
    fields = torch.tensor(rng.uniform(-4, 4, (rows, 600)), dtype=torch.float32, device=dev)
    u_all = torch.tensor(rng.random((2, rows, 1000), dtype=np.float32), device=dev)
    u = u_all[1, :, 300:900]
    beta = (torch.tensor(rng.uniform(0.2, 2.0, rows), dtype=torch.float32, device=dev)
            if per_chain else 0.7)
    span_update.launches.clear()
    out = span_update(fields, beta, uniforms=u)
    ref = span_update_reference(fields, beta, uniforms=u)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert dict(span_update.launches) == {"K4f": 1}


def test_span_update_philox_matches_numpy_twin(dev):
    """K4's Philox entry draws ``philox_uniforms`` at the span's global
    rows, columns and sweep."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
        philox_span_uniforms,
        span_update,
        span_update_reference,
    )

    rng = np.random.default_rng(3)
    fields = torch.tensor(rng.uniform(-3, 3, (64, 300)), dtype=torch.float32, device=dev)
    seed = torch.tensor([987654321987], dtype=torch.int64, device=dev)
    out = span_update(fields, 1.3, seed=seed, row0=128, col0=1000, sweep=3)
    u = torch.tensor(philox_span_uniforms(987654321987, 3, 128, 64, 1000, 300), device=dev)
    assert torch.equal(out, span_update_reference(fields, 1.3, uniforms=u))
    assert torch.equal(out, span_update_reference(fields, 1.3, seed=seed, row0=128, col0=1000,
                                                  sweep=3))


def test_span_update_refuses_without_fallback(dev):
    """Anything K4 does not take raises, and nothing launches."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update

    fields = torch.zeros((8, 16), device=dev)
    u = torch.rand((8, 16), device=dev)
    seed = torch.tensor([1], dtype=torch.int64, device=dev)
    span_update.launches.clear()
    for kwargs in (dict(uniforms=u, seed=seed), dict(), dict(uniforms=u.t().contiguous()),
                   dict(uniforms=u[:, ::2]), dict(seed=seed.to(torch.int32))):
        with pytest.raises(ValueError):
            span_update(fields, 1.0, **kwargs)
    with pytest.raises(ValueError):
        span_update(fields.t(), 1.0, uniforms=u)  # not contiguous
    with pytest.raises(ValueError):
        span_update(fields, torch.ones(3, device=dev), uniforms=u)  # beta rows
    with pytest.raises(ValueError):
        span_update(fields.double(), 1.0, uniforms=u)
    assert not span_update.launches


# the class-span widths of the scaled plan (5,640 latents, n_pad 6,016: 4 x
# 1,408 and 3 x 128 columns) and the window cases of a span [start, stop)
SCALED_SPAN_WIDTHS = (1408, 128)
WINDOW_CASES = ("inside", "left", "right", "covering")
CARRY_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _window(case, start, width):
    """(lo, cols) of a rank window that lies inside the span, straddles its
    left or right edge, or covers it."""
    return {"inside": (start + width // 4, width // 2),
            "left": (start - 37, 37 + width // 3),
            "right": (start + width - width // 3, width // 3 + 50),
            "covering": (start - 5, width + 10)}[case]


@pytest.mark.parametrize("carry", CARRY_DTYPES, ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("rows", [1, 37, 2048])
def test_span_window_matches_plain(dev, rows, carry):
    """The window kernel against ``span_update_window_reference`` over
    every span width of the scaled plan and every window case, with the
    products (f32, or int32 totals and a scale for an int8 carry) and with
    no partial, scalar and per-chain β, fed (a strided plane of a (sweeps,
    rows, n_pad) array) and Philox uniforms, in a window whose rows are
    strided: spins bit for bit, ΔE within 1e-4·(1 + |ΔE|); one launch
    each."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
        philox_span_uniforms,
        span_update,
        span_update_window,
        span_update_window_reference,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(rows)
    n_pad, start, row0, sweep = 6016, 2816, 64, 3
    seed = torch.tensor([0x5EED5EED1234], dtype=torch.int64, device=dev)
    h = torch.randn(n_pad, generator=g, device=dev)
    u_all = torch.rand((2, rows, n_pad), generator=g, device=dev)
    beta_rows = 0.2 + 1.8 * torch.rand(rows, generator=g, device=dev)
    scale = torch.tensor(0.0123456789, device=dev)
    checked = 0
    for width in SCALED_SPAN_WIDTHS:
        stop = start + width
        wide = torch.randn((rows, width + 9), generator=g, device=dev)
        f32_partial = (3.0 * wide)[:, 3:3 + width]  # rows strided by width + 9
        i32_partial = torch.randint(-300, 301, (rows, width + 9), generator=g, device=dev,
                                    dtype=torch.int32)[:, 2:2 + width]
        ph = torch.tensor(philox_span_uniforms(0x5EED5EED1234, sweep, row0, rows, start, width),
                          device=dev)
        u_ph = torch.zeros((rows, n_pad), device=dev)
        u_ph[:, start:stop] = ph
        for case in WINDOW_CASES:
            lo, cols = _window(case, start, width)
            old = torch.where(torch.rand((rows, cols + 7), generator=g, device=dev) < 0.5,
                              1.0, -1.0).to(carry)
            for partial in ("products", None):
                part, sc = None, None
                if partial is not None:
                    part, sc = (i32_partial, scale) if carry == torch.int8 else (f32_partial,
                                                                                   None)
                for beta in (0.7, beta_rows):
                    for fed in (True, False):
                        s_k, s_p = old.clone()[:, :cols], old.clone()[:, :cols]
                        de_k = torch.zeros(rows, device=dev)
                        de_p = torch.zeros(rows, device=dev)
                        kw = dict(scale=sc, row0=row0, sweep=sweep)
                        span_update.launches.clear()
                        span_update_window(part, h, beta, s_k, lo, start, stop,
                                           uniforms=u_all[1] if fed else None,
                                           seed=None if fed else seed, delta_e=de_k, **kw)
                        assert dict(span_update.launches) == {"K4f" if fed else "K4": 1}
                        span_update_window_reference(part, h, beta, s_p, lo, start, stop,
                                                     uniforms=u_all[1] if fed else u_ph,
                                                     delta_e=de_p, **kw)
                        torch.cuda.synchronize()
                        assert s_k.dtype == carry
                        assert torch.equal(s_k, s_p), (width, case, partial, fed)
                        assert bool(((de_k - de_p).abs() <= 1e-4 * (1 + de_p.abs())).all())
                        checked += 1
    assert checked == len(SCALED_SPAN_WIDTHS) * len(WINDOW_CASES) * 8


@pytest.mark.parametrize("carry", CARRY_DTYPES, ids=["f32", "bf16", "int8"])
def test_span_window_delta_e_repeats_itself(dev, carry):
    """K4's ΔE is summed in one order: at 2,048 chain rows on every window
    ``chip_smoke.py`` checks on the scaled plan (each rank's owned spans at
    the (1, 4) mesh, the widest 1,408 columns, and inside / left / right /
    covering at each class-span width), with ΔE and Philox, 20 launches
    from the same spins and a zeroed ΔE give the same ΔE and spins bit for
    bit."""
    from image_generation_tpu_torch.ops.gibbs import class_spans
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update_window
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    graph, _ = cached_latent_graph("Advantage_system6", 5640, 775321899904)
    plan = build_plan(graph)
    rows, ranks = 2048, 4
    l_loc = plan.n_pad // ranks
    spans = [(a, b) for a, b, _b0, _b1 in class_spans(plan)]
    windows = [(a, b, r * l_loc, l_loc) for r in range(ranks) for a, b in spans
               if max(a, r * l_loc) < min(b, (r + 1) * l_loc)]
    by_width = {b - a: (a, b) for a, b in spans if a >= 64 and b + 64 <= plan.n_pad}
    for w, (a, b) in sorted(by_width.items()):
        windows += [(a, b, *_window(case, a, w)) for case in WINDOW_CASES]
    owned = [min(b, lo + cols) - max(a, lo) for a, b, lo, cols in windows]
    assert max(owned) == 1408 and len(windows) == 18
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    seed = torch.tensor([0x5EED5EED1234], dtype=torch.int64, device=dev)
    h = torch.randn(plan.n_pad, generator=g, device=dev)
    beta = 0.2 + 1.8 * torch.rand(rows, generator=g, device=dev)
    for start, stop, lo, cols in windows:
        partial = 3.0 * torch.randn((rows, stop - start), generator=g, device=dev)
        s0 = torch.where(torch.rand((rows, cols), generator=g, device=dev) < 0.5, 1.0,
                         -1.0).to(carry)
        first = None
        for _ in range(20):
            s, de = s0.clone(), torch.zeros(rows, device=dev)
            span_update_window(partial, h, beta, s, lo, start, stop, seed=seed, sweep=1,
                               delta_e=de)
            torch.cuda.synchronize()
            if first is None:
                first = (s, de)
                assert bool(de.abs().sum() > 0)
                continue
            assert torch.equal(s, first[0]) and torch.equal(de, first[1]), (start, lo, cols)


def test_span_window_int8_fields_round_twice(dev):
    """On int32 totals where one fused multiply-add differs from the
    scale-out and the add of h rounded apart, the kernel's fields (2·f
    read back from ΔE on a one-column window, new spin +1, old −1) equal
    the two roundings bit for bit, as the plain version's and JAX's do
    (tests/test_torch_k4_window.py)."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update_window

    q = np.random.default_rng(0).integers(-5000, 5001, 4096).astype(np.int32)
    scale, h = np.float32(0.0123456789), np.float32(0.3456789)
    two = (q.astype(np.float32) * scale) + h
    fused = (q.astype(np.float64) * np.float64(scale) + np.float64(h)).astype(np.float32)
    assert (two != fused).mean() > 0.05
    s = torch.full((q.size, 1), -1, dtype=torch.int8, device=dev)
    de = torch.zeros(q.size, device=dev)
    span_update_window(torch.tensor(q.reshape(-1, 1), device=dev),
                       torch.tensor([0.0, 0.0, 0.0, float(h)], device=dev), 1e-3, s, 3, 3, 4,
                       scale=torch.tensor(scale, device=dev),
                       uniforms=torch.zeros((q.size, 4), device=dev), delta_e=de)
    torch.cuda.synchronize()
    assert bool((s == 1).all())
    np.testing.assert_array_equal(de.cpu().numpy() / 2, two)


def test_span_window_refuses_without_fallback(dev):
    """A CPU tensor in the CUDA path, a dtype or shape the kernel does not
    take, or a window that owns no column of the span raises, and nothing
    launches."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
        SpanWindowUpdate,
        span_update,
        span_update_window,
    )

    s = torch.ones((8, 32), device=dev)
    h = torch.zeros(128, device=dev)
    u = torch.rand((8, 128), device=dev)
    part = torch.zeros((8, 40), device=dev)
    ok = dict(uniforms=u)
    span_update.launches.clear()
    for args, kw in (
            ((part, h.cpu(), 1.0, s, 0, 10, 50), ok),  # h on the CPU
            ((part.cpu(), h, 1.0, s, 0, 10, 50), ok),  # partial on the CPU
            ((part, h, 1.0, s, 0, 10, 50), dict(uniforms=u.cpu())),  # uniforms on the CPU
            ((part, h, 1.0, s.double(), 0, 10, 50), ok),  # spin dtype
            ((part.half(), h, 1.0, s, 0, 10, 50), ok),  # partial dtype
            ((part.to(torch.int32), h, 1.0, s, 0, 10, 50), ok),  # int32 without a scale
            ((part, h, 1.0, s, 0, 10, 50), dict(ok, scale=torch.ones((), device=dev))),
            ((part[:, :30], h, 1.0, s, 0, 10, 50), ok),  # partial narrower than the span
            ((part, h, 1.0, s, 0, 10, 50), dict(seed=torch.tensor([1], device=dev,
                                                                   dtype=torch.int32))),
            ((part, h, 1.0, s, 64, 10, 50), ok),  # the window owns no column
            ((part, h, 1.0, s.t(), 0, 10, 50), ok),  # column-strided window
            ((part, h, torch.ones(3, device=dev), s, 0, 10, 50), ok),  # β rows
            ((part, h, 1.0, s, 0, 10, 50), dict(uniforms=u, delta_e=torch.zeros(8))),
    ):
        with pytest.raises(ValueError):
            span_update_window(*args, **kw)
    with pytest.raises(ValueError):  # h does not reach the span
        SpanWindowUpdate(s, 100, 1.0, h=h, uniforms=u)(None, 120, 140, 0)
    with pytest.raises(ValueError):  # the uniforms do not reach the span
        SpanWindowUpdate(s, 100, 1.0, h=torch.zeros(256, device=dev), uniforms=u)(None, 120,
                                                                                   140, 0)
    assert not span_update.launches


def test_graph_sharded_sweep_launches_once_per_owned_span(dev, ckpt):
    """Two gloo ranks on cuda:0 sweep the checkpoint's plan (int8, ΔE, fed
    uniforms): K4 launches once per (sweep, class span) a rank owns
    columns of, and the sweep equals the plain update on the same
    uniforms up to ΔE's summation order."""
    from image_generation_tpu_torch.ops.gibbs import class_spans
    from image_generation_tpu_torch.ops.gibbs_graph_sharded import gibbs_sweeps_graph_sharded
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    plan, _, (hp, a) = ckpt
    rng = np.random.default_rng(8)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (256, plan.n_pad)), dtype=torch.float32,
                      device=dev)
    u = torch.tensor(rng.random((3, 256, plan.n_pad), dtype=np.float32), device=dev)

    def rank(mesh):
        lo, hi = mesh.window(plan.n_pad)
        rows = quantize_coupling(a[lo:hi].contiguous(), mesh=mesh)
        return [gibbs_sweeps_graph_sharded(hp, rows, plan, s0[:, lo:hi].contiguous(), 3, mesh,
                                           uniforms=u, track_delta_e=True, use_kernel=k)
                for k in (True, False)]

    span_update.launches.clear()
    outs = _gloo_ranks(2, rank)
    owned = sum(max(start, g * plan.n_pad // 2) < min(stop, (g + 1) * plan.n_pad // 2)
                for g in range(2) for start, stop, _b0, _b1 in class_spans(plan))
    assert dict(span_update.launches) == {"K4f": 3 * owned}
    (k0, p0), (k1, p1) = outs
    assert torch.equal(torch.cat([k0[0], k1[0]], 1), torch.cat([p0[0], p1[0]], 1))
    assert bool(((k0[1] - p0[1]).abs() <= 1e-4 * (1 + p0[1].abs())).all())


def _gloo_ranks(n_ranks, fn):
    """``fn(mesh)`` on ``n_ranks`` threads, each a graph rank of a
    (1, n_ranks) mesh over its own gloo group (the CPU tests' harness)."""
    import threading
    import uuid
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.mesh import Mesh

    store, prefix = dist.HashStore(), uuid.uuid4().hex
    out, errors = [None] * n_ranks, []

    def work(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, n_ranks,
                                       timedelta(seconds=60))
            out[rank] = fn(Mesh((1, n_ranks), graph_index=rank, graph_group=pg,
                                backend="gloo"))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_two_rank_gloo_sweep_on_the_card(dev, ckpt, form):
    """Two gloo ranks on cuda:0 sweep the checkpoint's plan (|J| ≤ 1,
    per-chain β) through K4 with fed uniforms: the gathered chains follow
    the chain rule against the single-device plain sweep (blocks of one
    class are independent, so span and block updates agree up to the
    order of the sums), ΔE agrees on identical chains, and every rank
    launched K4; in Philox mode the two ranks' energies agree."""
    from image_generation_tpu_torch.ops.gibbs_graph_sharded import (
        gibbs_sweeps_graph_sharded,
        ising_energies_graph_sharded,
    )
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update
    from image_generation_tpu_torch.ops.gibbs import ising_energies
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    plan, _, (hp, a) = ckpt
    rng = np.random.default_rng(21)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (512, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((3, 512, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, 512), dtype=torch.float32, device=dev)
    whole = a.to(torch.bfloat16) if form == "bf16" else quantize_coupling(a)
    ref, de_ref = gibbs_sweeps_reference(hp, whole, plan, s0, 3, beta, uniforms=u,
                                         track_delta_e=True)
    span_update.launches.clear()

    def rank(mesh):
        lo, hi = mesh.window(plan.n_pad)
        rows = (a[lo:hi].to(torch.bfloat16) if form == "bf16"
                else quantize_coupling(a[lo:hi].contiguous(), mesh=mesh))
        mm = torch.bfloat16 if form == "bf16" else None
        out, de = gibbs_sweeps_graph_sharded(hp, rows, plan, s0[:, lo:hi].contiguous(), 3, mesh,
                                             beta, uniforms=u, track_delta_e=True,
                                             matmul_dtype=mm)
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        s_ph = gibbs_sweeps_graph_sharded(hp, rows, plan, s0[:, lo:hi].contiguous(), 2, mesh,
                                          generator=g, matmul_dtype=mm)
        e_ph = ising_energies_graph_sharded(hp, rows, s_ph, mesh, matmul_dtype=mm)
        torch.cuda.synchronize()
        return out, de, e_ph

    outs = _gloo_ranks(2, rank)
    got = torch.cat([o[0] for o in outs], 1)
    same = (got == ref).all(dim=1)
    assert float(same.float().mean()) >= CHAIN_RULE
    e_abs = ising_energies(hp, whole, ref).abs()[same]
    assert bool(((outs[0][1] - de_ref).abs()[same] <= 1e-3 * (1 + e_abs)).all())
    assert torch.equal(outs[0][1], outs[1][1]) and torch.equal(outs[0][2], outs[1][2])
    assert bool(torch.isfinite(outs[0][2]).all())
    assert span_update.launches["K4f"] > 0 and span_update.launches["K4"] > 0


# ---------------------------------------------------------------------------
# the sampler backends (samplers/) on the card
# ---------------------------------------------------------------------------

def test_sampler_backends_sweep_through_the_gather(dev):
    """``GibbsSampler`` and ``PTSampler`` on CUDA tensors launch the gather
    (K1-f32, K1-f32-dE), never a plain version, at the exact sweep count:
    fed the same chains and uniforms, GibbsSampler's spins equal the
    gather's plain version run on the CPU (no chain differing) at the
    serving shape (256 reads x 80 sweeps, and 3 sweeps, odd)."""
    from image_generation_tpu_torch.samplers import GibbsSampler, PTSampler

    _, params, graph, _, _ = load_model_dir(MODEL, dev)
    h, j = scaled_ising(params, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    plan = build_plan(graph)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    for sweeps in (80, 3):
        init = random_spins(g, plan, 256, dev)
        u = torch.rand((sweeps, 256, plan.n_pad), generator=g, device=dev)
        gibbs_cuda.gibbs_sweeps_cuda.launches.clear()
        ours = GibbsSampler(n_sweeps=sweeps).sample(h, j, graph, 256, g, init_spins=init,
                                                    uniforms=u)
        assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == {"K1-f32": 1}
        hp, a = permuted_model(plan, h.cpu(), j.cpu())
        ref = gibbs_sweeps_sparse_reference(hp, a, plan, init.cpu(), sweeps, uniforms=u.cpu())
        assert (ours.spins == to_original(plan, ref).numpy()).all()
    gibbs_cuda.gibbs_sweeps_cuda.launches.clear()
    ss = PTSampler(n_rounds=5, sweeps_per_round=16).sample(h, j, graph, 256, g)
    assert dict(gibbs_cuda.gibbs_sweeps_cuda.launches) == {"K1-f32-dE": 5}
    assert ss.spins.shape == (256, graph.n) and np.isfinite(ss.energies).all()


# ---------------------------------------------------------------------------
# the column-sharded dense layer on the card, 4 gloo processes
# ---------------------------------------------------------------------------

def _dense_rank(rank: int, port: int, out_dir: str) -> None:
    """One of 4 gloo processes on cuda:0, a (2, 2) mesh: Linear(256 →
    1024) column-sharded, this rank's data slice of 16 rows through it
    (f32 and bf16 autocast), forward and backward; writes the outputs,
    the gathered weight gradient, the input and bias gradients."""
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.dense import (
        rows_split_over_data,
        shard_large_dense,
    )
    from image_generation_tpu_torch.parallel.mesh import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=4,
                            rank=rank, timeout=timedelta(seconds=120))
    try:
        mesh = create_mesh(shape=(2, 2), backend="gloo")
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            torch.manual_seed(0)
            layer = torch.nn.Sequential(torch.nn.Linear(256, 1024)).cuda()
            x = torch.randn(16, 256, device="cuda")
            dy = torch.randn(16, 1024, device="cuda")
            shard_large_dense(layer, mesh, 1)
            lo = mesh.data_index * 8
            xl = x[lo:lo + 8].clone().requires_grad_(True)
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
                with rows_split_over_data():
                    y = layer(xl)
            (y.float() * dy[lo:lo + 8]).sum().backward()
            w = layer[0].weight
            out[str(dtype)] = dict(
                y=y.detach().float().cpu(), dx=xl.grad.cpu(), y_dtype=str(y.dtype),
                dw=w.column_shard.gather(w.grad).cpu(),
                db=mesh.all_reduce(layer[0].bias.grad.clone(), axis="data").cpu(),
                rows=w.shape[0])
        torch.save(out, f"{out_dir}/rank_{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_column_sharded_layer_on_the_card_under_4_gloo_processes(dev, tmp_path):
    """The sharded layer's forward and backward on CUDA tensors, 4
    processes on a (2, 2) gloo mesh, against the replicated ``nn.Linear``
    on the same inputs: f32 within 1e-5 (relative to the largest entry),
    bf16 autocast (bf16 out, as autocast's linear) within 2e-2."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_dense_rank, args=(port, str(tmp_path)), nprocs=4, join=True,
                       start_method="spawn")
    ranks = [torch.load(tmp_path / f"rank_{r}.pt") for r in range(4)]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        torch.manual_seed(0)
        ref = torch.nn.Linear(256, 1024).cuda()
        x = torch.randn(16, 256, device="cuda", requires_grad=True)
        dy = torch.randn(16, 1024, device="cuda")
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
            y = ref(x)
        (y.float() * dy).sum().backward()
        for r, res in enumerate(ranks):
            got = res[str(dtype)]
            lo = (r // 2) * 8
            assert got["rows"] == 256 and got["y_dtype"] == str(y.dtype)
            for name, a, b in (("y", got["y"], y.detach().float()[lo:lo + 8]),
                               ("dx", got["dx"], x.grad[lo:lo + 8]),
                               ("dw", got["dw"], ref.weight.grad), ("db", got["db"], ref.bias.grad)):
                b = b.cpu()
                assert float((a - b).abs().max()) <= tol * float(b.abs().max()), (dtype, name, r)
