"""Kernels K1 (f32, bf16, int8), K2 and K3 on the card: the CUDA sweep
kernels against their plain versions.

These tests need a CUDA device and ``nvcc``; without a card they skip.
This file imports no JAX, so on the GPU machine (which has none) it runs
without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: K1 and the plain version sum the fields in another order and
compute the sigmoid with different code, so they differ by about an ulp;
a draw whose uniform falls within that ulp of its probability flips
(probability ~1e-7 per draw) and its chain then diverges.  So the rule is
that at least 98% of the chains come out bit-identical.  On identical
chains ΔE agrees within 1e-4 (checkpoint model) or 1e-3·(1 + |E|)
(|J| ≤ 1); on integer-valued couplings every sum is exact, so the packed
kernel K3 equals the dense K2 bit for bit.
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
    gibbs_sweeps_reference,
    permuted_model,
    random_spins,
    to_original,
)

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


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("chains", [256, 512, 1024, 2048, 4096, 2050, 37])
def test_fed_kernel_matches_plain(dev, ckpt, strong, chains):
    """At the default R of every serving group size (256·k chains: R = 1,
    1, 2, 4, 8), at a chain count whose last thread block is partial
    (2050, R = 4) and at one below a full grid (37, R = 1)."""
    plan, model, strong_model = ckpt
    hp, a = strong_model if strong else model
    rng = np.random.default_rng(chains)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
    s_in = s0.clone()
    out = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, beta, uniforms=u)
    ref = gibbs_sweeps_reference(hp, a, plan, s0, 16, beta, uniforms=u)
    torch.cuda.synchronize()
    assert _identical(out, ref) >= CHAIN_RULE
    assert torch.equal(s0, s_in)  # the input is left as it was


def _ladder_beta(chains, dev):
    """Per-chain β as parallel tempering passes it: the default 8-rung
    geometric ladder over [0.25, 1], each rung repeated over its chains."""
    rungs = torch.tensor(np.geomspace(0.25, 1.0, 8), dtype=torch.float32, device=dev)
    return rungs.repeat_interleave(chains // 8)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("chains", [256, 2048])
def test_delta_e_matches_plain(dev, ckpt, strong, chains):
    """K1-ΔE, fed uniforms: spins under the chain rule, and on identical
    chains ΔE within 1e-4 (checkpoint model) or 1e-3·(1 + |E|) (|J| ≤ 1);
    256 chains at β = 1, 2,048 at the 8-rung ladder's per-chain β."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies

    plan, model, strong_model = ckpt
    hp, a = strong_model if strong else model
    rng = np.random.default_rng(chains + 1)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((16, chains, plan.n_pad), dtype=np.float32), device=dev)
    beta = 1.0 if chains == 256 else _ladder_beta(chains, dev)
    out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 16, beta, uniforms=u, track_delta_e=True)
    ref, de_ref = gibbs_sweeps_reference(hp, a, plan, s0, 16, beta, uniforms=u, track_delta_e=True)
    torch.cuda.synchronize()
    same = (out == ref).all(dim=1)
    assert float(same.float().mean()) >= CHAIN_RULE
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
    ref = gibbs_sweeps_reference(hp, a, plan, s0, 4, uniforms=u)
    assert _identical(out, ref) >= CHAIN_RULE


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

    return a.to(torch.bfloat16) if form == "bf16" else quantize_coupling(a)


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


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("chains", [256, 1030, 37])
def test_k1_modes_match_plain(dev, ckpt, plan2k, form, chains, track):
    """K1-bf16 / K1-int8 (and their ΔE modes) against the plain version,
    fed uniforms and per-chain β, on the checkpoint's plan and the
    2,048-latent plan, at every R; chains by the chain rule, ΔE within
    1e-3·(1 + |E|) on identical chains."""
    from image_generation_tpu_torch.ops.gibbs import gibbs_sweeps_kernel_reference, ising_energies

    for plan, (hp, a) in ((ckpt[0], ckpt[2]), plan2k):
        coupling = _k1_coupling(a, form)
        rng = np.random.default_rng(chains)
        s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32,
                          device=dev)
        u = torch.tensor(rng.random((3, chains, plan.n_pad), dtype=np.float32), device=dev)
        beta = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
        ref = gibbs_sweeps_kernel_reference(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                            track_delta_e=track)
        for rows in (None, 1, 2, 4, 8):
            out = gibbs_cuda.gibbs_sweeps_cuda(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                               track_delta_e=track, _rows_per_block=rows)
            torch.cuda.synchronize()
            if not track:
                assert _identical(out, ref) >= CHAIN_RULE
                continue
            same = (out[0] == ref[0]).all(dim=1)
            assert float(same.float().mean()) >= CHAIN_RULE
            e_abs = ising_energies(hp, coupling, ref[0]).abs()[same]
            assert bool(((out[1] - ref[1]).abs()[same] <= 1e-3 * (1 + e_abs)).all())


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_k1_modes_philox_match_numpy_twin(dev, plan2k, form):
    """Philox mode against the plain version fed ``philox_uniforms``, and
    ΔE against the f64 energy change of the model the mode samples."""
    from image_generation_tpu_torch.ops.gibbs import gibbs_sweeps_kernel_reference
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
    ref = gibbs_sweeps_kernel_reference(hp, coupling, plan, s0, 4, uniforms=u)
    assert _identical(out, ref) >= CHAIN_RULE
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
    wide, so a block takes several 128-column passes), |J| ≤ 1, per-chain
    β, 1,030 chains (R = 4, a partial last block at R = 8), 3 sweeps run
    as 4."""
    from image_generation_tpu_torch.ops.gibbs import ising_energies
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
        gibbs_sweeps_hbm_cuda,
        gibbs_sweeps_hbm_reference,
    )

    plan, _, (hp, a) = ckpt
    coupling = _stream_coupling(a, form, chunk, plan)
    rng = np.random.default_rng(7)
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (1030, plan.n_pad)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.random((4, 1030, plan.n_pad), dtype=np.float32), device=dev)
    beta = torch.tensor(rng.uniform(0.5, 2.0, 1030), dtype=torch.float32, device=dev)
    ref = gibbs_sweeps_hbm_reference(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                     track_delta_e=track)
    for rows in (None, 8, 1):
        out = gibbs_sweeps_hbm_cuda(hp, coupling, plan, s0, 3, beta, uniforms=u,
                                    track_delta_e=track, _rows_per_block=rows)
        torch.cuda.synchronize()
        if not track:
            assert _identical(out, ref) >= CHAIN_RULE
            continue
        same = (out[0] == ref[0]).all(dim=1)
        assert float(same.float().mean()) >= CHAIN_RULE
        e_abs = ising_energies(hp, coupling, ref[0]).abs()[same]
        assert bool(((out[1] - ref[1]).abs()[same] <= 1e-3 * (1 + e_abs)).all())


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
    """Philox mode of K3 against its plain version fed ``philox_uniforms``
    for the even sweep count, and ΔE against the f64 energy change."""
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
