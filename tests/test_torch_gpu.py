"""Kernel K1 on the card: the CUDA sweep kernel against its plain version.

These tests need a CUDA device and ``nvcc``; without a card they skip.
This file imports no JAX, so on the GPU machine (which has none) it runs
without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance: K1 and the plain version sum the fields in another order and
compute the sigmoid with different code, so they differ by about an ulp;
a draw whose uniform falls within that ulp of its probability flips
(probability ~1e-7 per draw) and its chain then diverges.  So the rule is
that at least 98% of the chains come out bit-identical.
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
    plan, (hp, a), _ = ckpt
    s0 = torch.ones((32, plan.n_pad), device=dev)
    n0 = gibbs_cuda.gibbs_sweeps_cuda.launches
    gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 1)
    assert gibbs_cuda.gibbs_sweeps_cuda.launches == n0 + 1
    with pytest.raises(TypeError):
        gibbs_cuda.gibbs_sweeps_cuda(hp, a.to(torch.bfloat16), plan, s0, 1)
    with pytest.raises(ValueError):
        gibbs_cuda.gibbs_sweeps_cuda(hp, a.t(), plan, s0, 1)
    with pytest.raises(NotImplementedError):
        gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s0, 1, track_delta_e=True)
    assert gibbs_cuda.gibbs_sweeps_cuda.launches == n0 + 1


def test_warm_server_runs_through_kernel(dev, tmp_path):
    from image_generation_tpu_torch.app.warm import WarmGenerator

    w = WarmGenerator(tmp_path, config_overrides={"NUM_READS": 16, "GIBBS_BURN_IN": 4},
                      device=dev)
    n0 = gibbs_cuda.gibbs_sweeps_cuda.launches
    out = w.serve(MODEL)
    assert gibbs_cuda.gibbs_sweeps_cuda.launches == n0 + 1
    assert w._trainer.fns.sampler_impl == "cuda_gibbs"
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
