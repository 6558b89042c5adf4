"""Int8 serving: the port's sampler call against the benchmark's plain int8
reference (``portbench/reference/serve_int8.py``), the reference's
quantization by hand, and the sampler model's span and counter.  CPU only,
small sizes, a few seconds.

The served sampler of a model of 2,048 latents or more stores its coupling
as int8 and, packed into block-sparse panels, sweeps through K3; on the
CPU the same call runs the gather's plain version.  Its fields are exact
integer sums, as are the reference's, so on fed uniforms the two give the
same spins.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.torch_pth import grbm_from_jax
from image_generation_tpu_torch.ops.quant import QuantCoupling
from image_generation_tpu_torch.training import step
from image_generation_tpu_torch.training.observability import span, stretch_spans
from image_generation_tpu_torch.training.step import SampleFns, make_sample_fns

BENCH = Path(__file__).resolve().parent.parent / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import gibbs as ref_gibbs  # noqa: E402
from reference.plan import build_plan as ref_build_plan  # noqa: E402
from reference.serve_int8 import int8_sweeps, quantize  # noqa: E402

N, CHAINS, SWEEPS = 160, 64, 4  # K3 runs an even count of sweeps
PREFACTOR = 0.05


@pytest.fixture(scope="module")
def model():
    """The first ``N`` qubits of the scaled configuration's Pegasus P16
    fabric with the edges among them, and random GRBM weights whose
    prefactor-scaled fields and couplings have a deviation of 0.3 (strong
    enough that every sweep's decisions follow them)."""
    with np.load(BENCH / "configs" / "scaled.graph.npz") as z:
        ei, ej = z["edge_i"].astype(np.int64), z["edge_j"].astype(np.int64)
    keep = (ei < N) & (ej < N)
    ei, ej = ei[keep], ej[keep]
    rng = np.random.default_rng(22)
    linear = rng.normal(0.0, 0.3, N) / PREFACTOR
    quadratic = rng.normal(0.0, 0.3, len(ei)) / PREFACTOR
    params, graph = grbm_from_jax(linear, quadratic, ei, ej)
    return params, graph, ei, ej, rng


def _fns(graph) -> SampleFns:
    cfg = TrainingConfig(N_LATENTS=N, NUM_READS=CHAINS, SAMPLER="gibbs",
                         SAMPLER_MATMUL_DTYPE="int8", SWEEP_BLOCK_SPARSE="on",
                         PREFACTOR=PREFACTOR)
    return make_sample_fns(cfg, graph, device="cpu")


def _reference(params, ei, ej, s0, u):
    """The reference's spins (original order) of chains ``s0`` under ``u``."""
    plan = ref_build_plan(N, ei, ej)
    h = torch.clamp(PREFACTOR * params.linear, -4.0, 4.0)
    j = torch.clamp(PREFACTOR * params.quadratic, -1.0, 1.0)
    hp, jp = ref_gibbs.permuted_model(plan, h, ei, ej, j)
    jq, scale = quantize(jp)
    s = int8_sweeps(plan, hp, jq, scale, s0, SWEEPS, uniforms=u)
    return s[:, torch.as_tensor(plan.orig_to_perm)], plan


def _draws(fns, rng):
    n_pad = fns.plan.n_pad
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (CHAINS, n_pad)), dtype=torch.float32)
    u = torch.tensor(rng.random((SWEEPS, CHAINS, n_pad)), dtype=torch.float32)
    return s0, u


def test_sample_fn_equals_the_int8_reference(model):
    """``sample_fn`` (int8 panels, K3's plain version) on fed uniforms
    gives the reference's spins exactly, in the same columns."""
    params, graph, ei, ej, rng = model
    fns = _fns(graph)
    assert fns.sampler_impl == "cuda_hbm+int8+bs" and fns.stored_form == "int8+bs"
    s0, u = _draws(fns, rng)
    got = fns.sample_fn(None, params, CHAINS, SWEEPS, init_spins=s0, uniforms=u)
    want, plan = _reference(params, ei, ej, s0, u)
    assert np.array_equal(plan.orig_to_perm, fns.plan.orig_to_perm)
    assert torch.equal(got, want)
    assert 0.2 < float((got != s0[:, torch.as_tensor(plan.orig_to_perm)]).float().mean()) < 0.8


def test_four_bit_control_fails_the_comparison(model, monkeypatch):
    """The same call with the coupling on 15 levels (4 bits) in place of
    int8's 255: its spins are not the reference's."""
    params, graph, ei, ej, rng = model

    def four_bit(a, mesh=None):
        amax = a.abs().max()
        scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
        return QuantCoupling(q=torch.round(a / scale).clamp(-7, 7).to(torch.int8), scale=scale)

    monkeypatch.setattr(step, "quantize_coupling", four_bit)
    fns = _fns(graph)
    s0, u = _draws(fns, rng)
    got = fns.sample_fn(None, params, CHAINS, SWEEPS, init_spins=s0, uniforms=u)
    want, _ = _reference(params, ei, ej, s0, u)
    assert float((got != want).float().mean()) > 1e-3


@pytest.mark.parametrize("a,q,scale", [
    # max|A| 127: scale 1, so A / scale is A and the ties show
    ([[0.0, 2.5, -2.5], [2.5, 127.0, 3.5], [-2.5, 3.5, -0.5]],
     [[0, 2, -2], [2, 127, 4], [-2, 4, 0]], 1.0),
    # max|A| 0.254: scale 0.002; 0.001 is half a level, to even (0)
    ([[0.254, -0.001], [-0.001, 0.003]], [[127, 0], [0, 2]], 0.002),
    ([[0.0, 0.0], [0.0, 0.0]], [[0, 0], [0, 0]], 1.0),  # a zero matrix: scale 1
])
def test_reference_quantization_by_hand(a, q, scale):
    got_q, got_scale = quantize(torch.tensor(a))
    assert torch.equal(got_q, torch.tensor(q, dtype=torch.float32))
    assert float(got_scale) == pytest.approx(scale, rel=1e-6)


def test_sampler_build_span_and_counter(model):
    """``sampler.build`` is recorded inside ``sample_fn`` under a profiler
    (with ``n_pad`` and the stored form) and not without one; the counter
    counts one build a call and the stored panels' bytes."""
    params, graph, _ei, _ej, rng = model
    fns = _fns(graph)
    s0, u = _draws(fns, rng)
    before = dict(SampleFns.sampler_model)
    fns.sample_fn(None, params, CHAINS, SWEEPS, init_spins=s0, uniforms=u)
    assert SampleFns.sampler_model["builds"] == before.get("builds", 0) + 1
    _hp, coupling = fns.build_sampler_model(params)
    assert (SampleFns.sampler_model["bytes"] - before.get("bytes", 0)
            == 2 * (coupling.panels.numel() + 4))
    with span("off"):  # the profiled stretch below starts a table of its own
        pass
    with torch_profile(activities=[ProfilerActivity.CPU]):
        fns.sample_fn(None, params, CHAINS, SWEEPS, init_spins=s0, uniforms=u)
    recs = [r for r in stretch_spans() if r["name"] == "sampler.build"]
    assert len(recs) == 1
    assert recs[0]["ids"] == {"n_pad": fns.plan.n_pad, "form": "int8+bs"}
    assert recs[0]["device_ms"] > 0
    # a stretch that holds only a marker, then a call with no profiler
    with span("off"):
        pass
    with torch_profile(activities=[ProfilerActivity.CPU]):
        with span("marker"):
            pass
    fns.sample_fn(None, params, CHAINS, SWEEPS, init_spins=s0, uniforms=u)
    assert [r["name"] for r in stretch_spans()] == ["marker"]
