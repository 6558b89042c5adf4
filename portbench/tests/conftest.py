"""Fixtures of the benchmark's CPU tests.

Run them from the repository's root: ``python -m pytest portbench/tests -q``.
Tests marked ``gpu`` need a CUDA card and skip without one; on the card:
``python -m pytest portbench/tests -q -m gpu``.

``tiny_root`` is a benchmark root in a temporary directory that holds
everything the harness finds by name (a manifest, small configurations of
both kinds, their traffic, limits and the drivers and readers), so a
rehearsal drives a whole run on the CPU through the program's plain paths.
``philox_on_cpu`` makes those plain paths draw their uniforms as the
card's kernels do (a seed from the caller's generator, then Philox),
which is what the reference replays.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

# PREFACTOR 50 gives the fresh Boltzmann machine couplings of about 0.5, as
# strong as a trained one's, so that a sweep's precision shows at this size
TINY_TRAIN = dict(QPU="Advantage2_prototype", N_LATENTS=32, NUM_READS=8, BATCH_SIZE=16,
                  PREFACTOR=50.0,
                  N_REPLICAS=2, SAMPLER="pt", PT_NUM_BETAS=4, PT_BETA_MIN=0.2, GIBBS_SWEEPS=2,
                  GIBBS_BURN_IN=2, SAMPLER_MATMUL_DTYPE="bfloat16")
TINY_SERVE = dict(QPU="Advantage2_prototype", N_LATENTS=32, NUM_READS=8, SAMPLER="gibbs",
                  GIBBS_SWEEPS=2, GIBBS_BURN_IN=4, SAMPLER_MATMUL_DTYPE="float32")
GRAPH_SEED = 775321899904


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def philox_on_cpu(monkeypatch):
    install_philox(monkeypatch.setattr)


def install_philox(setattr_):
    """The plain sweeps on the CPU fed the uniforms the card's kernel would
    draw: the Philox seed from the caller's generator, then the numpy twin
    of the in-kernel generator (``gibbs_cuda.philox_uniforms``)."""
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda, gibbs_sparse

    inner = gibbs_sparse.gibbs_sweeps_sparse

    def sweeps(hp, coupling_p, plan, spins_p, n_sweeps, beta=1.0, *, generator=None,
               uniforms=None, track_delta_e=False, count=None, _shape=None):
        if uniforms is None:
            seed = int(gibbs_cuda.draw_seed(generator, spins_p.device))
            uniforms = torch.from_numpy(gibbs_cuda.philox_uniforms(
                seed, n_sweeps, spins_p.shape[0], plan.n_pad))
        if count is not None:
            count[0][count[1]] += 1
        return inner(hp, coupling_p, plan, spins_p, n_sweeps, beta, generator=generator,
                     uniforms=uniforms, track_delta_e=track_delta_e)

    setattr_(gibbs_cuda, "gibbs_sweeps_sparse", sweeps)
    setattr_(gibbs_hbm_cuda, "gibbs_sweeps_sparse", sweeps)


def _settings(overrides: dict) -> dict:
    base = json.loads((BENCH / "configs" / "flagship.json").read_text())["training"]
    return dict(base, **overrides)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A benchmark root with a tiny training cell and a tiny serving cell."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    root = tmp_path_factory.mktemp("bench")
    for d in ("drivers", "metrics"):
        shutil.copytree(BENCH / d, root / d)
    for d in ("configs", "traffic", "checks"):
        (root / d).mkdir()
    graph, _ = cached_latent_graph("Advantage2_prototype", 32, GRAPH_SEED)
    np.savez(root / "configs" / "tiny.graph.npz", n=graph.n, edge_i=graph.edge_i,
             edge_j=graph.edge_j)
    train = _settings(TINY_TRAIN)
    serve = _settings(TINY_SERVE)
    # a served model: a tiny one trained one epoch here
    cfg = TrainingConfig(RANDOM_SEED=GRAPH_SEED, **dict(serve, BATCH_SIZE=16))
    tr = Trainer(cfg, device="cpu", seed=3, mesh=None)
    tr.images = (torch.rand((64, 32, 32, 1), generator=torch.Generator().manual_seed(0))
                 < 0.13).float()
    tr.train(1)
    # couplings as strong as a trained model's, and a decoder whose images
    # follow its spins as a trained one's do, so that a sweep's precision shows
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        tr.grbm_params.linear.copy_(10.0 * torch.randn(graph.n, generator=g))
        tr.grbm_params.quadratic.copy_(20.0 * torch.randn(graph.n_edges, generator=g))
        tr.dvae._decoder.increase_latent_dim.weight.mul_(30.0)
    tr.save(root / "checkpoints" / "tiny")
    configs = {
        "tiny_train": {"training": train, "graph_seed": GRAPH_SEED,
                       "graph": "configs/tiny.graph.npz", "dataset_size": 64, "ink": 0.13},
        "tiny_serve": {"training": dict(serve, BATCH_SIZE=16), "graph_seed": GRAPH_SEED,
                       "graph": "configs/tiny.graph.npz", "checkpoint": "checkpoints/tiny",
                       "dataset_size": 64, "ink": 0.13},
    }
    for name, c in configs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    traffic = {
        "tiny_epochs": {"driver": "train_epochs", "schedule_epochs": 3, "checked_steps": 3,
                        "trace_skip_s": 0.2, "trace_s": 0.3},
        "tiny_c4": {"driver": "serve_closed_loop", "clients": 4, "max_batch": 4,
                    "window_ms": 2, "sharpen": False, "kept_per_client": 2,
                    "warm_s": 0.3, "trace_skip_s": 0.2, "trace_s": 0.3},
    }
    for name, t in traffic.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    # the rehearsal's program and reference both run f32 on the CPU: each
    # limit is a few times the round-off they differ by
    limits = {"tiny-gibbs-train": {"loss_gap": 1e-4, "grad_gap": None, "update_gap": 1e-2,
                                   "chain_mismatch": 0.0, "graph_mismatch": 0.0},
              "tiny-train": {"loss_gap": 1e-4, "grad_gap": None, "update_gap": 1e-2,
                             "chain_mismatch": 0.0, "energy_gap": 1e-4, "graph_mismatch": 0.0},
              "tiny-serve": {"changed_images": 0.0, "unanswered": 0.0}}
    for name, lim in limits.items():
        (root / "checks" / f"{name}.json").write_text(json.dumps(lim))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["workloads"] = [
        {"name": "tiny-train", "config": "tiny_train", "traffic": "tiny_epochs", "chips": 1,
         "why": "a rehearsal"},
        {"name": "tiny-serve", "config": "tiny_serve", "traffic": "tiny_c4", "chips": 1,
         "why": "a rehearsal"},
        {"name": "tiny-gibbs-train", "config": "tiny_serve", "traffic": "tiny_epochs",
         "chips": 1, "why": "a rehearsal of plain Gibbs training"},
    ]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = sorted({c for w in m["workloads"]
                                     for c in (["tiny-train", "tiny-gibbs-train"]
                                               if "train" in w
                                               else ["tiny-serve"])})
    (root / "manifest.json").write_text(json.dumps(manifest))
    return root


def make_run(root: Path, workload: str, seed: int = 11, seconds: float = 1.0,
             trace: bool = False):
    from core import Run

    run = Run(json.loads((root / "manifest.json").read_text()), workload, seed, seconds,
              trace, root=root)
    run.device = "cpu"
    return run
