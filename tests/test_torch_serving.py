"""Port parity: the warm serving slice end to end, on the CPU.

The JAX side is composed by hand from its own parts: ``scaled_ising`` →
``permuted_model`` → ``gibbs_sweeps_pallas`` (interpret mode, fed
uniforms) → ``to_original`` → f32 decode → clip → uint8.  The port runs
``sample_fn(..., init_spins, uniforms)`` and its decode.  Tolerance: the
chain rule of tests/test_torch_gibbs.py (≥ 98% of chains bit-identical),
and on identical chains at most 0.1% of pixels one uint8 level apart (the
decode's f32 sums are ordered differently).
"""

import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.io.checkpoint import load_model_dir as jax_load_model_dir
from image_generation_tpu.models.dvae import DVAE as JaxDVAE
from image_generation_tpu.models.grbm import scaled_ising as jax_scaled_ising
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops.gibbs_pallas import gibbs_sweeps_pallas
from image_generation_tpu_torch.app.warm import WarmGenerator, _Coalescer, _Request
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models.dvae import DVAE
from image_generation_tpu_torch.training.step import make_sample_fns
from image_generation_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
MODEL = ROOT / "runs" / "models" / "tpu_digits_40_epochs"
SMALL = dict(NUM_READS=16, GIBBS_BURN_IN=4)


@pytest.fixture(scope="module")
def trainer():
    t = Trainer(config=TrainingConfig(COMPUTE_DTYPE="float32"), device="cpu", seed=0)
    t.load(MODEL)
    return t


def _uint8(x):
    return np.round(np.clip(np.asarray(x), 0.0, 1.0) * 255.0).astype(np.uint8)


def test_slice_matches_jax_composition(trainer):
    chains, sweeps = 32, 8
    params, stats, jgp, jg, _, _ = jax_load_model_dir(MODEL)
    jplan = jgibbs.build_plan(jg)
    rng = np.random.default_rng(2)
    s0 = rng.choice([-1.0, 1.0], (chains, jplan.n_pad)).astype(np.float32)
    u = rng.random((sweeps, chains, jplan.n_pad), dtype=np.float32)

    h, j = jax_scaled_ising(jgp, 0.05, (-4.0, 4.0), (-1.0, 1.0))
    hp, a = jgibbs.permuted_model(jplan, h, j)
    out = gibbs_sweeps_pallas(jax.random.PRNGKey(0), hp, a, jplan, jnp.asarray(s0), sweeps,
                              interpret=True, uniforms=jnp.asarray(u))
    jspins = jgibbs.to_original(jplan, out)
    jimg = JaxDVAE(n_latents=256).apply(
        {"params": params, "batch_stats": stats}, jspins[:, None, :], method="decode")[:, 0]
    ref_spins, ref8 = np.asarray(jspins), _uint8(jimg)

    with torch.no_grad():
        spins = trainer.fns.sample_fn(None, trainer.grbm_params, chains, sweeps,
                                      init_spins=torch.from_numpy(s0),
                                      uniforms=torch.from_numpy(u))
        img = trainer.dvae.decode(spins[:, None, :])[:, 0]
    ours8 = _uint8(img.numpy())
    assert ours8.shape == (chains, 32, 32, 1)
    same = (spins.numpy() == ref_spins).all(axis=1)
    assert same.mean() >= 0.98
    diff = np.abs(ours8.astype(int) - ref8.astype(int))[same]
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_trainer_samples_spins(trainer):
    s = trainer.sample_spins(num_reads=8, n_sweeps=2)
    assert s.shape == (8, 256) and set(s.unique().tolist()) <= {-1.0, 1.0}
    assert trainer.fns.sampler_impl == "cuda_vmem"  # K1; its plain version on the CPU
    assert trainer.plan.n_pad == 640 and trainer.config.N_LATENTS == 256
    # fresh generator per call, so two calls differ; the same seed repeats
    t2 = Trainer(config=trainer.config, device="cpu", seed=0)
    t2.load(MODEL)
    t3 = Trainer(config=trainer.config, device="cpu", seed=0)
    t3.load(MODEL)
    a, b = t2.sample_spins(8, 2), t3.sample_spins(8, 2)
    assert torch.equal(a, b) and not torch.equal(a, t2.sample_spins(8, 2))


@pytest.mark.parametrize("overrides,missing", [
    pytest.param({"GRAPH_SHARDED": "on"}, "mesh", id="overrides4-mesh"),
])
def test_unported_sampler_paths_raise(trainer, overrides, missing):
    """The graph-sharded sampler on a (2, 2) mesh: the graph axis splits
    the coupling, the data axis the chain rows (the JAX layout); a mesh
    whose data axis has no process group is refused."""
    from image_generation_tpu_torch.parallel.mesh import Mesh

    del missing  # the graph-sharded path needs a mesh; it now runs on one with a data axis
    with pytest.raises(ValueError, match="data axis of size > 1 needs its process group"):
        Mesh((2, 2), graph_group=object())
    fns = make_sample_fns(TrainingConfig(**overrides), trainer.graph, trainer.plan, device="cpu",
                          mesh=Mesh((2, 2), data_index=1, graph_group=object(),
                                    data_group=object(), world_group=object()))
    assert fns.graph_sharded and fns.sampler_impl == "torch_graph_sharded+plrng"
    assert fns.train_rows.axes == ("data",) and fns.train_rows.index == 1


def test_unresolved_auto_ladder_is_refused(trainer):
    """``PT_NUM_BETAS="auto"`` is resolved by the Trainer (a ladder probe);
    the sampler functions refuse it unresolved, as the JAX package's do."""
    with pytest.raises(ValueError, match="resolved"):
        make_sample_fns(TrainingConfig(SAMPLER="pt", PT_NUM_BETAS="auto"), trainer.graph,
                        trainer.plan, device="cpu")


@pytest.mark.parametrize("dtype,impl", [("int8", "cuda_vmem+int8"), ("bfloat16", "cuda_vmem")])
def test_k1_modes_serve_the_checkpoint(trainer, dtype, impl):
    """On the 640-wide plan the JAX package sends a bf16 or int8 coupling
    to its on-chip kernel: the port serves the checkpoint through K1-bf16 /
    K1-int8 (on the CPU, their plain version), ±1 spins in original order."""
    fns = make_sample_fns(TrainingConfig(SAMPLER_MATMUL_DTYPE=dtype), trainer.graph, trainer.plan,
                          device="cpu")
    assert fns.sampler_impl == impl
    spins = fns.sample_fn(torch.Generator().manual_seed(0), trainer.grbm_params, 8, 4)
    assert spins.shape == (8, trainer.graph.n) and set(spins.unique().tolist()) <= {-1.0, 1.0}


def test_block_sparse_on_builds_the_packed_streaming_path(trainer):
    """``SWEEP_BLOCK_SPARSE="on"`` packs the coupling and streams it (K3),
    as the JAX package's ``pallas_hbm+bs``; the sampler draws ±1 spins."""
    from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling

    fns = make_sample_fns(TrainingConfig(SWEEP_BLOCK_SPARSE="on"), trainer.graph, trainer.plan,
                          device="cpu")
    assert fns.sampler_impl == "cuda_hbm+bs"
    _, coupling = fns.build_sampler_model(trainer.grbm_params)
    assert isinstance(coupling, BlockSparseCoupling) and coupling.panels.dtype == torch.float32
    s = fns.sample_fn(torch.Generator().manual_seed(0), trainer.grbm_params, 8, 3)
    assert s.shape == (8, 256) and set(s.unique().tolist()) <= {-1.0, 1.0}


def test_use_pallas_off_selects_plain_version(trainer):
    fns = make_sample_fns(TrainingConfig(USE_PALLAS="off"), trainer.graph, trainer.plan,
                          device="cpu")
    assert fns.sampler_impl == "torch" and not fns.use_kernel
    assert make_sample_fns(TrainingConfig(), trainer.graph, trainer.plan, device="cpu").use_kernel


def test_warm_serve_coalesces_concurrent_requests(tmp_path):
    w = WarmGenerator(tmp_path, config_overrides=SMALL, device="cpu", serve_window_ms=200)
    results, errors = [None] * 4, []

    def call(i):
        try:
            results[i] = w.serve(MODEL)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert w.stats["served"] == 4 and w.stats["dispatches"] < 4
    for r in results:
        img = r["images"]
        assert img.shape == (16, 32, 32, 1) and img.dtype == np.float32
        assert img.min() >= 0.0 and img.max() <= 1.0
        assert r["grid"].shape == (36, 546, 1) and r["batched"] >= 1
    # requests sharing a dispatch own distinct chains
    assert not np.array_equal(results[0]["images"], results[1]["images"])


def test_warm_buckets_and_sharpen(tmp_path):
    w = WarmGenerator(tmp_path, config_overrides=SMALL, device="cpu")
    assert w.warm_buckets(MODEL, 3) == [1, 2, 3]
    capped = WarmGenerator(tmp_path, config_overrides=SMALL, device="cpu", serve_max_batch=2)
    assert capped.warm_buckets(MODEL, 5) == [1, 2]  # never past the coalescer's max_batch
    out = w.serve(MODEL, sharpen=True)["images"]
    mid = (out > 0) & (out < 1)
    assert ((out[mid] >= 0.4) & (out[mid] <= 0.6)).all()
    assert w._trainer.config.NUM_READS == 16 and w.stats["dispatches"] == 1


def test_coalescer_groups_are_not_mixed_and_capped():
    seen = []

    def run_group(group):
        seen.append({r.group for r in group})
        assert len(group) <= 3
        for r in group:
            r.result = r.group

    c = _Coalescer(run_group, max_batch=3)
    reqs = [_Request("m1" if i % 2 else "m2") for i in range(8)]
    out = [None] * 8
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, c.submit(reqs[i])))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert all(len(g) == 1 for g in seen)
    assert out == [r.group for r in reqs] and c.served == 8


def test_coalescer_failure_surfaces_and_recovers():
    calls = {"n": 0}

    def run_group(group):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("device fell over")
        for r in group:
            r.result = "ok"

    c = _Coalescer(run_group, max_batch=8)
    with pytest.raises(ValueError, match="device fell over"):
        c.submit(_Request("m"))
    assert c.submit(_Request("m")) == "ok"


def test_bf16_compute_dtype_decodes_in_f32_on_cpu(trainer):
    d = DVAE(256, dtype=torch.bfloat16)
    d.load_state_dict(trainer.dvae.state_dict())
    z = torch.from_numpy(np.random.default_rng(0).choice([-1.0, 1.0], (2, 1, 256)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(d.eval().decode(z), trainer.dvae.decode(z))


def test_serving_path_imports_no_jax_or_host_extras():
    code = (
        "import sys, image_generation_tpu_torch.app.warm, "
        "image_generation_tpu_torch.training.trainer, image_generation_tpu_torch.ops.pt_tune, "
        "image_generation_tpu_torch.utils.graph_cache, image_generation_tpu_torch.ops.quant, "
        "image_generation_tpu_torch.ops.block_sparse, image_generation_tpu_torch.ops.gibbs_hbm_cuda, "
        "image_generation_tpu_torch.ops.cuda_build, image_generation_tpu_torch.io.native_ckpt, "
        "image_generation_tpu_torch.training.observability, "
        "image_generation_tpu_torch.parallel.mesh, image_generation_tpu_torch.ops.gibbs_graph_sharded, "
        "image_generation_tpu_torch.ops.block_sparse_sharded, "
        "image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda, "
        "image_generation_tpu_torch.ops.gibbs_sparse, image_generation_tpu_torch.samplers, "
        "image_generation_tpu_torch.samplers.base, image_generation_tpu_torch.samplers.gibbs_sampler, "
        "image_generation_tpu_torch.samplers.exact_sampler, "
        "image_generation_tpu_torch.samplers.persistent, image_generation_tpu_torch.samplers.factory, "
        "image_generation_tpu_torch.utils.sampleset, image_generation_tpu_torch.app.cli, "
        "image_generation_tpu_torch.app.files, image_generation_tpu_torch.app.figures, "
        "image_generation_tpu_torch.app.diagram, image_generation_tpu_torch.app.ui_config, "
        "image_generation_tpu_torch.app.server, image_generation_tpu_torch.app.render, "
        "image_generation_tpu_torch.app.evaluate, image_generation_tpu_torch.utils.topology, "
        "image_generation_tpu_torch.utils.layout, image_generation_tpu_torch.training.optim, "
        "image_generation_tpu_torch.parallel.dense, image_generation_tpu_torch.parallel.dryrun, "
        "torch.distributed.run; "
        "bad = [m for m in ('jax', 'flax', 'optax', 'yaml', 'networkx', 'sklearn', 'PIL', "
        "'image_generation_tpu') if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
