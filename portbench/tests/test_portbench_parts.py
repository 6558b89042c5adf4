"""The harness's parts on the CPU: finding pieces by name, the import
check, the yardstick's counts against hand counts, the reference against
the program at tiny sizes, and the trace's reduction."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, make_run


# ---------------------------------------------------------------- registry

def test_cells_find_their_pieces():
    from core import Run

    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for cell in manifest["workloads"]:
        run = Run(manifest, cell["name"], 1, 1.0, False)
        assert run.config and run.traffic and hasattr(run.driver, "run")
        assert run.limits, f"no limits for {cell['name']}"
        names = {m["name"] for m in run.end_to_end()}
        assert "setup_s" in names and len(names) >= 2
        per_layer = run.per_layer()
        assert per_layer
        for m, reader in per_layer:
            assert m["moves"] in names
            assert hasattr(reader, "read")


@pytest.mark.parametrize("field,value", [("workload", "nope"), ("config", "nope"),
                                         ("traffic", "nope")])
def test_unknown_names_are_refused(tiny_root, field, value):
    from core import Run, RunError

    manifest = json.loads((tiny_root / "manifest.json").read_text())
    workload = "tiny-train"
    if field == "workload":
        workload = value
    else:
        manifest["workloads"][0][field] = value
    with pytest.raises(RunError):
        Run(manifest, workload, 1, 1.0, False, root=tiny_root)


def test_unknown_reader_is_refused(tiny_root):
    manifest = json.loads((tiny_root / "manifest.json").read_text())
    manifest["per_layer"].append({"name": "nope.train", "unit": "%", "better": "higher",
                                  "source": "device_trace", "layer": "x",
                                  "moves": "train_images_per_s", "workloads": ["tiny-train"]})
    from core import Run, RunError

    with pytest.raises(RunError):
        Run(manifest, "tiny-train", 1, 1.0, True, root=tiny_root).per_layer()


def test_a_new_cell_is_only_new_files(tiny_root, tmp_path):
    """A throwaway configuration, mix, limits and reader in a directory of
    their own, with new manifest entries, run without an edit elsewhere."""
    import shutil

    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    conf = json.loads((root / "configs" / "tiny_train.json").read_text())
    conf["training"]["N_REPLICAS"] = 1
    (root / "configs" / "tiny_one.json").write_text(json.dumps(conf))
    mix = json.loads((root / "traffic" / "tiny_epochs.json").read_text())
    (root / "traffic" / "tiny_short.json").write_text(json.dumps(dict(mix, checked_steps=2)))
    (root / "checks" / "tiny-one.json").write_text(
        (root / "checks" / "tiny-train.json").read_text())
    (root / "metrics" / "steps_traced.one.py").write_text(
        "def read(run, work):\n    return float(len(work['steps'])) or None\n")
    manifest = json.loads((root / "manifest.json").read_text())
    manifest["workloads"].append({"name": "tiny-one", "config": "tiny_one",
                                  "traffic": "tiny_short", "chips": 1, "why": "a new cell"})
    manifest["end_to_end"][0]["workloads"].append("tiny-one")
    manifest["per_layer"].append({"name": "steps_traced.one", "unit": "steps",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "training step", "moves": "train_images_per_s",
                                  "workloads": ["tiny-one"]})
    (root / "manifest.json").write_text(json.dumps(manifest))
    run = make_run(root, "tiny-one")
    assert [m["name"] for m, _ in run.per_layer()] == ["steps_traced.one"]
    assert run.config["training"]["N_REPLICAS"] == 1 and run.traffic["checked_steps"] == 2


# ---------------------------------------------------------------- imports

_PROBE = """
import sys
sys.path.insert(0, {bench!r})
{imports}
from core import jax_modules
top = {{m.partition('.')[0] for m in sys.modules}}
print(jax_modules(), 'image_generation_tpu_torch' in top)
"""


@pytest.mark.parametrize("imports,port_allowed", [
    ("import core, compare, faults, readings, run\n"
     "for k in ('drivers', 'metrics'):\n"
     "    import pathlib\n"
     "    for f in sorted(pathlib.Path({bench!r}, k).glob('*.py')):\n"
     "        core.load_module(k, f.stem)\n"
     "import image_generation_tpu_torch.app.warm, image_generation_tpu_torch.training.trainer",
     True),
    ("import reference.train, reference.serve, reference.gibbs, reference.dvae, "
     "reference.plan, yardstick.work, yardstick.peaks, yardstick.trace_reads", False),
])
def test_no_jax_and_no_port_in_the_reference(imports, port_allowed):
    code = _PROBE.format(bench=str(BENCH), imports=imports.format(bench=str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    loaded, port = out.stdout.split("] ")[0] + "]", out.stdout.split("] ")[1].strip()
    assert loaded == "[]"
    assert port == "True" if port_allowed else port == "False"


def test_jax_names_compare_whole(monkeypatch):
    import types

    from core import jax_modules

    monkeypatch.setitem(sys.modules, "image_generation_tpu_torch_x", types.ModuleType("x"))
    assert "image_generation_tpu" not in jax_modules()
    monkeypatch.setitem(sys.modules, "image_generation_tpu.ops", types.ModuleType("y"))
    assert "image_generation_tpu" in jax_modules()


# ---------------------------------------------------------------- yardstick

def test_dvae_counts_by_hand():
    from yardstick.work import decoder_flops, encoder_flops

    n = 4
    enc = 2 * 9 * (1 * 32 * 32 * 32 + 32 * 64 * 16 * 16 + 64 * 128 * 8 * 8 + 128 * n * 4 * 4) \
        + 2 * 4 * n
    dec = 2 * n * 4 * n + 2 * 9 * (n * 128 * 2 * 2 + 128 * 64 * 4 * 4 + 64 * 32 * 8 * 8
                                   + 32 * 1 * 16 * 16 + 1 * 1 * 32 * 32)
    assert encoder_flops(n) == enc and decoder_flops(n) == dec
    # the scaled and flagship forward an image (PERF.md): 0.85 G and 91 M
    assert abs(encoder_flops(5640) + 2 * decoder_flops(5640) - 0.850e9) < 0.01e9
    assert abs(encoder_flops(256) + 8 * decoder_flops(256) - 91e6) < 1e6


def test_step_and_sweep_bounds_by_hand():
    from yardstick import peaks
    from yardstick.work import sweep_bound_s, train_step_least_s

    # 3 spins on a path (2 edges), 4 chains, 5 sweeps, f32, energy carried
    ops = 2 * 4 * 4 * 5
    nbytes = 4 * (2 * 4 * 3 + 3 + 4) + 8 + 4 * 4 + 4 * 4
    assert sweep_bound_s(3, 2, 4, 5, "float32", True) == max(ops / peaks.F32_FLOP_S,
                                                             nbytes / peaks.HBM_BYTES_S)
    cfg = dict(N_LATENTS=4, BATCH_SIZE=2, N_REPLICAS=1, IMAGE_SIZE=32, SAMPLER="gibbs",
               PT_NUM_BETAS=8, NUM_READS=3, GIBBS_SWEEPS=5, COMPUTE_DTYPE="float32")
    from yardstick.work import decoder_flops, encoder_flops

    dvae = 3 * 2 * (encoder_flops(4) + decoder_flops(4))
    mmd = 3 * 2 * 5 * 5 * 4
    sampler = 2 * (2 * 2) * 3 * 5
    want = (dvae + mmd + 2 * sampler) / peaks.F32_FLOP_S
    assert train_step_least_s(cfg, 2, True) == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------- reference

def test_philox_equals_the_kernels_numpy_twin():
    from image_generation_tpu_torch.ops.gibbs_cuda import philox_uniforms as twin

    from reference.gibbs import philox_uniforms

    seed = 2**62 - 12345
    want = twin(seed, 3, 5, 256)
    rows = torch.arange(5, dtype=torch.int64)
    for sweep in range(3):
        got = philox_uniforms(torch.tensor([seed]).expand(5), rows, 256, sweep)
        assert np.array_equal(got.numpy(), want[sweep])


@pytest.mark.parametrize("qpu,n", [("Advantage2_system1", 256), ("Advantage2_prototype", 32)])
def test_frozen_plan_equals_the_programs(qpu, n):
    from image_generation_tpu_torch.ops.gibbs import build_plan, class_spans
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    from reference.plan import build_plan as frozen

    g, _ = cached_latent_graph(qpu, n, 775321899904)
    p, f = build_plan(g), frozen(g.n, g.edge_i, g.edge_j)
    assert p.n_pad == f.n_pad and np.array_equal(p.orig_to_perm, f.orig_to_perm)
    assert [(a, b) for a, b, _, _ in class_spans(p)] == list(f.spans)


@pytest.mark.parametrize("config", ["scaled", "flagship"])
def test_frozen_graph_file_is_the_programs_selection(config):
    """A frozen graph is what the program selects for its configuration
    (the selection needs no card; a run checks it again)."""
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    t = conf["training"]
    g, _ = cached_latent_graph(t["QPU"], t["N_LATENTS"], conf["graph_seed"])
    with np.load(BENCH / conf["graph"]) as z:
        assert int(z["n"]) == g.n
        assert np.array_equal(z["edge_i"], g.edge_i) and np.array_equal(z["edge_j"], g.edge_j)


def test_reference_dvae_equals_the_programs_in_f32():
    from image_generation_tpu_torch.models.dvae import DVAE
    from image_generation_tpu_torch.training.step import _flax_init_

    from reference import dvae as ref

    n, seed = 16, 99
    model = DVAE(n)
    _flax_init_(model, torch.Generator().manual_seed(seed))
    w = ref.init_weights(n, seed, "cpu")
    sd = model.state_dict()
    for k, v in w.items():
        assert torch.equal(sd[k], v), k
    images = (torch.rand((6, 32, 32, 1), generator=torch.Generator().manual_seed(1)) < 0.2)
    images = images.float()
    u = torch.rand((6, 2, n), generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    masks = ref.dropout_masks(12, g, "cpu")
    model.train()
    _, spins, recon = model(images, 2, None, spin_uniforms=u, dropout_masks=masks)
    r_spins = ref.straight_through(ref.encode(w, images), u)
    torch.testing.assert_close(r_spins, spins, rtol=0, atol=1e-6)
    torch.testing.assert_close(ref.decode(w, r_spins, masks), recon, rtol=1e-4, atol=1e-5)
    model.eval()  # the running averages the forward above moved
    w = {k: v.float() for k, v in model.state_dict().items()}
    torch.testing.assert_close(ref.decode(w, spins.detach(), train=False),
                               model.decode(spins.detach()), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- trace

def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    from core import reduce_trace

    events = [_ev("kernel", "sparse_sweeps_kernel<float, 1>", 0, 10),
              _ev("kernel", "gemm", 5, 10), _ev("gpu_memcpy", "Memcpy DtoH", 30, 5),
              _ev("cpu_op", "aten::item", 14, 20), _ev("cpu_op", "aten::copy_", 16, 10),
              _ev("cuda_runtime", "cudaLaunchKernel", 0, 1)]
    s = reduce_trace(events, stretch_s=50e-6)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["kernel_s"]["gemm"] == pytest.approx(10e-6)
    assert dict(s["idle_gaps"]) == pytest.approx({"aten::copy_": 15e-6,
                                                  "stretch edges": 15e-6})


def test_readers_report_nothing_or_fail():
    from yardstick.trace_reads import NothingRead, gather_seconds, idle_pct

    trace = {"kernel_s": {"gemm": 1.0}, "busy_s": 1.0, "stretch_s": 4.0}
    assert gather_seconds({"trace": trace, "gather_launches": 0}) is None
    with pytest.raises(NothingRead):
        gather_seconds({"trace": trace, "gather_launches": 3})
    assert gather_seconds({"trace": None}) is None
    assert idle_pct({"trace": trace}) == pytest.approx(75.0)
