#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, train, time.

    python3 chip_smoke.py

Drives ``image_generation_tpu_torch`` (never JAX) through its warm serving
path on ``runs/models/tpu_digits_40_epochs`` (256 latents, the flagship
checkpoint, at full width; the weights are the checkpoint's) and through
flagship training (256 latents on a freshly selected Advantage2_system1
graph, batch 128, 8 replicas, 256 persistent chains, 16 sweeps per
refresh; random initial weights from the config's seed) under plain Gibbs
and under parallel tempering; then through the scaled configuration
(``bench.py --scaled``: 5,640 latents on the full Pegasus P16 fabric of
Advantage_system6, batch 1024, 2 replicas, 32-rung parallel tempering
over 64 chains each, 4 sweeps, a bf16 coupling packed into block-sparse
panels; the decoder's Linear(5640 -> 22560) whole; depth cut to two epochs
of the 4,096-image synthetic pool, 8 steps), trained, saved and served;
then K1 with a bf16 and an int8 coupling: a 2,048-latent model on
Advantage_system6 (the config defaults otherwise: a bf16 coupling streamed
through K2 in training; served int8 through K1-int8; one epoch, resumed for
a second) and the flagship with ``SAMPLER_MATMUL_DTYPE`` "bfloat16" and
"int8" (one epoch each).  Phases:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   nvcc; exits non-zero without a CUDA device;
2. builds the sweep kernels from ``csrc/`` (K1; K2 and K3; one ``nvcc``
   per source, started together) and prints the build time and the ptxas
   report (registers and spills of every instantiation);
3. K1 against its plain PyTorch version with fed uniforms, on the
   checkpoint's plan at 80 sweeps and at 256·k chains for k = 1, 2, 4, 8,
   16 (the serving group sizes at which the default rows per thread
   block, R, takes each of its values), with the checkpoint's scaled
   model and with |J| up to 1 and per-chain β: at least 98% of the chains
   must come out bit-identical (the two sum the fields in another order,
   so a draw within an ulp of its probability may flip and the chain then
   diverges), and every R the kernel is built for must have been checked;
4. K1's in-kernel Philox: against the plain version fed the same Philox
   stream (chain rule above), and its moments against exact enumeration
   on a 12-spin graph at 4096 chains;
5. the slice: ``WarmGenerator(device="cuda")`` warms up, answers
   a lone request and a 4-way burst through K1 (the launch counter must
   move, fewer dispatches than requests, images (256, 32, 32, 1) finite in
   [0, 1]); the fused path's uint8 images against the plain pipeline on
   fed inputs;
6. times (CUDA events for kernels, host clock for requests) and a
   ``torch.profiler`` breakdown of one request by kernel, each printed
   with the card's name and power limit;
7. K1 with the energy carry (K1-ΔE) against its plain version, fed
   uniforms, at 256 chains (β = 1) and 2,048 chains (the 8-rung ladder's
   per-chain β), 16 and 80 sweeps, for the checkpoint's model and a
   |J| ≤ 1 model on the fresh flagship plan: the chain rule above, and on
   identical chains ΔE within 1e-4 (checkpoint) or 1e-3·(1 + |E|)
   (|J| ≤ 1); in Philox mode ΔE against the f64 energy difference;
8. flagship training, plain Gibbs: ``Trainer(device="cuda")`` selects the
   graph and trains one epoch over the dataset (the synthetic pool of
   4,096 images, 32 steps, unless MNIST files are in ``data/``): finite
   losses, the last 8 steps' MSE below the first 8's, K1 launched, the
   median step time; then the model is saved and served through
   ``WarmGenerator``;
9. flagship training, parallel tempering (8 rungs × 256 chains): one
   epoch through K1-ΔE; the carried ladder energies against
   ``ising_energies`` recomputed on the card;
10. one unscheduled step of each sampler under ``torch.profiler``;
11. K1 and K1-ΔE timed at the training shapes (CUDA events) beside the
    plain version and the least time the card could take (``sweep_bound``),
    and K1 with fed uniforms (K1f) at the serving shape;
12. K2 and K3 against their plain versions with fed uniforms on the
    scaled plan (47 color blocks, chunk 256 with the final chunk clamped):
    f32, bf16 and int8, each with and without ΔE, 256 chains at β = 1 and
    2,048 chains at the 32-rung ladder's per-chain β, 4 sweeps and 3 (run
    as 4), under the chain rule and the ΔE rule (1e-3·(1 + |E|)); K3
    equal to K2 bit for bit on an integer-valued coupling; Philox mode
    against ``philox_uniforms``; moments against exact enumeration on the
    12-spin graph through both kernels;
13. scaled PT training: ``Trainer(cfg, device="cuda")`` sets up the P16
    graph and trains two epochs through K3-ΔE (``cuda_hbm+bs``, K1 never
    launched, finite losses, carried ladder energies against energies
    recomputed on the packed coupling); the step times and the peak
    device memory; the model is saved;
14. two unscheduled steps of the same configuration with
    ``SWEEP_BLOCK_SPARSE="off"`` through K2-ΔE (``cuda_hbm``), the same
    energy check;
15. the saved scaled model served through ``WarmGenerator``: the serving
    config resolves int8, every request runs K3-int8 (``cuda_hbm+int8+bs``),
    256 finite images in [0, 1]; the lone-request latency over 10
    requests;
16. K2 and K3 in every mode timed at the path's shapes (2,048 chains × 4
    sweeps; the served K3-int8 at 256 chains × 80 sweeps) beside the plain
    version and ``sweep_bound`` on the stored form (packed or int8 bytes,
    nonzeros from the plan's edge list); one scaled step under the
    profiler;
17. K1-bf16 and K1-int8 against their plain versions with fed uniforms,
    with and without dE: on the fresh flagship plan at 256 chains (beta =
    1) and 2,048 (the 8-rung ladder's per-chain beta) x 16 sweeps, and on
    the 2,048-latent plan (n_pad 2,432) at 256·k chains, k = 1, 2, 4, 8,
    16 (every R serving selects) x 80 sweeps; the chain rule and the dE
    rule (1e-3·(1 + |E|)); Philox mode against ``philox_uniforms``;
    moments against exact enumeration of the model each mode samples (the
    bf16-rounded and the dequantized couplings) on the 12-spin graph;
18. the 2,048-latent model trained one epoch through K2-bf16
    (``cuda_hbm``, K1 never launched) with ``metrics_log``,
    ``profile_dir`` and ``checkpoint_dir``; ``resume_native`` in a fresh
    Trainer continues at epoch 1; the model is saved;
19. the saved model served through ``WarmGenerator``: the serving config
    resolves int8 (``cuda_vmem+int8``), every dispatch launches K1-int8
    and nothing else (``warm_buckets`` up to 16, 10 lone requests, a 4-way
    burst); under ``SAMPLER="pt"`` every round launches K1-int8-dE; images
    finite in [0, 1];
20. flagship epochs with a bf16 coupling, plain Gibbs (K1-bf16) and PT
    (K1-bf16-dE), and with int8 under ``PT_NUM_BETAS="auto"`` (the probe
    through K1-int8-dE, then K1-int8-dE): finite losses, carried ladder
    energies against energies recomputed on the card;
21. K1-bf16, K1-bf16-dE, K1-int8 and K1-int8-dE timed at the paths'
    shapes beside the plain version and ``sweep_bound``, and K1 by rows
    per block at the 2,048-latent serving shape;
22. the span-update kernel K4 against its plain version: the fed entry
    bit-identical at 1, 37 and 2,048 chain rows over every class-span
    width of the scaled plan and a 23,936-wide row (the P32 fabric's
    n_pad), with per-chain beta; the Philox entry equal to the plain
    version fed ``philox_span_uniforms`` at a global row, column and sweep
    offset;
23. the scaled configuration with ``GRAPH_SHARDED="on"`` on a (1, 4) mesh:
    4 processes on cuda:0 (``torch.multiprocessing``), joined by a gloo
    process group (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through the host, so this is a real distributed run but not a
    multi-GPU measurement), each with TF32 off.  Each rank holds a quarter
    of the coupling rows (packed on its shard-local grid, bf16) and of the
    chain columns; one epoch (4 steps plus burn-in) through K4
    (``torch_graph_sharded+plrng+bs``), saved on rank 0, ``sample_spins(64)``;
    on every rank K4 launched and K1/K2/K3 never, finite losses equal on
    all ranks; the 4-rank sweep with fed uniforms against the
    single-device K3 on the same chains (chain rule); two steps with
    ``SWEEP_BLOCK_SPARSE="off"`` (dense bf16 row blocks of 1,504 x 6,016);
24. the ideal Pegasus P32 fabric (23,560 spins, n_pad 23,936; the whole f32
    coupling is 2.29 GB) on the same 4 ranks, each building only its rows
    from the edge list: 64 chains x 2 sweeps dense bf16, then packed at
    chunk 128 in bf16 and in int8 (1 sweep), energies finite; each rank's
    coupling bytes and peak device memory below the whole f32 matrix;
25. K4 per launch at the scaled path's shapes (CUDA events) beside its
    bound and its plain version; the sharded step's median and the host
    clock's share of the collectives in it (gloo, 4 processes on one
    card).

Each path (serving, plain training, PT training, scaled training, the K2
steps, scaled serving, the 2,048-latent training, resume and serving, the
flagship bf16 / int8 epochs, and on every rank the graph-sharded epoch,
its sampling, its dense steps and the P32 sweeps) runs with the launch
counters set to 0 just before it and read just after.  The line before
the last is a JSON object describing the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = ROOT / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98  # least fraction of chains bit-identical to the plain version
SERVING_CHAINS = (256, 512, 1024, 2048, 4096)  # 256·k chains, k = 1, 2, 4, 8, 16
MOMENT_ATOL = 0.06  # ≈4σ of a ±1 mean over 4096 chains
# H100 SXM peaks (NVIDIA's data sheet, 700 W): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
PEAK_OPS = {"f32": PEAK_F32_FLOPS, "bf16": 989e12, "int8": 1979e12}  # tensor cores for bf16/int8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def identical_fraction(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).all(dim=1).float().mean())


def sweep_bound(plan, stored_bytes: int, peak_ops: float, chains: int, sweeps: int,
                delta_e: bool, meta_bytes: int = 0):
    """(bound ms, "bytes" | "operations") of one sweep run: the field
    products the graph's couplings need (2 per nonzero of the symmetric
    matrix, counted from the plan's edge list, per chain and sweep run) at
    the peak rate of the coupling's type, against each input read once and
    each output written once (spins in and out, the coupling in its stored
    form, h, beta, the seed, the kernel's chunk lists; delta_e) at HBM
    bandwidth."""
    nnz = 2 * len(plan.perm_edge_i)
    ops = 2.0 * nnz * chains * sweeps
    nbytes = 4.0 * (2 * chains * plan.n_pad + plan.n_pad + chains) + 8 + stored_bytes + meta_bytes
    if delta_e:
        nbytes += 4.0 * chains
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def stored_bytes(coupling) -> int:
    """Bytes of the coupling as the kernel reads it: dense, int8 or panels."""
    t = getattr(coupling, "panels", None)
    if t is None:
        t = getattr(coupling, "q", coupling)
    return t.numel() * t.element_size()


def reset_counts(gibbs_cuda, gibbs_hbm_cuda) -> None:
    gibbs_cuda.gibbs_sweeps_cuda.launches.clear()
    gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches.clear()


def read_counts(gibbs_cuda, gibbs_hbm_cuda) -> dict:
    """Launches by kernel and mode since the last reset: "K1-f32",
    "K1-int8-dE", "K3-bf16-dE", ..."""
    return {**gibbs_cuda.gibbs_sweeps_cuda.launches,
            **gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches}


def main() -> int:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io.checkpoint import load_model_dir
    from image_generation_tpu_torch.models.dvae import DVAE
    from image_generation_tpu_torch.models.grbm import GRBMGraph, scaled_ising
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.cuda_build import load_libraries
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, gibbs_sweeps_reference, ising_energies, permuted_model, random_spins,
        to_original,
    )
    from image_generation_tpu_torch.training.step import make_sample_fns
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    # ---- 1. the card -------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[1] card: {card}")
    print(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    print(f"[1] nvcc: {shutil.which('nvcc') or 'not on PATH'}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twin in full f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build K1, K2 and K3 (one nvcc per source, started together) ----
    t0 = time.perf_counter()
    libs = load_libraries()
    gibbs_cuda.load_library()
    gibbs_hbm_cuda.load_library()
    print(f"[2] kernels loaded after {time.perf_counter() - t0:.2f} s")
    for name, built in libs.items():
        how = (f"built by nvcc in {built.build_seconds:.2f} s" if built.build_seconds
               else "found already built (no nvcc run)")
        print(f"[2] {name} {how} -> {built.path.relative_to(ROOT)}")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[2] ptxas: {line.strip()}")

    # ---- 3. K1 against the plain version, fed uniforms -------------------
    cfg = TrainingConfig()
    _, grbm_params, graph, _, _ = load_model_dir(MODEL, dev)
    plan = build_plan(graph)
    h, j = scaled_ising(grbm_params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE)
    hp_ckpt, a_ckpt = permuted_model(plan, h, j)
    rng = np.random.default_rng(0)
    h_strong = torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev)
    j_strong = torch.tensor(rng.uniform(-1.0, 1.0, graph.n_edges), dtype=torch.float32, device=dev)
    hp_strong, a_strong = permuted_model(plan, h_strong, j_strong)
    chains, sweeps = 256, cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS
    s0 = torch.tensor(rng.choice([-1.0, 1.0], (chains, plan.n_pad)), dtype=torch.float32, device=dev)
    beta_mixed = torch.tensor(rng.uniform(0.5, 2.0, chains), dtype=torch.float32, device=dev)
    max_abs_err = 0.0
    rows_checked = set()
    print(f"[3] plan: n={plan.n} n_pad={plan.n_pad} blocks={len(plan.blocks)} "
          f"couplers={graph.n_edges}; {sweeps} sweeps, fed uniforms")
    for n_c in SERVING_CHAINS:
        rows = gibbs_cuda.default_rows(plan, n_c)
        g3 = torch.Generator(device=dev)
        g3.manual_seed(n_c)
        s3 = random_spins(g3, plan, n_c, dev)
        u3 = torch.rand((sweeps, n_c, plan.n_pad), generator=g3, device=dev)
        beta3 = 0.5 + 1.5 * torch.rand(n_c, generator=g3, device=dev)
        for name, hp, a, beta in (("checkpoint model", hp_ckpt, a_ckpt, 1.0),
                                  ("|J|<=1, beta in [0.5, 2]", hp_strong, a_strong, beta3)):
            k1 = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s3, sweeps, beta, uniforms=u3)
            twin = gibbs_sweeps_reference(hp, a, plan, s3, sweeps, beta, uniforms=u3)
            torch.cuda.synchronize()
            frac = identical_fraction(k1, twin)
            err = float((k1 - twin).abs().max())
            max_abs_err = max(max_abs_err, err)
            differing = int(round((1 - frac) * n_c))
            print(f"[3] {n_c} chains (R={rows}), {name}: {differing}/{n_c} chains differ, "
                  f"max|K1-twin| {err}")
            check(frac >= CHAIN_RULE,
                  f"K1 vs twin ({n_c} chains, {name}): only {frac:.4f} of chains identical")
        rows_checked.add(rows)
        del u3
    check(rows_checked == set(gibbs_cuda._ROWS),
          f"rows per block checked {sorted(rows_checked)}, built {sorted(gibbs_cuda._ROWS)}")

    # ---- 4. Philox mode --------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    probe = torch.Generator(device=dev)
    probe.set_state(gen.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    n_ph = 8
    k1 = gibbs_cuda.gibbs_sweeps_cuda(hp_strong, a_strong, plan, s0, n_ph, beta_mixed, generator=gen)
    u_ph = torch.tensor(gibbs_cuda.philox_uniforms(seed, n_ph, chains, plan.n_pad), device=dev)
    twin = gibbs_sweeps_reference(hp_strong, a_strong, plan, s0, n_ph, beta_mixed, uniforms=u_ph)
    frac = identical_fraction(k1, twin)
    print(f"[4] Philox stream vs plain version fed philox_uniforms: "
          f"{int(round((1 - frac) * chains))}/{chains} chains differ ({n_ph} sweeps)")
    check(frac >= CHAIN_RULE, f"K1 Philox stream: only {frac:.4f} of chains identical")

    small = GRBMGraph(n=12, edge_i=np.array(SMALL_EDGES)[:, 0], edge_j=np.array(SMALL_EDGES)[:, 1])
    small_plan = build_plan(small)
    hs = rng.uniform(-0.3, 0.3, small.n).astype(np.float32)
    js = rng.uniform(-0.5, 0.5, small.n_edges).astype(np.float32)
    hps, aps = permuted_model(small_plan, torch.tensor(hs, device=dev), torch.tensor(js, device=dev))
    gs = torch.Generator(device=dev)
    gs.manual_seed(7)
    s = gibbs_cuda.gibbs_sweeps_cuda(
        hps, aps, small_plan, random_spins(gs, small_plan, 4096, dev), 200, generator=gs)
    s = to_original(small_plan, s).double().cpu().numpy()
    e1, e2 = exact_moments(hs, small.edge_i, small.edge_j, js)
    d1 = float(np.abs(s.mean(0) - e1).max())
    d2 = float(np.abs((s[:, small.edge_i] * s[:, small.edge_j]).mean(0) - e2).max())
    print(f"[4] Philox moments vs exact (12 spins, 4096 chains, 200 sweeps): "
          f"max|dm1| {d1:.4f} max|dm2| {d2:.4f} (atol {MOMENT_ATOL})")
    check(d1 < MOMENT_ATOL and d2 < MOMENT_ATOL, "K1 Philox moments disagree with exact enumeration")

    # ---- 5. the slice ------------------------------------------------------
    w = WarmGenerator(ROOT / "runs", device=dev)
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    warmed = w.warm_buckets(MODEL, 4)
    t0 = time.perf_counter()
    lone = w.serve(MODEL)
    lone_s = time.perf_counter() - t0
    before = w.stats["dispatches"]
    burst = [None] * 4

    def call(i):
        burst[i] = w.serve(MODEL)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    burst_s = time.perf_counter() - t0
    serving_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    launches = serving_counts.get("K1-f32", 0)
    burst_dispatches = w.stats["dispatches"] - before
    trainer = w._trainer
    print(f"[5] warmed group sizes {warmed}; sampler {trainer.fns.sampler_impl}; "
          f"K1 launches {launches}; burst of 4 in {burst_dispatches} dispatch(es); stats {w.stats}")
    check(trainer.fns.sampler_impl == "cuda_vmem", "the warm server did not select K1")
    check(launches > 0, "the main path never launched K1")
    check(all(not t.is_alive() for t in threads), "a burst request never returned")
    check(burst_dispatches < 4, "the 4-way burst was not coalesced")
    for out in [lone] + burst:
        img = out["images"]
        check(img.shape == (256, 32, 32, 1), f"images have shape {img.shape}")
        check(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
              "images are not finite values in [0, 1]")

    # the fused path's parts against the plain pipeline, fed inputs, f32 decode
    fns_plain = make_sample_fns(trainer.config.replace(USE_PALLAS="off"), trainer.graph,
                                trainer.plan, dev)
    n_img = 64
    init = torch.tensor(rng.choice([-1.0, 1.0], (n_img, plan.n_pad)), dtype=torch.float32, device=dev)
    uu = torch.tensor(rng.random((sweeps, n_img, plan.n_pad), dtype=np.float32), device=dev)
    f32 = DVAE(trainer.n_latents, dtype=torch.float32).to(dev).eval()
    f32.load_state_dict(trainer.dvae.state_dict())

    def images(fns, dvae):
        with torch.inference_mode():
            sp = fns.sample_fn(None, trainer.grbm_params, n_img, sweeps, init_spins=init, uniforms=uu)
            x = dvae.decode(sp[:, None, :])[:, 0]
            return sp, torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)

    sp_k, img_k = images(trainer.fns, f32)
    sp_p, img_p = images(fns_plain, f32)
    same = (sp_k == sp_p).all(dim=1)
    diff = (img_k.int() - img_p.int()).abs()[same]
    print(f"[5] fused vs plain (fed, f32 decode): {int((~same).sum())}/{n_img} chains differ; "
          f"max level diff on identical chains {int(diff.max()) if diff.numel() else 0}")
    check(float(same.float().mean()) >= CHAIN_RULE, "fused sampler disagrees with the plain pipeline")
    check(diff.numel() == 0 or int(diff.max()) <= 1, "decode disagrees beyond one uint8 level")
    _, img_bf16 = images(trainer.fns, trainer.dvae)
    lv = (img_bf16.int() - img_k.int()).abs().float()
    print(f"[5] bf16-autocast decode vs f32 decode: mean level diff {float(lv.mean()):.3f}, "
          f"max {int(lv.max())}, share > 8 levels {float((lv > 8).float().mean()):.5f}")
    check(float((lv > 8).float().mean()) < 0.01, "bf16 decode is far from the f32 decode")

    # ---- 6. times -------------------------------------------------------------
    g6 = torch.Generator(device=dev)
    g6.manual_seed(3)
    hp6, a6 = trainer.fns.build_sampler_model(trainer.grbm_params)
    s6 = random_spins(g6, plan, 256, dev)
    k1_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp6, a6, plan, s6, sweeps, generator=g6), 20)
    twin_ms = cuda_ms(lambda: gibbs_sweeps_reference(hp6, a6, plan, s6, sweeps, generator=g6), 5)
    print(f"[6] K1 256 chains x {sweeps} sweeps: {k1_ms:.4f} ms; plain twin {twin_ms:.4f} ms  [{card}]")
    for c in (256, 4096):
        sc = random_spins(g6, plan, c, dev)
        row = []
        for r in sorted(gibbs_cuda._ROWS):
            ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(
                hp6, a6, plan, sc, sweeps, generator=g6, _rows_per_block=r), 10)
            row.append(f"R={r}: {ms:.4f} ms")
        print(f"[6] K1 {c} chains x {sweeps} sweeps by rows per block "
              f"(default R={gibbs_cuda.default_rows(plan, c)}): {'; '.join(row)}  [{card}]")
    lone_ms = []
    for _ in range(100):
        t0 = time.perf_counter()
        w.serve(MODEL)
        lone_ms.append((time.perf_counter() - t0) * 1e3)
    burst_ms = []
    for _ in range(20):
        ts = [threading.Thread(target=lambda: w.serve(MODEL)) for _ in range(4)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        burst_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[6] warm request (256 images), host clock: first {lone_s * 1e3:.3f} ms; over 100: "
          f"median {np.median(lone_ms):.3f} ms, p90 {np.percentile(lone_ms, 90):.3f} ms, "
          f"max {max(lone_ms):.3f} ms  [{card}]")
    print(f"[6] 4-way burst (4 x 256 images), host clock: first {burst_s * 1e3:.3f} ms; over 20: "
          f"median {np.median(burst_ms):.3f} ms, max {max(burst_ms):.3f} ms  [{card}]")

    # device time of one warm request by kernel (torch.profiler)
    profile_request(lambda: w.serve(MODEL), "6", "flagship", card)

    # ---- 7. K1-ΔE against the plain version -------------------------------
    fgraph, _ = cached_latent_graph(cfg.QPU, cfg.N_LATENTS, cfg.RANDOM_SEED)
    fplan = build_plan(fgraph)
    hf = torch.tensor(rng.uniform(-0.5, 0.5, fgraph.n), dtype=torch.float32, device=dev)
    jf = torch.tensor(rng.uniform(-1.0, 1.0, fgraph.n_edges), dtype=torch.float32, device=dev)
    hp_f, a_f = permuted_model(fplan, hf, jf)
    ladder = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32, device=dev)
    de_err = 0.0
    print(f"[7] fresh flagship plan: n={fplan.n} couplers={fgraph.n_edges} "
          f"colors={len(fplan.blocks)} n_pad={fplan.n_pad}")
    for name, mplan, hp, a, strong in (
            ("checkpoint model, n_pad 640", plan, hp_ckpt, a_ckpt, False),
            ("|J|<=1 model, fresh plan n_pad 768", fplan, hp_f, a_f, True)):
        for n_c in (256, 2048):
            beta = 1.0 if n_c == 256 else ladder.repeat_interleave(n_c // len(ladder))
            for n_sw in (16, 80):
                g7 = torch.Generator(device=dev)
                g7.manual_seed(n_c + n_sw)
                s7 = random_spins(g7, mplan, n_c, dev)
                u7 = torch.rand((n_sw, n_c, mplan.n_pad), generator=g7, device=dev)
                out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, mplan, s7, n_sw, beta, uniforms=u7,
                                                       track_delta_e=True)
                ref, de_ref = gibbs_sweeps_reference(hp, a, mplan, s7, n_sw, beta, uniforms=u7,
                                                     track_delta_e=True)
                torch.cuda.synchronize()
                same = (out == ref).all(dim=1)
                err = (de - de_ref).abs()[same]
                e_abs = ising_energies(hp, a, ref).abs()[same]
                limit = 1e-3 * (1 + e_abs) if strong else torch.full_like(err, 1e-4)
                de_err = max(de_err, float(err.max()))
                print(f"[7] {name}, {n_c} chains (R={gibbs_cuda.default_rows(mplan, n_c)}), "
                      f"{n_sw} sweeps: {int((~same).sum())}/{n_c} chains differ, "
                      f"max|dE err| {float(err.max()):.3e} (|E| up to {float(e_abs.max()):.1f})")
                check(float(same.float().mean()) >= CHAIN_RULE,
                      f"K1-dE vs plain ({name}, {n_c} x {n_sw}): chains differ")
                check(bool((err <= limit).all()), f"K1-dE vs plain ({name}, {n_c} x {n_sw}): dE")
                del u7
    for name, mplan, hp, a in (("checkpoint model", plan, hp_ckpt, a_ckpt),
                               ("|J|<=1 model", fplan, hp_f, a_f)):
        g7 = torch.Generator(device=dev)
        g7.manual_seed(77)
        s7 = random_spins(g7, mplan, 2048, dev)
        out, de = gibbs_cuda.gibbs_sweeps_cuda(hp, a, mplan, s7, 16, ladder.repeat_interleave(256),
                                               generator=g7, track_delta_e=True)
        e64 = [x.double() @ hp.double() + 0.5 * (x.double() * (x.double() @ a.double())).sum(-1)
               for x in (s7, out)]
        diff = (de.double() - (e64[1] - e64[0])).abs()
        tol = 1e-3 * (1 + e64[0].abs().max())
        print(f"[7] Philox mode, {name}, 2048 chains x 16 sweeps: max|dE - (E_out - E_in)| "
              f"{float(diff.max()):.3e} (f64 energies, limit {float(tol):.3e})")
        check(bool((diff <= tol).all()), f"K1-dE Philox ({name}): dE is not the energy change")

    # ---- 8. flagship training, plain Gibbs ---------------------------------
    def timed_epoch(trainer, label):
        """One epoch, a CUDA-synchronised host clock around every step."""
        times, last, stats = [], [0.0], {}

        def on_batch(_epoch, _done, _nb):
            torch.cuda.synchronize()
            now = time.perf_counter()
            times.append(now - last[0])
            last[0] = now

        trainer.train_init(1)
        torch.cuda.synchronize()
        last[0] = time.perf_counter()
        trainer.train(1, batch_cb=on_batch, epoch_chunks=trainer.n_batches,
                      epoch_cb=lambda _e, st: stats.update(st))
        mses = trainer.losses["mse_losses"]
        med = float(np.median(times[4:]))
        print(f"[{label}] {len(mses)} steps on '{trainer.data_source.origin}' data: loss finite "
              f"{bool(np.isfinite(trainer.losses['dvae_losses']).all())}; MSE first 8 "
              f"{np.mean(mses[:8]):.5f}, last 8 {np.mean(mses[-8:]):.5f}; step median "
              f"{med * 1e3:.3f} ms (after 4 warm-up steps, n = {len(times) - 4}), "
              f"{trainer.config.BATCH_SIZE / med:.1f} images/s  [{card}]")
        check(bool(np.isfinite(trainer.losses["dvae_losses"]).all()), f"[{label}] losses not finite")
        check(np.mean(mses[-8:]) < np.mean(mses[:8]), f"[{label}] MSE did not fall")
        return stats, med

    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    flag = Trainer(device=dev)
    flag.setup()
    print(f"[8] setup: n={flag.graph.n} couplers={flag.graph.n_edges} "
          f"colors={len(flag.plan.blocks)} n_pad={flag.plan.n_pad} "
          f"sampler {flag.config.SAMPLER}, {flag.config.NUM_READS} chains")
    check((flag.graph.n, flag.graph.n_edges, flag.plan.n_pad, len(flag.plan.blocks))
          == (256, 2327, 768, 6), "the flagship graph or plan differs from the JAX package's")
    _, gibbs_step_s = timed_epoch(flag, "8")
    gibbs_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    print(f"[8] launches in plain-Gibbs training: {gibbs_counts}")
    check(gibbs_counts.get("K1-f32", 0) > 0, "plain-Gibbs training never launched K1")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        flag.save(tmp / "flagship_1_epoch")
        served = WarmGenerator(tmp, device=dev)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        img = served.serve(tmp / "flagship_1_epoch")["images"]
        served_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[8] the trained model saved and served: images {img.shape}, finite "
          f"{bool(np.isfinite(img).all())}, in [0, 1] {bool(img.min() >= 0 and img.max() <= 1)}; "
          f"launches {served_counts}")
    check(img.shape == (256, 32, 32, 1) and bool(np.isfinite(img).all()), "served images")
    check(served_counts == {"K1-f32": 1}, "serving the trained model did not go through K1")

    # ---- 9. flagship training, parallel tempering ----------------------------
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    pt = Trainer(config=TrainingConfig(SAMPLER="pt"), device=dev)
    pt.graph, pt.plan, pt.physical_nodes = flag.graph, flag.plan, flag.physical_nodes
    pt.images, pt.data_source = flag.images, flag.data_source  # the same data
    pt_stats, pt_step_s = timed_epoch(pt, "9")
    pt_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    st = pt.state
    e_rec = ising_energies(st.sampler_h, st.sampler_coupling, st.chains)
    e_gap = float((st.chain_energies - e_rec).abs().max())
    print(f"[9] launches in PT training: {pt_counts}; ladder {tuple(st.chains.shape)}; "
          f"carried vs recomputed energies: max gap {e_gap:.3e} (|E| up to "
          f"{float(e_rec.abs().max()):.2f}); acceptance min {pt_stats['pt_accept_min']:.4f} "
          f"mean {pt_stats['pt_accept_mean']:.4f}, recommended rungs "
          f"{pt_stats['pt_recommended_num_betas']}")
    check(pt_counts.get("K1-f32-dE", 0) > 0, "PT training never launched K1-dE")
    check(e_gap <= 1e-3, "carried PT energies drifted from the recomputed ones")

    # ---- 10. one step of each sampler under the profiler ----------------------
    batch = flag.images[: flag.config.BATCH_SIZE]
    for label, t in (("plain Gibbs", flag), ("PT", pt)):
        profile_step(t, batch, "10", label, card)

    # ---- kernel times at the training shapes ----------------------------------
    gk = torch.Generator(device=dev)
    gk.manual_seed(5)
    hp8, a8 = flag.state.sampler_h, flag.state.sampler_coupling
    flag_n_pad = flag.plan.n_pad
    s8 = flag.state.chains
    sw = flag.config.GIBBS_SWEEPS
    k1_train_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp8, a8, flag.plan, s8, sw,
                                                               generator=gk), 50)
    k1_train_plain = cuda_ms(lambda: gibbs_sweeps_reference(hp8, a8, flag.plan, s8, sw,
                                                            generator=gk), 10)
    hp9, a9 = st.sampler_h, st.sampler_coupling
    s9 = st.chains.reshape(-1, pt.plan.n_pad)
    b9 = st.pt_betas.repeat_interleave(pt.config.NUM_READS)
    de_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp9, a9, pt.plan, s9, sw, b9,
                                                         generator=gk, track_delta_e=True), 50)
    de_plain = cuda_ms(lambda: gibbs_sweeps_reference(hp9, a9, pt.plan, s9, sw, b9,
                                                      generator=gk, track_delta_e=True), 10)
    u_serve = torch.rand((sweeps, 256, plan.n_pad), generator=gk, device=dev)
    k1f_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp6, a6, plan, s6, sweeps,
                                                          uniforms=u_serve), 20)
    k1f_plain = cuda_ms(lambda: gibbs_sweeps_reference(hp6, a6, plan, s6, sweeps,
                                                       uniforms=u_serve), 5)
    del u_serve
    k1_bound = sweep_bound(flag.plan, stored_bytes(a8), PEAK_F32_FLOPS, s8.shape[0], sw, False)
    de_bound = sweep_bound(pt.plan, stored_bytes(a9), PEAK_F32_FLOPS, s9.shape[0], sw, True)
    serve_bound = sweep_bound(plan, stored_bytes(a6), PEAK_F32_FLOPS, 256, sweeps, False)
    k1f_bound = sweep_bound(plan, stored_bytes(a6), PEAK_F32_FLOPS, 256, sweeps, False,
                            4 * sweeps * 256 * plan.n_pad)  # the fed uniforms
    print(f"[11] K1 {s8.shape[0]} chains x {sw} sweeps (training, n_pad {flag.plan.n_pad}): "
          f"{k1_train_ms:.4f} ms, plain {k1_train_plain:.4f} ms, bound {k1_bound[0] * 1e3:.3f} us "
          f"({k1_bound[1]})  [{card}]")
    print(f"[11] K1-dE {s9.shape[0]} chains x {sw} sweeps (PT training): {de_ms:.4f} ms, plain "
          f"{de_plain:.4f} ms, bound {de_bound[0] * 1e3:.3f} us ({de_bound[1]})  [{card}]")
    print(f"[11] K1 256 chains x {sweeps} sweeps (serving, n_pad {plan.n_pad}): {k1_ms:.4f} ms, "
          f"bound {serve_bound[0] * 1e3:.3f} us ({serve_bound[1]}); dense-product work "
          f"{2 * 256 * sweeps * plan.n_pad ** 2 / 1e9:.2f} GFLOP = "
          f"{2 * 256 * sweeps * plan.n_pad ** 2 / PEAK_F32_FLOPS * 1e3:.3f} ms at the f32 peak")
    print(f"[11] K1f (fed uniforms) 256 chains x {sweeps} sweeps (serving shape): {k1f_ms:.4f} ms, "
          f"plain {k1f_plain:.4f} ms, bound {k1f_bound[0] * 1e3:.3f} us ({k1f_bound[1]})  [{card}]")
    print(f"[11] step medians: plain Gibbs {gibbs_step_s * 1e3:.3f} ms, PT {pt_step_s * 1e3:.3f} ms"
          f"  [{card}]")
    del flag, pt, st, w, trainer
    torch.cuda.empty_cache()

    scaled = scaled_phases(dev, card, rng)
    torch.cuda.empty_cache()
    k1_dtypes = k1_dtype_phases(dev, card, rng)
    torch.cuda.empty_cache()
    sharded = graph_sharded_phases(dev, card)

    print(card_line())
    paths = {"serving": serving_counts, "train_gibbs": gibbs_counts, "train_pt": pt_counts,
             **scaled["paths"], **k1_dtypes["paths"], **sharded["paths"]}
    print(json.dumps({"kernels": [
        {
            "name": "gibbs_sweeps (K1)",
            "route": "cuda",
            "source": "image_generation_tpu_torch/csrc/gibbs_sweeps.cu",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:141",
            "launches": gibbs_counts["K1-f32"],
            "launches_by_path": {k: v.get("K1-f32", 0) for k, v in paths.items()},
            "max_abs_err": max_abs_err,
            "tolerance": f">= {CHAIN_RULE:.0%} of chains bit-identical to the plain version",
            "ms": k1_train_ms,
            "plain_ms": k1_train_plain,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "shape": f"{s8.shape[0]} chains x {sw} sweeps, n_pad {flag_n_pad}",
        },
        {
            "name": "gibbs_sweeps with the energy carry (K1-dE)",
            "route": "cuda",
            "source": "image_generation_tpu_torch/csrc/gibbs_sweeps.cu",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:121",
            "launches": pt_counts["K1-f32-dE"],
            "launches_by_path": {k: v.get("K1-f32-dE", 0) for k, v in paths.items()},
            "max_abs_err": de_err,
            "tolerance": "chain rule as K1; dE within 1e-4 (checkpoint model), "
                         "1e-3*(1+|E|) (|J|<=1 model) on identical chains",
            "ms": de_ms,
            "plain_ms": de_plain,
            "bound_ms": de_bound[0],
            "bound_by": de_bound[1],
            "library_ms": None,
            "shape": f"{s9.shape[0]} chains x {sw} sweeps, n_pad {flag_n_pad}",
        },
        *[dict(entry, launches_by_path={k: v.get(entry["mode"], 0) for k, v in paths.items()})
          for entry in scaled["kernels"] + k1_dtypes["kernels"] + sharded["kernels"]],
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# the scaled configuration (bench.py --scaled): 5,640 latents on the full
# Pegasus P16 fabric, 32-rung parallel tempering over 64 chains each
SCALED = dict(QPU="Advantage_system6", N_LATENTS=5640, NUM_READS=64, BATCH_SIZE=1024,
              N_REPLICAS=2, SAMPLER="pt", PT_NUM_BETAS=32, PT_BETA_MIN=0.2, GIBBS_SWEEPS=4,
              GIBBS_BURN_IN=4)
STREAM_MODES = [(kernel, dtype, de) for kernel in ("K2", "K3")
                for dtype in ("f32", "bf16", "int8") for de in (False, True)]
STREAM_REPLACES = {"K2": "image_generation_tpu/ops/gibbs_pallas_hbm.py:87",
                   "K3": "image_generation_tpu/ops/gibbs_pallas_hbm.py:184"}


def mode_name(kernel: str, dtype: str, de: bool) -> str:
    return f"{kernel}-{dtype}" + ("-dE" if de else "")


def profile_request(serve, tag: str, label: str, card: str) -> None:
    """One warm request under ``torch.profiler``: device busy share of the
    wall clock and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] profiled {label} warm request: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), idle share {1 - busy_ms / wall_ms:.1%}"
          f"  [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")


def profile_step(trainer, batch, tag: str, label: str, card: str) -> None:
    """One unscheduled training step under ``torch.profiler``: device busy
    share of the wall clock and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    trainer.step(batch, 99)  # epoch 99: an unscheduled step (no GRBM update)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch, 99)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] profiled {label} training step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), idle share {1 - busy_ms / wall_ms:.1%}"
          f"  [{card}]")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    sweeps = [e for e in ranked[6:] if "gibbs_s" in e.key]  # the sweep kernels, if not in the top 6
    for e in ranked[:6] + sweeps:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:80]}")
    if not any("gibbs_s" in e.key for e in ranked):
        print(f"[{tag}]   the profiler recorded no sweep kernel (see the CUDA-event times)")


def scaled_phases(dev, card: str, rng) -> dict:
    """Phases 12-16, the scaled slice: K2 and K3 against their plain
    versions, PT training through K3-dE, two steps through K2-dE, serving
    through K3-int8, times.  Returns the launch counts of each path and
    the kernels' JSON entries."""
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.models.grbm import GRBMGraph
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.block_sparse import chunk_starts, pack_coupling, panel_offsets
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, ising_energies, permuted_model, random_spins, to_original,
    )
    from image_generation_tpu_torch.ops.quant import quantize_coupling
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    stream = gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda
    plain = gibbs_hbm_cuda.gibbs_sweeps_hbm_reference
    cfg = TrainingConfig(**SCALED)

    # ---- 12. K2 and K3 against their plain versions, scaled plan -------------
    t0 = time.perf_counter()
    graph, physical = cached_latent_graph(cfg.QPU, cfg.N_LATENTS, cfg.RANDOM_SEED)
    plan = build_plan(graph)
    chunk = cfg.SWEEP_BS_CHUNK
    starts = chunk_starts(plan.n_pad, chunk)
    tiles = panel_offsets(plan, chunk)[1]
    print(f"[12] scaled graph and plan in {time.perf_counter() - t0:.2f} s: n={plan.n} "
          f"couplers={graph.n_edges} n_pad={plan.n_pad} blocks={len(plan.blocks)}; chunk {chunk}: "
          f"{tiles} of {len(plan.blocks) * len(starts)} tiles occupied, final chunk starts at "
          f"{starts[-1]} (clamped: {starts[-1] % chunk != 0})")
    check((plan.n, graph.n_edges, plan.n_pad, len(plan.blocks)) == (5640, 40484, 6016, 47),
          "the scaled graph or plan differs from the one the JAX package builds")
    hp, a = permuted_model(plan, torch.tensor(rng.uniform(-0.5, 0.5, plan.n), dtype=torch.float32,
                                              device=dev),
                           torch.tensor(rng.uniform(-1.0, 1.0, graph.n_edges), dtype=torch.float32,
                                        device=dev))
    forms = {"f32": a, "bf16": a.to(torch.bfloat16), "int8": quantize_coupling(a)}
    couplings = {("K2", d): c for d, c in forms.items()}
    couplings.update({("K3", d): pack_coupling(plan, c, chunk) for d, c in forms.items()})
    ladder = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32,
                          device=dev).repeat_interleave(cfg.NUM_READS)
    errs = {mode_name(*m): 0.0 for m in STREAM_MODES}
    for n_c, beta in ((256, 1.0), (2048, ladder)):
        for n_sw in (4, 3):
            g = torch.Generator(device=dev)
            g.manual_seed(n_c + n_sw)
            s0 = random_spins(g, plan, n_c, dev)
            u = torch.rand((4, n_c, plan.n_pad), generator=g, device=dev)
            line = []
            for (kernel, dtype), c in couplings.items():
                for de in (False, True):
                    name = mode_name(kernel, dtype, de)
                    out = stream(hp, c, plan, s0, n_sw, beta, uniforms=u, track_delta_e=de)
                    ref = plain(hp, c, plan, s0, n_sw, beta, uniforms=u, track_delta_e=de)
                    torch.cuda.synchronize()
                    if de:
                        (out, d_out), (ref, d_ref) = out, ref
                    same = (out == ref).all(dim=1)
                    check(float(same.float().mean()) >= CHAIN_RULE,
                          f"{name} vs plain ({n_c} chains x {n_sw} sweeps): chains differ")
                    note = f"{name} {int((~same).sum())}"
                    if de:
                        err = (d_out - d_ref).abs()[same]
                        e_abs = ising_energies(hp, c, ref).abs()[same]
                        check(bool((err <= 1e-3 * (1 + e_abs)).all()),
                              f"{name} vs plain ({n_c} x {n_sw}): dE")
                        errs[name] = max(errs[name], float(err.max()))
                        note += f" (dE err {float(err.max()):.2e}, |E| <= {float(e_abs.max()):.0f})"
                    else:
                        errs[name] = max(errs[name], float((out - ref).abs().max()))
                    line.append(note)
            print(f"[12] {n_c} chains x {n_sw} sweeps (run as {gibbs_hbm_cuda.round_sweeps(n_sw)}),"
                  f" chains differing from the plain version: {'; '.join(line)}")
            del u
    # integer couplings: every sum exact, so K3 equals K2 bit for bit
    hi = torch.tensor(np.round(rng.normal(size=plan.n)), dtype=torch.float32, device=dev)
    ji = torch.tensor(rng.choice([-1.0, 1.0], graph.n_edges), dtype=torch.float32, device=dev)
    hp_i, a_i = permuted_model(plan, hi, ji)
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    s0 = random_spins(g, plan, 2048, dev)
    u = torch.rand((4, 2048, plan.n_pad), generator=g, device=dev)
    for dtype, c in {"f32": a_i, "bf16": a_i.to(torch.bfloat16),
                     "int8": quantize_coupling(a_i)}.items():
        k2 = stream(hp_i, c, plan, s0, 3, ladder, uniforms=u, track_delta_e=True)
        k3 = stream(hp_i, pack_coupling(plan, c, chunk), plan, s0, 3, ladder, uniforms=u,
                    track_delta_e=True)
        torch.cuda.synchronize()
        check(torch.equal(k2[0], k3[0]) and torch.equal(k2[1], k3[1]),
              f"K3 differs from K2 on an integer coupling ({dtype})")
    print("[12] integer couplings, 2048 chains x 3 sweeps with dE: K3 equals K2 bit for bit "
          "(f32, bf16, int8)")
    del u
    # Philox mode against the numpy twin
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    state = g.get_state()
    probe = torch.Generator(device=dev)
    probe.set_state(state)
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan, 256, dev)
    u_ph = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 256, plan.n_pad), device=dev)
    line = []
    for key in (("K2", "f32"), ("K3", "bf16"), ("K3", "int8")):
        g.set_state(state)
        out = stream(hp, couplings[key], plan, s0, 3, generator=g)
        ref = plain(hp, couplings[key], plan, s0, 3, uniforms=u_ph)
        frac = identical_fraction(out, ref)
        check(frac >= CHAIN_RULE, f"{key} Philox stream: only {frac:.4f} of chains identical")
        line.append(f"{'-'.join(key)} {int(round((1 - frac) * 256))}/256")
    print(f"[12] Philox stream vs plain fed philox_uniforms (256 chains, 3 sweeps run as 4): "
          f"chains differing {'; '.join(line)}")
    del u_ph
    small = GRBMGraph(n=12, edge_i=np.array(SMALL_EDGES)[:, 0], edge_j=np.array(SMALL_EDGES)[:, 1])
    small_plan = build_plan(small)
    hs = rng.uniform(-0.3, 0.3, small.n).astype(np.float32)
    js = rng.uniform(-0.5, 0.5, small.n_edges).astype(np.float32)
    hps, aps = permuted_model(small_plan, torch.tensor(hs, device=dev), torch.tensor(js, device=dev))
    e1, e2 = exact_moments(hs, small.edge_i, small.edge_j, js)
    for name, c in (("K2", aps), ("K3", pack_coupling(small_plan, aps, 128))):
        gs = torch.Generator(device=dev)
        gs.manual_seed(7)
        sm = stream(hps, c, small_plan, random_spins(gs, small_plan, 4096, dev), 200, generator=gs)
        sm = to_original(small_plan, sm).double().cpu().numpy()
        d1 = float(np.abs(sm.mean(0) - e1).max())
        d2 = float(np.abs((sm[:, small.edge_i] * sm[:, small.edge_j]).mean(0) - e2).max())
        print(f"[12] {name} Philox moments vs exact (12 spins, 4096 chains, 200 sweeps): "
              f"max|dm1| {d1:.4f} max|dm2| {d2:.4f} (atol {MOMENT_ATOL})")
        check(d1 < MOMENT_ATOL and d2 < MOMENT_ATOL, f"{name} Philox moments disagree with exact")

    # ---- 13. scaled PT training through K3-dE ---------------------------------
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(config=cfg, device=dev)
    tr.setup()  # the full P16 fabric through the graph cache
    check((tr.plan.n_pad, len(tr.plan.blocks), tr.graph.n_edges) == (plan.n_pad, len(plan.blocks),
                                                                      graph.n_edges),
          "Trainer.setup built another scaled plan")
    times, last = [], [0.0]

    def on_batch(_epoch, _done, _nb):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    tr.train_init(2)
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    tr.train(2, batch_cb=on_batch, epoch_chunks=tr.n_batches)
    train_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    st = tr.state
    e_rec = ising_energies(st.sampler_h, st.sampler_coupling, st.chains)
    e_gap = float((st.chain_energies - e_rec).abs().max())
    losses = tr.losses["dvae_losses"]
    med = float(np.median(times[2:]))
    print(f"[13] scaled PT training: sampler {tr.fns.sampler_impl}, {len(losses)} steps on "
          f"'{tr.data_source.origin}' data, ladder {tuple(st.chains.shape)}, coupling "
          f"{type(st.sampler_coupling).__name__} {tuple(st.sampler_coupling.panels.shape)} "
          f"{st.sampler_coupling.panels.dtype}; losses finite {bool(np.isfinite(losses).all())} "
          f"(first {losses[0]:.5f}, last {losses[-1]:.5f}); launches {train_counts}")
    print(f"[13] step times (ms): {', '.join(f'{t * 1e3:.3f}' for t in times)}; median after 2 "
          f"{med * 1e3:.3f} ms = {cfg.BATCH_SIZE / med:.1f} images/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  [{card}]")
    print(f"[13] carried vs recomputed ladder energies (packed coupling): max gap {e_gap:.3e} "
          f"(|E| up to {float(e_rec.abs().max()):.2f})")
    check(tr.fns.sampler_impl == "cuda_hbm+bs", "the scaled trainer did not select K3")
    check(bool(np.isfinite(losses).all()) and len(losses) == 2 * tr.n_batches,
          "scaled training losses")
    check(train_counts.get("K3-bf16-dE", 0) > 0, "scaled PT training never launched K3-dE")
    check(not any(k.startswith("K1") for k in train_counts), "scaled training launched K1")
    check(e_gap <= 1e-3 * (1 + float(e_rec.abs().max())), "carried energies drifted")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scaled_"))
    model_dir = tmp / "scaled_pegasus16_2ep"
    tr.save(model_dir)
    batch = tr.images[: cfg.BATCH_SIZE]

    # ---- 14. the same path through K2 (SWEEP_BLOCK_SPARSE="off") ---------------
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    k2t = Trainer(config=cfg.replace(SWEEP_BLOCK_SPARSE="off"), device=dev)
    k2t.graph, k2t.plan, k2t.physical_nodes = tr.graph, tr.plan, tr.physical_nodes
    k2t.images, k2t.data_source = tr.images, tr.data_source
    k2t.train_init(1)
    k2_losses = [k2t.step(batch, 6) for _ in range(2)]  # epoch 6: no GRBM update
    k2_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    st2 = k2t.state
    e_rec2 = ising_energies(st2.sampler_h, st2.sampler_coupling, st2.chains)
    e_gap2 = float((st2.chain_energies - e_rec2).abs().max())
    print(f"[14] K2 path: sampler {k2t.fns.sampler_impl}, coupling {st2.sampler_coupling.dtype} "
          f"{tuple(st2.sampler_coupling.shape)}; MSE {k2_losses}; launches {k2_counts}; carried "
          f"vs recomputed energies max gap {e_gap2:.3e}")
    check(k2t.fns.sampler_impl == "cuda_hbm", "SWEEP_BLOCK_SPARSE='off' did not select K2")
    check(k2_counts.get("K2-bf16-dE", 0) == 2, "the two steps did not run through K2-dE")
    check(bool(np.isfinite(k2_losses).all()), "K2 path losses")
    check(e_gap2 <= 1e-3 * (1 + float(e_rec2.abs().max())), "K2 carried energies drifted")
    del k2t, st2
    torch.cuda.empty_cache()

    # ---- 15. serving the saved scaled model through K3-int8 -------------------
    try:
        w = WarmGenerator(tmp, device=dev)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        t0 = time.perf_counter()
        w.warm_buckets(model_dir, 1)
        warm_s = time.perf_counter() - t0
        lat, outs = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            outs.append(w.serve(model_dir)["images"])
            lat.append((time.perf_counter() - t0) * 1e3)
        serve_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        sc = w._trainer.config
        print(f"[15] scaled serving: config SAMPLER={sc.SAMPLER} NUM_READS={sc.NUM_READS} sweeps "
              f"{sc.GIBBS_BURN_IN + sc.GIBBS_SWEEPS} SAMPLER_MATMUL_DTYPE={sc.SAMPLER_MATMUL_DTYPE}; "
              f"sampler {w._trainer.fns.sampler_impl}; launches {serve_counts}; warm-up "
              f"{warm_s * 1e3:.3f} ms; lone request over 10: median {np.median(lat):.3f} ms, "
              f"max {max(lat):.3f} ms  [{card}]")
        check(sc.SAMPLER_MATMUL_DTYPE == "int8", "the scaled serving config did not resolve int8")
        check(w._trainer.fns.sampler_impl == "cuda_hbm+int8+bs", "scaled serving did not select K3")
        check(serve_counts.get("K3-int8", 0) == 11, "scaled serving did not launch K3-int8")
        for img in outs:
            check(img.shape == (256, 32, 32, 1) and bool(np.isfinite(img).all())
                  and img.min() >= 0.0 and img.max() <= 1.0, "scaled served images")
        plan_s = w._trainer.plan  # the served checkpoint's own plan
        hp_s, c_s = w._trainer.fns.build_sampler_model(w._trainer.grbm_params)
        del w
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 16. times at the path's shapes ---------------------------------------
    gk = torch.Generator(device=dev)
    gk.manual_seed(6)
    s_train = random_spins(gk, plan, 2048, dev)
    s_serve = random_spins(gk, plan, 256, dev)
    serve_sweeps = sc.GIBBS_BURN_IN + sc.GIBBS_SWEEPS
    kernels = []
    for kernel, dtype, de in STREAM_MODES:
        name = mode_name(kernel, dtype, de)
        c = couplings[(kernel, dtype)]
        if name == "K3-int8":  # serving: the served model's own coupling
            args, n_c, n_sw, reps = (hp_s, c_s, plan_s, s_serve, serve_sweeps, 1.0), 256, serve_sweeps, 5
        else:
            args, n_c, n_sw, reps = (hp, c, plan, s_train, cfg.GIBBS_SWEEPS, ladder), 2048, 4, 5
        ms = cuda_ms(lambda: stream(*args, generator=gk, track_delta_e=de), reps, warmup=1)
        plain_ms = cuda_ms(lambda: plain(*args, generator=gk, track_delta_e=de), 2, warmup=1)
        meta = 4 * len(gibbs_hbm_cuda._meta_list(args[2], chunk if kernel == "K3" else None))
        bound = sweep_bound(args[2], stored_bytes(args[1]), PEAK_OPS[dtype], n_c,
                            gibbs_hbm_cuda.round_sweeps(n_sw), de, meta)
        print(f"[16] {name} {n_c} chains x {n_sw} sweeps: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound[0] * 1e3:.3f} us ({bound[1]})  [{card}]")
        kernels.append({
            "name": f"gibbs_stream ({name})",
            "mode": name,
            "route": "cuda",
            "source": "image_generation_tpu_torch/csrc/gibbs_hbm.cu",
            "replaces": STREAM_REPLACES[kernel],
            "launches": sum(cnt.get(name, 0) for cnt in (train_counts, k2_counts, serve_counts)),
            "max_abs_err": errs[name],
            "tolerance": f">= {CHAIN_RULE:.0%} of chains bit-identical to the plain version"
                         + ("; dE within 1e-3*(1+|E|) on identical chains" if de else ""),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": None,
            "shape": f"{n_c} chains x {n_sw} sweeps, n_pad {plan.n_pad}, {len(plan.blocks)} blocks"
                     + (f", chunk {chunk}" if kernel == "K3" else ""),
        })
    # the rows per thread block at the two path shapes (measured, not tuned)
    for name, dtype, args in (
            ("K3-bf16-dE", torch.bfloat16,
             (hp, couplings[("K3", "bf16")], plan, s_train, cfg.GIBBS_SWEEPS, ladder)),
            ("K3-int8", torch.int8, (hp_s, c_s, plan_s, s_serve, serve_sweeps, 1.0))):
        row = []
        for r in sorted(gibbs_hbm_cuda._ROWS):
            ms_r = cuda_ms(lambda: stream(*args, generator=gk, track_delta_e=name.endswith("-dE"),
                                          _rows_per_block=r), 2, warmup=1)
            row.append(f"R={r}: {ms_r:.4f} ms")
        n_c = args[3].shape[0]
        print(f"[16] {name} {n_c} chains x {args[4]} sweeps by rows per block (default R="
              f"{gibbs_hbm_cuda.default_rows(args[2], n_c, dtype, chunk)}): {'; '.join(row)}"
              f"  [{card}]")
    profile_step(tr, batch, "16", "scaled PT", card)
    return {"paths": {"train_scaled": train_counts, "train_scaled_k2": k2_counts,
                      "serve_scaled": serve_counts},
            "kernels": kernels}


# the 2,048-latent configuration: Advantage_system6's Pegasus fabric cut to
# 2,048 latents, the config defaults otherwise (bf16 coupling under "auto":
# K2-bf16 in training; served int8 through K1-int8)
SERVE2K = dict(QPU="Advantage_system6", N_LATENTS=2048)
K1_MODES = [(dtype, de) for dtype in ("bf16", "int8") for de in (False, True)]
K1_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}  # the stored coupling's type


def k1_mode(dtype: str, de: bool) -> str:
    return f"K1-{dtype}" + ("-dE" if de else "")


def k1_forms(a):
    """The coupling ``a`` as K1-bf16 and K1-int8 take it."""
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    return {"bf16": a.to(torch.bfloat16), "int8": quantize_coupling(a)}


def k1_dtype_phases(dev, card: str, rng) -> dict:
    """Phases 17-21: K1 with a bf16 and an int8 coupling.  K1-bf16 and
    K1-int8 against their plain versions; the 2,048-latent model trained
    through K2-bf16 with the metrics log, profiler and native checkpoints,
    resumed, saved and served through K1-int8 (and K1-int8-dE under PT);
    flagship epochs through K1-bf16, K1-bf16-dE and, after the
    PT_NUM_BETAS="auto" probe, K1-int8-dE; times, bounds and an R sweep.
    Returns the launch counts of each path and the kernels' JSON entries."""
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.models.grbm import GRBMGraph
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, gibbs_sweeps_kernel_reference, ising_energies, permuted_model,
        random_spins, to_original,
    )
    from image_generation_tpu_torch.ops.quant import dequantize_coupling
    from image_generation_tpu_torch.training.observability import MetricsLog
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    k1 = gibbs_cuda.gibbs_sweeps_cuda
    plain = gibbs_sweeps_kernel_reference
    flag_cfg = TrainingConfig()
    cfg2k = TrainingConfig(**SERVE2K)

    # ---- 17. K1-bf16 and K1-int8 against their plain versions ----------------
    fgraph, _ = cached_latent_graph(flag_cfg.QPU, flag_cfg.N_LATENTS, flag_cfg.RANDOM_SEED)
    fplan = build_plan(fgraph)
    graph2k, _ = cached_latent_graph(cfg2k.QPU, cfg2k.N_LATENTS, cfg2k.RANDOM_SEED)
    plan2k = build_plan(graph2k)
    print(f"[17] 2,048-latent plan: n={plan2k.n} couplers={graph2k.n_edges} n_pad={plan2k.n_pad} "
          f"block widths {[c1 - c0 for c0, _v, c1 in plan2k.blocks]}; K1 gate (256 chains) "
          f"f32/bf16/int8: {[gibbs_cuda.selects_k1(plan2k, 256, it) for it in (4, 2, 1)]}")
    check((plan2k.n, graph2k.n_edges, plan2k.n_pad, len(plan2k.blocks)) == (2048, 14559, 2432, 7),
          "the 2,048-latent graph or plan differs from the one the JAX package builds")

    def random_model(mplan, graph):
        return permuted_model(
            mplan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1.0, 1.0, graph.n_edges), dtype=torch.float32, device=dev))

    ladder8 = torch.tensor(flag_cfg.initial_pt_betas(), dtype=torch.float32, device=dev)
    errs = {k1_mode(*m): 0.0 for m in K1_MODES}
    rows_checked = {"bf16": set(), "int8": set()}
    cases = [("fresh flagship plan", fplan, fgraph, n_c, 16) for n_c in (256, 2048)]
    cases += [("2,048-latent plan", plan2k, graph2k, n_c, 80) for n_c in SERVING_CHAINS]
    models = {}
    for label, mplan, graph, n_c, n_sw in cases:
        if label not in models:
            models[label] = random_model(mplan, graph)
        hp, a = models[label]
        forms = k1_forms(a)
        g = torch.Generator(device=dev)
        g.manual_seed(n_c + n_sw)
        s0 = random_spins(g, mplan, n_c, dev)
        u = torch.rand((n_sw, n_c, mplan.n_pad), generator=g, device=dev)
        beta = (1.0 if n_c == 256 else ladder8.repeat_interleave(n_c // len(ladder8))
                if mplan is fplan else 0.5 + 1.5 * torch.rand(n_c, generator=g, device=dev))
        line = []
        for dtype, de in K1_MODES:
            c = forms[dtype]
            name = k1_mode(dtype, de)
            out = k1(hp, c, mplan, s0, n_sw, beta, uniforms=u, track_delta_e=de)
            ref = plain(hp, c, mplan, s0, n_sw, beta, uniforms=u, track_delta_e=de)
            torch.cuda.synchronize()
            if de:
                (out, d_out), (ref, d_ref) = out, ref
            same = (out == ref).all(dim=1)
            check(float(same.float().mean()) >= CHAIN_RULE,
                  f"{name} vs plain ({label}, {n_c} x {n_sw}): chains differ")
            note = f"{name} {int((~same).sum())}"
            if de:
                err = (d_out - d_ref).abs()[same]
                e_abs = ising_energies(hp, c, ref).abs()[same]
                check(bool((err <= 1e-3 * (1 + e_abs)).all()), f"{name} vs plain ({label}): dE")
                errs[name] = max(errs[name], float(err.max()))
                note += f" (dE err {float(err.max()):.2e}, |E| <= {float(e_abs.max()):.0f})"
            else:
                errs[name] = max(errs[name], float((out - ref).abs().max()))
            line.append(note)
            if mplan is plan2k:
                rows_checked[dtype].add(gibbs_cuda.default_rows(mplan, n_c, K1_DTYPES[dtype]))
        print(f"[17] {label}, {n_c} chains x {n_sw} sweeps, fed uniforms; chains differing "
              f"from the plain version: {'; '.join(line)}")
        del u
    for dtype, seen in rows_checked.items():
        check(seen == set(gibbs_cuda._ROWS),
              f"K1-{dtype}: rows per block checked {sorted(seen)}, built {sorted(gibbs_cuda._ROWS)}")
    print(f"[17] rows per block checked on the serving chain counts: "
          f"{ {d: sorted(v) for d, v in rows_checked.items()} }")
    # Philox mode against the numpy twin, on the 2,048-latent plan
    hp2k, a2k = models["2,048-latent plan"]
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    state = g.get_state()
    probe = torch.Generator(device=dev)
    probe.set_state(state)
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    s0 = random_spins(probe, plan2k, 256, dev)
    u_ph = torch.tensor(gibbs_cuda.philox_uniforms(seed, 4, 256, plan2k.n_pad), device=dev)
    line = []
    for dtype, c in k1_forms(a2k).items():
        g.set_state(state)
        out = k1(hp2k, c, plan2k, s0, 4, generator=g)
        frac = identical_fraction(out, plain(hp2k, c, plan2k, s0, 4, uniforms=u_ph))
        check(frac >= CHAIN_RULE, f"K1-{dtype} Philox stream: only {frac:.4f} of chains identical")
        line.append(f"K1-{dtype} {int(round((1 - frac) * 256))}/256")
    print(f"[17] Philox stream vs plain fed philox_uniforms (2,048-latent plan, 256 chains, "
          f"4 sweeps): chains differing {'; '.join(line)}")
    del u_ph
    # moments against exact enumeration of the model each mode samples
    small = GRBMGraph(n=12, edge_i=np.array(SMALL_EDGES)[:, 0], edge_j=np.array(SMALL_EDGES)[:, 1])
    small_plan = build_plan(small)
    hs = rng.uniform(-0.3, 0.3, small.n).astype(np.float32)
    js = rng.uniform(-0.5, 0.5, small.n_edges).astype(np.float32)
    hps, aps = permuted_model(small_plan, torch.tensor(hs, device=dev), torch.tensor(js, device=dev))
    ei = torch.as_tensor(small_plan.perm_edge_i, device=dev)
    ej = torch.as_tensor(small_plan.perm_edge_j, device=dev)
    for dtype, c in k1_forms(aps).items():
        dense = dequantize_coupling(c) if dtype == "int8" else c.to(torch.float32)
        j_model = dense[ei, ej].double().cpu().numpy()  # the couplings this mode samples
        gs = torch.Generator(device=dev)
        gs.manual_seed(7)
        sm = k1(hps, c, small_plan, random_spins(gs, small_plan, 4096, dev), 200, generator=gs)
        sm = to_original(small_plan, sm).double().cpu().numpy()
        e1, e2 = exact_moments(hs, small.edge_i, small.edge_j, j_model)
        d1 = float(np.abs(sm.mean(0) - e1).max())
        d2 = float(np.abs((sm[:, small.edge_i] * sm[:, small.edge_j]).mean(0) - e2).max())
        print(f"[17] K1-{dtype} Philox moments vs exact ({'dequantized' if dtype == 'int8' else 'bf16'}"
              f" model, 12 spins, 4096 chains, 200 sweeps): max|dm1| {d1:.4f} max|dm2| {d2:.4f} "
              f"(atol {MOMENT_ATOL})")
        check(d1 < MOMENT_ATOL and d2 < MOMENT_ATOL, f"K1-{dtype} Philox moments disagree with exact")

    # ---- 18. the 2,048-latent model trained through K2-bf16 --------------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_2k_"))
    try:
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        tr = Trainer(config=cfg2k, device=dev)
        log = MetricsLog(tmp / "metrics.jsonl")
        t0 = time.perf_counter()
        tr.train(1, metrics_log=log, profile_dir=str(tmp / "profile"),
                 checkpoint_dir=tmp / "ckpt")
        train_s = time.perf_counter() - t0
        train2k_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        rec = log.read()
        traces = sorted((tmp / "profile").glob("*.json"))
        ckpts = sorted(p.name for p in (tmp / "ckpt").iterdir())
        losses = tr.losses["dvae_losses"]
        print(f"[18] 2,048-latent training: sampler {tr.fns.sampler_impl}, coupling "
              f"{tr.state.sampler_coupling.dtype} {tuple(tr.state.sampler_coupling.shape)}, "
              f"{len(losses)} steps on '{tr.data_source.origin}' data in {train_s:.3f} s (profiled), "
              f"losses finite {bool(np.isfinite(losses).all())}; launches {train2k_counts}; "
              f"metrics log {rec}; trace {[p.name for p in traces]} "
              f"({sum(p.stat().st_size for p in traces) / 2**20:.1f} MiB); checkpoints {ckpts}")
        check(tr.fns.sampler_impl == "cuda_hbm", "2,048-latent training did not select K2")
        check(train2k_counts.get("K2-bf16", 0) > 0, "2,048-latent training never launched K2-bf16")
        check(not any(k.startswith("K1") for k in train2k_counts), "2,048-latent training ran K1")
        check(bool(np.isfinite(losses).all()), "2,048-latent training losses")
        check(len(rec) == 1 and rec[0]["event"] == "epoch" and rec[0]["epoch"] == 0,
              "the metrics log holds no epoch record")
        check(len(traces) == 1 and traces[0].stat().st_size > 0, "no profiler trace was written")
        check(f"step_{tr.n_batches:08d}.pt" in ckpts, "no native checkpoint after the epoch")
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        resumed = Trainer(config=cfg2k, device=dev)
        step = resumed.resume_native(tmp / "ckpt", n_epochs=2)
        check(step == tr.n_batches, f"resume_native restored step {step}, not {tr.n_batches}")
        check(torch.equal(resumed.state.chains, tr.state.chains)
              and torch.equal(resumed.state.grbm_params.quadratic, tr.state.grbm_params.quadratic),
              "the resumed state differs from the saved one")
        ran = []
        resumed.train(2, epoch_cb=lambda e, _st: ran.append(e))
        resume_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        print(f"[18] resumed in a fresh Trainer at step {step}: ran epochs {ran}, "
              f"{len(resumed.losses['mse_losses'])} losses in its history; launches {resume_counts}")
        check(ran == [1], f"the resumed run ran epochs {ran}, not [1]")
        check(bool(np.isfinite(resumed.losses["dvae_losses"]).all()), "resumed losses")
        model_dir = tmp / "pegasus_2048_2ep"
        resumed.save(model_dir)
        del tr, resumed
        torch.cuda.empty_cache()

        # ---- 19. served through K1-int8 ---------------------------------------
        w = WarmGenerator(tmp, device=dev)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        t0 = time.perf_counter()
        warmed = w.warm_buckets(model_dir, 16)
        warm_s = time.perf_counter() - t0
        lat, outs = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            outs.append(w.serve(model_dir)["images"])
            lat.append((time.perf_counter() - t0) * 1e3)
        before = w.stats["dispatches"]
        burst = [None] * 4

        def call(i):
            burst[i] = w.serve(model_dir)["images"]

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_ms = (time.perf_counter() - t0) * 1e3
        burst_dispatches = w.stats["dispatches"] - before
        serve2k_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        sc = w._trainer.config
        print(f"[19] 2,048-latent serving: SAMPLER_MATMUL_DTYPE={sc.SAMPLER_MATMUL_DTYPE}, sampler "
              f"{w._trainer.fns.sampler_impl}; warm_buckets {warmed[0]}..{warmed[-1]} in "
              f"{warm_s * 1e3:.3f} ms; lone request over 10: median {np.median(lat):.3f} ms, "
              f"max {max(lat):.3f} ms; 4-way burst {burst_ms:.3f} ms in {burst_dispatches} "
              f"dispatch(es); launches {serve2k_counts}  [{card}]")
        check(sc.SAMPLER_MATMUL_DTYPE == "int8", "the 2,048-latent serving config did not resolve int8")
        check(w._trainer.fns.sampler_impl == "cuda_vmem+int8", "2,048-latent serving did not select K1")
        check(all(not t.is_alive() for t in threads), "a burst request never returned")
        n_dispatch = len(warmed) + 10 + burst_dispatches
        check(serve2k_counts == {"K1-int8": n_dispatch},
              f"every serving dispatch must launch K1-int8 once and nothing else: {serve2k_counts}")
        for img in outs + burst:
            check(img.shape == (sc.NUM_READS, 32, 32, 1) and bool(np.isfinite(img).all())
                  and img.min() >= 0.0 and img.max() <= 1.0, "2,048-latent served images")
        profile_request(lambda: w.serve(model_dir), "19", "2,048-latent", card)
        plan_s = w._trainer.plan
        hp_s, c_s = w._trainer.fns.build_sampler_model(w._trainer.grbm_params)
        del w
        w_pt = WarmGenerator(tmp, device=dev, config_overrides={"SAMPLER": "pt"})
        w_pt.serve(model_dir)  # load and first use
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        lat_pt = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = w_pt.serve(model_dir)["images"]
            lat_pt.append((time.perf_counter() - t0) * 1e3)
            check(img.shape == (sc.NUM_READS, 32, 32, 1) and bool(np.isfinite(img).all())
                  and img.min() >= 0.0 and img.max() <= 1.0, "PT-served images")
        serve2k_pt_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        pcfg = w_pt._trainer.config
        rounds = max(1, (pcfg.GIBBS_BURN_IN + pcfg.GIBBS_SWEEPS) // pcfg.GIBBS_SWEEPS)
        print(f"[19] served under PT ({pcfg.PT_NUM_BETAS} rungs x {pcfg.NUM_READS} chains, "
              f"{rounds} rounds of {pcfg.GIBBS_SWEEPS} sweeps): sampler "
              f"{w_pt._trainer.fns.sampler_impl}; 3 requests, median {np.median(lat_pt):.3f} ms; "
              f"launches {serve2k_pt_counts}  [{card}]")
        check(serve2k_pt_counts == {"K1-int8-dE": 3 * rounds},
              f"PT serving must run K1-int8-dE only: {serve2k_pt_counts}")
        del w_pt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- 20. flagship epochs through K1-bf16, K1-bf16-dE, K1-int8-dE ----------
    base = Trainer(config=flag_cfg, device=dev)
    base.setup()
    base._load_dataset()
    flag_paths, flag_states = {}, {}
    for label, overrides in (("bf16", dict(SAMPLER_MATMUL_DTYPE="bfloat16")),
                             ("bf16 PT", dict(SAMPLER_MATMUL_DTYPE="bfloat16", SAMPLER="pt")),
                             ("int8 PT auto", dict(SAMPLER_MATMUL_DTYPE="int8", SAMPLER="pt",
                                                   PT_NUM_BETAS="auto"))):
        t = Trainer(config=flag_cfg.replace(**overrides), device=dev)
        t.graph, t.plan, t.physical_nodes = base.graph, base.plan, base.physical_nodes
        t.images, t.data_source = base.images, base.data_source
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        t.train_init(1)  # under "auto" the ladder probe runs in here
        init_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        losses = t.losses["dvae_losses"]
        st = t.state
        msg = (f"[20] flagship {label}: sampler {t.fns.sampler_impl}; init launches {init_counts}; "
               f"epoch of {len(losses)} steps {epoch_s * 1e3:.3f} ms; losses finite "
               f"{bool(np.isfinite(losses).all())} (MSE first {t.losses['mse_losses'][0]:.5f}, "
               f"last {t.losses['mse_losses'][-1]:.5f}); launches {counts}")
        if t.config.SAMPLER == "pt":
            e_rec = ising_energies(st.sampler_h, st.sampler_coupling, st.chains)
            e_gap = float((st.chain_energies - e_rec).abs().max())
            msg += (f"; ladder {tuple(st.chains.shape)}; carried vs recomputed energies max gap "
                    f"{e_gap:.3e} (|E| up to {float(e_rec.abs().max()):.2f})")
            check(e_gap <= 1e-3 * (1 + float(e_rec.abs().max())),
                  f"flagship {label}: carried energies drifted")
        if t.pt_auto_info is not None:
            msg += f"; auto ladder {t.pt_auto_info}, betas {[round(b, 4) for b in t.config.PT_BETAS]}"
        print(msg + f"  [{card}]")
        check(bool(np.isfinite(losses).all()), f"flagship {label}: losses")
        want = {"bf16": "K1-bf16", "bf16 PT": "K1-bf16-dE", "int8 PT auto": "K1-int8-dE"}[label]
        check(t.fns.sampler_impl == "cuda_vmem" + ("+int8" if "int8" in label else ""),
              f"flagship {label} did not select K1")
        check(set(counts) == {want} and counts[want] > 0, f"flagship {label} must run {want} only")
        if "auto" in label:
            check(init_counts.get("K1-int8-dE", 0) > 0, "the auto-ladder probe never launched K1")
        flag_paths[f"train_flagship_{label.replace(' ', '_')}"] = counts
        flag_paths[f"init_flagship_{label.replace(' ', '_')}"] = init_counts
        flag_states[label] = (t.plan, st)
    del base

    # ---- 21. times and bounds at the paths' shapes ----------------------------
    gk = torch.Generator(device=dev)
    gk.manual_seed(8)
    serve_sweeps = cfg2k.GIBBS_BURN_IN + cfg2k.GIBBS_SWEEPS
    pt_serve = torch.tensor(cfg2k.initial_pt_betas(), dtype=torch.float32,
                            device=dev).repeat_interleave(cfg2k.NUM_READS)
    plan_b, st_b = flag_states["bf16"]
    plan_pt, st_pt = flag_states["bf16 PT"]
    shapes = {  # mode: (args, description)
        "K1-bf16": ((st_b.sampler_h, st_b.sampler_coupling, plan_b, st_b.chains,
                     flag_cfg.GIBBS_SWEEPS, 1.0), "flagship training"),
        "K1-bf16-dE": ((st_pt.sampler_h, st_pt.sampler_coupling, plan_pt,
                        st_pt.chains.reshape(-1, plan_pt.n_pad), flag_cfg.GIBBS_SWEEPS,
                        st_pt.pt_betas.repeat_interleave(flag_cfg.NUM_READS)),
                       "flagship PT training"),
        "K1-int8": ((hp_s, c_s, plan_s, random_spins(gk, plan_s, 256, dev), serve_sweeps, 1.0),
                    "2,048-latent serving"),
        "K1-int8-dE": ((hp_s, c_s, plan_s, random_spins(gk, plan_s, pt_serve.shape[0], dev),
                        cfg2k.GIBBS_SWEEPS, pt_serve), "2,048-latent PT serving round"),
    }
    kernels = []
    for dtype, de in K1_MODES:
        name = k1_mode(dtype, de)
        args, what = shapes[name]
        n_c, n_sw = args[3].shape[0], args[4]
        ms = cuda_ms(lambda: k1(*args, generator=gk, track_delta_e=de), 10, warmup=2)
        plain_ms = cuda_ms(lambda: plain(*args, generator=gk, track_delta_e=de), 3, warmup=1)
        bound = sweep_bound(args[2], stored_bytes(args[1]), PEAK_OPS[dtype], n_c, n_sw, de)
        rows = gibbs_cuda.default_rows(args[2], n_c, K1_DTYPES[dtype])
        print(f"[21] {name} {n_c} chains x {n_sw} sweeps ({what}, n_pad {args[2].n_pad}, R={rows}): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0] * 1e3:.3f} us ({bound[1]}); "
              f"dense-product work {2 * n_c * n_sw * args[2].n_pad ** 2 / 1e9:.2f} G  [{card}]")
        kernels.append({
            "name": f"gibbs_sweeps ({name})",
            "mode": name,
            "route": "cuda",
            "source": "image_generation_tpu_torch/csrc/gibbs_sweeps.cu",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:" + ("121" if de else "141"),
            "launches": 0,  # filled in from the paths below
            "max_abs_err": errs[name],
            "tolerance": f">= {CHAIN_RULE:.0%} of chains bit-identical to the plain version"
                         + ("; dE within 1e-3*(1+|E|) on identical chains" if de else ""),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": None,
            "shape": f"{n_c} chains x {n_sw} sweeps, n_pad {args[2].n_pad} ({what})",
        })
    # rows per thread block at the 2,048-latent serving shape (measured, not tuned)
    s_serve = random_spins(gk, plan_s, 256, dev)
    for dtype, c in (("int8", c_s), ("bf16", dequantize_coupling(c_s).to(torch.bfloat16))):
        row = []
        for r in sorted(gibbs_cuda._ROWS):
            ms_r = cuda_ms(lambda: k1(hp_s, c, plan_s, s_serve, serve_sweeps, generator=gk,
                                      _rows_per_block=r), 3, warmup=1)
            row.append(f"R={r}: {ms_r:.4f} ms")
        dflt = gibbs_cuda.default_rows(plan_s, 256, K1_DTYPES[dtype])
        print(f"[21] K1-{dtype} 256 chains x {serve_sweeps} sweeps (2,048-latent serving shape) by "
              f"rows per block (default R={dflt}): {'; '.join(row)}  [{card}]")
    paths = {"train_2k": train2k_counts, "resume_2k": resume_counts, "serve_2k": serve2k_counts,
             "serve_2k_pt": serve2k_pt_counts, **flag_paths}
    for entry in kernels:
        entry["launches"] = sum(cnt.get(entry["mode"], 0) for cnt in paths.values())
    return {"paths": paths, "kernels": kernels}


# the scaled configuration with its graph split over 4 ranks on one card
GS_RANKS = 4
GS_SCALED = dict(SCALED, GRAPH_SHARDED="on")
K4_REPLACES = "image_generation_tpu/ops/gibbs_graph_sharded_pallas.py:127"


def span_bound(rows: int, width: int, per_row_beta: bool, fed: bool):
    """(bound ms, "bytes") of one K4 launch: fields in and spins out (and
    the fed uniforms), 4 B each, plus beta and the seed, at HBM bandwidth;
    its handful of f32 operations per element take far less."""
    nbytes = 4.0 * rows * width * (3 if fed else 2) + 4.0 * (rows if per_row_beta else 1) + 8
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def launch_counts() -> dict:
    """Every kernel's launches since the last reset: K1-K3 by mode, K4 and
    K4f."""
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update

    return {**read_counts(gibbs_cuda, gibbs_hbm_cuda), **span_update.launches}


def reset_launch_counts() -> None:
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import span_update

    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    span_update.launches.clear()


def _gs_rank(rank: int, world: int, port: int, out_dir: str, task: str, task_arg) -> None:
    """One rank of the graph-sharded phases: joins the gloo world on
    cuda:0, builds the (1, world) mesh, runs ``task`` and writes its
    result to ``out_dir/<task>_<rank>.json``."""
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.mesh import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # not inherited from the parent
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=300))
    try:
        mesh = create_mesh(shape=(1, world), backend="gloo")
        result = {"scaled": _gs_scaled, "p32": _gs_p32}[task](mesh, task_arg)
        (Path(out_dir) / f"{task}_{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def _gs_scaled(mesh, model_dir: str) -> dict:
    """Phase 23 on one rank: the scaled model trained one epoch with its
    graph split over the mesh, saved, sampled; the fed cross-check against
    the single-device K3; two dense steps."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.models.grbm import scaled_ising
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.ops.gibbs import permuted_model
    from image_generation_tpu_torch.ops.gibbs_graph_sharded import gibbs_sweeps_graph_sharded
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda
    from image_generation_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda", 0)
    cfg = TrainingConfig(**GS_SCALED)
    tr = Trainer(cfg, device=dev, mesh=mesh)
    tr.setup()
    plan = tr.plan
    lo, hi = mesh.window(plan.n_pad)
    times, last = [], [0.0]

    def on_batch(_epoch, _done, _nb):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    tr.train_init(1)  # burn-in: part of the path
    torch.cuda.synchronize()
    mesh.comm_seconds, mesh.comm_calls = 0.0, 0
    t0 = last[0] = time.perf_counter()
    tr.train(1, batch_cb=on_batch, epoch_chunks=tr.n_batches)
    epoch_s = time.perf_counter() - t0
    comm_s, comm_calls = mesh.comm_seconds, mesh.comm_calls
    counts = launch_counts()
    st = tr.state
    cp = st.sampler_coupling
    out = {
        "impl": tr.fns.sampler_impl, "losses": tr.losses["dvae_losses"],
        "mse": tr.losses["mse_losses"], "step_s": times, "epoch_s": epoch_s,
        "comm_s": comm_s, "comm_calls": comm_calls, "counts": counts,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "chains": list(st.chains.shape), "window": [lo, hi],
        "coupling": f"{type(cp).__name__} shard {cp.shard} of {cp.n_shards}, panels "
                    f"{tuple(cp.panels.shape)} {cp.panels.dtype}, {stored_bytes(cp)} bytes",
        "coupling_bytes": stored_bytes(cp), "n_batches": tr.n_batches,
    }
    reset_launch_counts()
    tr.save(model_dir)
    spins = tr.sample_spins(64)
    out["sample_counts"] = launch_counts()
    out["sample"] = [list(spins.shape), float(spins.abs().min()), float(spins.abs().max()),
                     float(spins.double().sum())]
    out["saved"] = sorted(q.name for q in Path(model_dir).iterdir())

    # the 4-rank sweep with fed uniforms against the single-device K3
    l_loc = hi - lo
    flat = st.chains.reshape(-1, l_loc)
    beta = st.pt_betas.repeat_interleave(cfg.NUM_READS)
    g = torch.Generator(device=dev)
    g.manual_seed(123)  # the same uniforms on every rank
    u = torch.rand((4, flat.shape[0], plan.n_pad), generator=g, device=dev)
    sharded = gibbs_sweeps_graph_sharded(st.sampler_h, cp, plan, flat, 4, mesh, beta,
                                         uniforms=u, matmul_dtype=tr.fns.mm_dtype)
    gathered = mesh.all_gather(sharded, dim=-1)
    whole = tr.fns.gather(flat)
    if mesh.graph_index == 0:
        h, j = scaled_ising(st.grbm_params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE)
        hp, a = permuted_model(plan, h, j)
        packed = pack_coupling(plan, a.to(tr.fns.mm_dtype), cfg.SWEEP_BS_CHUNK)
        del a
        single = gibbs_sweeps_hbm_cuda(hp, packed, plan, whole, 4, beta, uniforms=u)
        torch.cuda.synchronize()
        out["cross_identical"] = identical_fraction(gathered, single)
        out["cross_max_abs"] = float((gathered - single).abs().max())
        del packed, single
    del u, sharded, gathered, whole
    graph, physical, images, source = tr.graph, tr.physical_nodes, tr.images, tr.data_source
    batch = images[: cfg.BATCH_SIZE]
    del tr, st, cp, flat
    torch.cuda.empty_cache()

    # two unscheduled steps with dense row blocks (SWEEP_BLOCK_SPARSE="off")
    k2 = Trainer(cfg.replace(SWEEP_BLOCK_SPARSE="off"), device=dev, mesh=mesh)
    k2.graph, k2.plan, k2.physical_nodes = graph, plan, physical
    k2.images, k2.data_source = images, source
    reset_launch_counts()
    k2.train_init(1)
    dense_losses, dense_times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_losses.append(k2.step(batch, 6))  # epoch 6: no GRBM update
        torch.cuda.synchronize()
        dense_times.append(time.perf_counter() - t0)
    c2 = k2.state.sampler_coupling
    out.update(dense_impl=k2.fns.sampler_impl, dense_losses=dense_losses,
               dense_step_s=dense_times, dense_counts=launch_counts(),
               dense_coupling=[list(c2.shape), str(c2.dtype)])
    return out


def _gs_p32(mesh, graph) -> dict:
    """Phase 24 on one rank: the ideal Pegasus P32 fabric, this rank's rows
    built from the edge list; dense bf16 sweeps, then packed bf16 and int8."""
    from image_generation_tpu_torch.ops.block_sparse_sharded import pack_coupling_graph_sharded
    from image_generation_tpu_torch.ops.gibbs import build_plan, permuted_model_rows, random_spins
    from image_generation_tpu_torch.ops.gibbs_graph_sharded import (
        gibbs_sweeps_graph_sharded,
        ising_energies_graph_sharded,
    )
    from image_generation_tpu_torch.ops.quant import quantize_coupling

    dev = torch.device("cuda", 0)
    plan = build_plan(graph)
    lo, hi = mesh.window(plan.n_pad)
    q = torch.tensor(0.1 * np.random.default_rng(0).normal(size=graph.n_edges),
                     dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    hp, rows = permuted_model_rows(plan, torch.zeros(graph.n, device=dev), q, lo, hi)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    s0 = random_spins(g, plan, 64, dev)[:, lo:hi].contiguous()
    out = {"n": plan.n, "n_pad": plan.n_pad, "blocks": len(plan.blocks),
           "couplers": int(graph.n_edges), "rows_f32_bytes": stored_bytes(rows)}
    packed_i8 = pack_coupling_graph_sharded(plan, quantize_coupling(rows, mesh=mesh), mesh, 128)
    bf16 = rows.to(torch.bfloat16)
    del rows
    packed = pack_coupling_graph_sharded(plan, bf16, mesh, 128)
    build_s = time.perf_counter() - t0
    for name, c, n_sw in (("dense bf16", bf16, 2), ("packed bf16", packed, 2),
                          ("packed int8", packed_i8, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = gibbs_sweeps_graph_sharded(hp, c, plan, s0, n_sw, mesh, generator=g,
                                       matmul_dtype=torch.bfloat16)
        e = ising_energies_graph_sharded(hp, c, s, mesh, matmul_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out[name] = {"bytes": stored_bytes(c), "sweeps": n_sw,
                     "seconds": time.perf_counter() - t0,
                     "energies_finite": bool(torch.isfinite(e).all()),
                     "e_mean": float(e.mean()), "spins_ok": bool((s.abs() == 1).all())}
    out.update(build_s=build_s, peak_bytes=torch.cuda.max_memory_allocated(),
               counts=launch_counts())
    return out


def _spawn_ranks(task: str, task_arg, out_dir: Path) -> list:
    """Run ``task`` on GS_RANKS processes on cuda:0 (gloo) and return each
    rank's result; an exception in any rank fails the run."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_gs_rank, args=(GS_RANKS, port, str(out_dir), task, task_arg),
                       nprocs=GS_RANKS, join=True, start_method="spawn")
    return [json.loads((out_dir / f"{task}_{r}.json").read_text()) for r in range(GS_RANKS)]


def graph_sharded_phases(dev, card: str) -> dict:
    """Phases 22-25: K4 against its plain version; the scaled model trained
    with GRAPH_SHARDED="on" on 4 gloo ranks on this card; the P32 fabric on
    them; K4's times.  Returns the launch counts of each path and K4's JSON
    entry."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops.gibbs import build_plan, class_spans
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
        load_library,
        philox_span_uniforms,
        span_update,
        span_update_reference,
    )
    from image_generation_tpu_torch.utils.graph_cache import (
        cached_latent_graph,
        graph_from_topology,
    )
    from image_generation_tpu_torch.utils.subgraph import select_latent_graph
    from image_generation_tpu_torch.utils.topology import pegasus_graph

    cfg = TrainingConfig(**GS_SCALED)
    graph, _ = cached_latent_graph(cfg.QPU, cfg.N_LATENTS, cfg.RANDOM_SEED)
    plan = build_plan(graph)
    widths = [b - a for a, b, _b0, _b1 in class_spans(plan)]
    c_path = cfg.PT_NUM_BETAS * cfg.NUM_READS

    # ---- 22. K4 against its plain version --------------------------------------
    load_library()
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    max_err, checked = 0.0, 0
    for rows in (1, 37, c_path):
        u_all = torch.rand((2, rows, plan.n_pad), generator=g, device=dev)
        beta = 0.2 + 1.8 * torch.rand(rows, generator=g, device=dev)
        for (start, stop, _b0, _b1) in class_spans(plan):
            f = 3.0 * torch.randn((rows, stop - start), generator=g, device=dev)
            for b in (1.0, beta):
                u = u_all[1, :, start:stop]  # the span's columns of a sweep: a strided view
                out = span_update(f, b, uniforms=u)
                ref = span_update_reference(f, b, uniforms=u)
                torch.cuda.synchronize()
                check(torch.equal(out, ref), f"K4 fed != plain ({rows} x {stop - start})")
                max_err = max(max_err, float((out - ref).abs().max()))
                checked += 1
        del u_all
    for rows in (1, 64):
        f = 3.0 * torch.randn((rows, 23936), generator=g, device=dev)
        u = torch.rand((rows, 23936), generator=g, device=dev)
        check(torch.equal(span_update(f, 0.9, uniforms=u),
                          span_update_reference(f, 0.9, uniforms=u)),
              f"K4 fed != plain ({rows} x 23936)")
        checked += 1
    f = 3.0 * torch.randn((c_path, max(widths)), generator=g, device=dev)
    beta = 0.2 + 1.8 * torch.rand(c_path, generator=g, device=dev)
    seed = torch.tensor([0x5EED5EED1234], dtype=torch.int64, device=dev)
    out = span_update(f, beta, seed=seed, row0=64, col0=2816, sweep=3)
    u = torch.tensor(philox_span_uniforms(0x5EED5EED1234, 3, 64, c_path, 2816, max(widths)),
                     device=dev)
    check(torch.equal(out, span_update_reference(f, beta, uniforms=u)),
          "K4 Philox != plain fed philox_span_uniforms")
    print(f"[22] K4 fed entry bit-identical to the plain version in {checked} checks (rows 1, 37, "
          f"{c_path} x span widths {widths}, scalar and per-chain beta, strided uniforms; rows "
          f"1 and 64 x 23936); Philox entry at row 64, column 2816, sweep 3 equal to the plain "
          f"version fed philox_span_uniforms ({c_path} x {max(widths)})")

    # ---- 23. the scaled slice, graph-sharded on 4 gloo ranks on this card -------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gs_"))
    try:
        t0 = time.perf_counter()
        res = _spawn_ranks("scaled", str(tmp / "scaled_sharded"), tmp)
        spawn_s = time.perf_counter() - t0
        r0 = res[0]
        print(f"[23] 4 ranks (gloo, 4 processes on cuda:0, mesh (1, 4)) in {spawn_s:.1f} s: "
              f"sampler {r0['impl']}; rank windows {[r['window'] for r in res]}; chains "
              f"{r0['chains']} a rank; coupling {r0['coupling']}")
        for r, x in enumerate(res):
            print(f"[23] rank {r}: losses {x['losses']}; launches {x['counts']}; step times (ms) "
                  f"{', '.join(f'{t * 1e3:.3f}' for t in x['step_s'])}; collectives "
                  f"{x['comm_calls']} calls, {x['comm_s']:.3f} s of the {x['epoch_s']:.3f} s "
                  f"epoch; peak memory {x['peak_gib']:.3f} GiB  [{card}]")
        check(all(x["impl"] == "torch_graph_sharded+plrng+bs" for x in res),
              "the graph-sharded scaled trainer did not select K4 with packed shards")
        check([x["window"] for x in res] == [[r * plan.n_pad // 4, (r + 1) * plan.n_pad // 4]
                                             for r in range(GS_RANKS)],
              "rank windows are not the quarters of n_pad")
        check(all(x["chains"][-1] == plan.n_pad // 4 for x in res), "chains are not a quarter")
        for x in res:
            check(len(x["losses"]) == x["n_batches"] and bool(np.isfinite(x["losses"]).all()),
                  "sharded training losses")
            check(x["losses"] == r0["losses"] and x["mse"] == r0["mse"],
                  "the ranks' losses differ")
            check(x["counts"].get("K4", 0) > 0, "a rank never launched K4")
            check(not any(k.startswith(("K1", "K2", "K3")) for k in x["counts"]),
                  "a rank launched K1, K2 or K3 on the graph-sharded path")
            check(x["sample_counts"].get("K4", 0) > 0
                  and not any(k.startswith(("K1", "K2", "K3")) for k in x["sample_counts"]),
                  "sample_spins did not run through K4 alone")
            check(x["sample"] == r0["sample"], "the ranks sampled different spins")
            check(x["dense_impl"] == "torch_graph_sharded+plrng", "dense steps: sampler")
            check(x["dense_coupling"] == [[plan.n_pad // 4, plan.n_pad], "torch.bfloat16"],
                  "dense row block is not a quarter of the coupling")
            check(x["dense_counts"].get("K4", 0) > 0
                  and not any(k.startswith(("K1", "K2", "K3")) for k in x["dense_counts"]),
                  "dense steps did not run through K4 alone")
            check(bool(np.isfinite(x["dense_losses"]).all())
                  and x["dense_losses"] == r0["dense_losses"], "dense step losses")
        check(r0["sample"][0] == [64, plan.n] and r0["sample"][1:3] == [1.0, 1.0],
              "sample_spins(64) shape or values")
        check(r0["saved"] == ["dvae.pth", "grbm.pth", "losses.json", "parameters.json"],
              "rank 0 did not save the model directory")
        print(f"[23] saved on rank 0: {r0['saved']}; sample_spins(64): {r0['sample'][0]} "
              f"on every rank alike; launches {r0['sample_counts']}")
        print(f"[23] fed 4-rank sweep vs single-device K3 ({c_path} chains x 4 sweeps, same "
              f"chains and uniforms): {r0['cross_identical']:.4f} of chains identical, "
              f"max|diff| {r0['cross_max_abs']}")
        check(r0["cross_identical"] >= CHAIN_RULE, "4-rank sweep vs single-device K3")
        print(f"[23] SWEEP_BLOCK_SPARSE='off': {r0['dense_impl']}, coupling {r0['dense_coupling']}"
              f" a rank; MSE {r0['dense_losses']}; launches {r0['dense_counts']}; step times (ms) "
              f"{', '.join(f'{t * 1e3:.3f}' for t in r0['dense_step_s'])}  [{card}]")

        # ---- 24. the P32 fabric beyond one card's dense coupling -----------------
        full = pegasus_graph(32)
        latent, _ = select_latent_graph(full, full.number_of_nodes(), 7)
        res32 = _spawn_ranks("p32", graph_from_topology(latent), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x0 = res32[0]
    whole_f32 = 4 * x0["n_pad"] ** 2
    print(f"[24] P32: n={x0['n']} couplers={x0['couplers']} n_pad={x0['n_pad']} "
          f"blocks={x0['blocks']}; the whole f32 coupling {whole_f32 / 1e9:.3f} GB")
    for r, x in enumerate(res32):
        line = "; ".join(f"{k} {x[k]['bytes'] / 1e9:.3f} GB, {x[k]['sweeps']} sweeps "
                         f"{x[k]['seconds']:.3f} s, E finite {x[k]['energies_finite']}"
                         for k in ("dense bf16", "packed bf16", "packed int8"))
        print(f"[24] rank {r}: f32 rows {x['rows_f32_bytes'] / 1e9:.3f} GB (built in "
              f"{x['build_s']:.3f} s); {line}; peak memory {x['peak_bytes'] / 1e9:.3f} GB; "
              f"launches {x['counts']}  [{card}]")
        check((x["n"], x["couplers"], x["n_pad"], x["blocks"]) == (23560, 172964, 23936, 187),
              "the P32 fabric differs from the JAX demo's")
        check(x["rows_f32_bytes"] * GS_RANKS == whole_f32, "a rank's rows are not a quarter")
        check(x["peak_bytes"] < whole_f32, "a rank's peak memory reached the whole matrix")
        for k in ("dense bf16", "packed bf16", "packed int8"):
            check(x[k]["energies_finite"] and x[k]["spins_ok"], f"P32 {k}: energies or spins")
            check(x[k]["bytes"] < whole_f32, f"P32 {k}: coupling bytes")
        check(x["counts"].get("K4", 0) > 0
              and not any(k.startswith(("K1", "K2", "K3")) for k in x["counts"]),
              "the P32 sweeps did not run through K4 alone")

    # ---- 25. times ------------------------------------------------------------
    g.manual_seed(25)
    per_span, tot_ms, tot_plain, tot_bound = [], 0.0, 0.0, 0.0
    beta = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32,
                        device=dev).repeat_interleave(cfg.NUM_READS)
    for w in widths:
        f = 3.0 * torch.randn((c_path, w), generator=g, device=dev)
        u = torch.rand((c_path, w), generator=g, device=dev)
        ms = cuda_ms(lambda: span_update(f, beta, seed=seed), 50, warmup=3)
        plain_ms = cuda_ms(lambda: span_update_reference(f, beta, uniforms=u), 20, warmup=2)
        bound = span_bound(c_path, w, True, False)[0]
        per_span.append(f"{w}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound * 1e3:.3f} us)")
        tot_ms, tot_plain, tot_bound = tot_ms + ms, tot_plain + plain_ms, tot_bound + bound
    n_spans = len(widths)
    # the device's own time per launch: back-to-back launches of a kernel
    # this short can be paced by the wrapper's host work, not the card
    from torch.profiler import ProfilerActivity, profile

    f = 3.0 * torch.randn((c_path, max(widths)), generator=g, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            span_update(f, beta, seed=seed)
        torch.cuda.synchronize()
    k4_events = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "span_update" in e.key]
    n_ev = sum(e.count for e in k4_events)
    device_us = sum(e.self_device_time_total for e in k4_events) / n_ev if n_ev else None
    print(f"[25] K4 device time per launch by torch.profiler at {c_path} x {max(widths)}: "
          + (f"{device_us:.3f} us over {n_ev} launches" if n_ev else "not recorded")
          + f"  [{card}]")
    steps = [t for x in res for t in x["step_s"]]
    med = float(np.median(r0["step_s"]))
    share = [x["comm_s"] / x["epoch_s"] for x in res]
    print(f"[25] K4 (Philox, per-chain beta) per launch at {c_path} rows by span width: "
          f"{'; '.join(per_span)}; mean over the {n_spans} spans of a sweep {tot_ms / n_spans:.4f}"
          f" ms, plain {tot_plain / n_spans:.4f} ms, bound {tot_bound / n_spans * 1e3:.3f} us "
          f"(bytes)  [{card}]")
    print(f"[25] graph-sharded scaled step (gloo, 4 processes on one card; not a multi-GPU "
          f"number): rank 0 median {med * 1e3:.3f} ms over {len(r0['step_s'])} steps (all ranks' "
          f"steps {min(steps) * 1e3:.3f}-{max(steps) * 1e3:.3f} ms); host-clock share of the "
          f"collectives in the epoch by rank {', '.join(f'{s:.1%}' for s in share)}  [{card}]")
    paths = {"train_scaled_sharded": _sum_counts(x["counts"] for x in res),
             "sample_scaled_sharded": _sum_counts(x["sample_counts"] for x in res),
             "train_scaled_sharded_dense": _sum_counts(x["dense_counts"] for x in res),
             "p32_sharded": _sum_counts(x["counts"] for x in res32)}
    kernel = {
        "name": "span_update (K4)",
        "mode": "K4",
        "route": "cuda",
        "source": "image_generation_tpu_torch/csrc/span_update.cu",
        "replaces": K4_REPLACES,
        "launches": paths["train_scaled_sharded"].get("K4", 0),
        "launches_by_rank": [x["counts"].get("K4", 0) for x in res],
        "max_abs_err": max_err,
        "tolerance": "bit-identical to the plain version (fed and Philox)",
        "ms": tot_ms / n_spans,
        "plain_ms": tot_plain / n_spans,
        "bound_ms": tot_bound / n_spans,
        "bound_by": "bytes",
        "library_ms": None,
        "device_us_by_profiler": device_us,
        "shape": f"{c_path} rows x a class span of the scaled plan (widths {widths}), Philox, "
                 f"per-chain beta; mean per launch over a sweep's {n_spans} spans",
    }
    return {"paths": paths, "kernels": [kernel]}


def _sum_counts(counts) -> dict:
    total: dict = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# a 12-spin test graph: a ring plus chords (unique, no self-loops)
SMALL_EDGES = [(i, (i + 1) % 12) for i in range(12)] + [(i, i + 4) for i in range(0, 8, 2)] + [
    (1, 6), (3, 10), (5, 11)]


if __name__ == "__main__":
    sys.exit(main())
