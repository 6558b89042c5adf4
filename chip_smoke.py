#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, time.

    python3 chip_smoke.py

Drives ``image_generation_tpu_torch`` (never JAX) through its warm serving
path on ``runs/models/tpu_digits_40_epochs`` (256 latents, the flagship
checkpoint, at full width; the weights are the checkpoint's).  Phases:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   nvcc; exits non-zero without a CUDA device;
2. builds the sweep kernel K1 from ``csrc/`` and prints the build time and
   the ptxas report;
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
   with the card's name and power limit.

The line before the last is a JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
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


def main() -> int:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io.checkpoint import load_model_dir
    from image_generation_tpu_torch.models.dvae import DVAE
    from image_generation_tpu_torch.models.grbm import GRBMGraph, scaled_ising
    from image_generation_tpu_torch.ops import gibbs_cuda
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, gibbs_sweeps_reference, permuted_model, random_spins, to_original,
    )
    from image_generation_tpu_torch.training.step import make_sample_fns

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

    # ---- 2. build K1 --------------------------------------------------
    t0 = time.perf_counter()
    built = gibbs_cuda.load_library()
    how = (f"built by nvcc in {built.build_seconds:.2f} s" if built.build_seconds
           else "found already built (no nvcc run)")
    print(f"[2] K1 {how}, loaded after {time.perf_counter() - t0:.2f} s "
          f"-> {built.path.relative_to(ROOT)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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
    gibbs_cuda.gibbs_sweeps_cuda.launches = 0
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
    launches = gibbs_cuda.gibbs_sweeps_cuda.launches
    burst_dispatches = w.stats["dispatches"] - before
    trainer = w._trainer
    print(f"[5] warmed group sizes {warmed}; sampler {trainer.fns.sampler_impl}; "
          f"K1 launches {launches}; burst of 4 in {burst_dispatches} dispatch(es); stats {w.stats}")
    check(trainer.fns.sampler_impl == "cuda_gibbs", "the warm server did not select K1")
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w.serve(MODEL)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[6] profiled warm request: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}), idle share {1 - busy_ms / wall_ms:.1%}  [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[6]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "gibbs_sweeps (K1)",
        "route": "cuda",
        "source": "image_generation_tpu_torch/csrc/gibbs_sweeps.cu",
        "replaces": "image_generation_tpu/ops/gibbs_pallas.py:141",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "tolerance": f">= {CHAIN_RULE:.0%} of chains bit-identical to the plain version",
        "ms": k1_ms,
        "plain_ms": twin_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# a 12-spin test graph: a ring plus chords (unique, no self-loops)
SMALL_EDGES = [(i, (i + 1) % 12) for i in range(12)] + [(i, i + 4) for i in range(0, 8, 2)] + [
    (1, 6), (3, 10), (5, 11)]


if __name__ == "__main__":
    sys.exit(main())
