#!/usr/bin/env python3
"""Time the sweep kernels (K1, K2, K3, K4) and the serving and training runs around them on one CUDA card.

    python3 stream_times.py [--root DIR] [--out FILE] [--only k1,flagship,sweeps,train,k4,f32]

Imports ``image_generation_tpu_torch`` from ``--root`` (default: this
script's directory), so that two commits of the port can be timed on one
card in one call: unpack the other one with ``git archive`` into a
directory ``.gitignore`` lists and pass it as the root (run them in turns:
parent, change, change, parent).  It needs only the entry points every
commit of the port since its scaled slice has: ``gibbs_sweeps_cuda``,
``gibbs_sweeps_hbm_cuda``, ``WarmGenerator`` and ``Trainer``.  Measured,
with random |J| <= 1 models (the served checkpoint's own for K1 at the
serving shapes) and spins drawn from fixed seeds:

* K1 in f32 and bf16 at the flagship paths' shapes, by CUDA events over 10
  calls after a warm-up: 256 and 4,096 chains x 80 sweeps on the served
  checkpoint's plan (n_pad 640), 256 chains x 16 sweeps and, with the
  energy carry under the 8-rung ladder's beta, 2,048 x 16 on the fresh
  flagship plan (n_pad 768); and K1f, f32 with fed uniforms, at 256 x 80;
* the warm request (256 images from ``runs/models/tpu_digits_40_epochs``),
  host clock: median and p90 of 100 after the warm-up;
* flagship training, plain Gibbs and parallel tempering (8 rungs): one
  epoch each, the median step after 4 warm-up steps (host clock after
  ``torch.cuda.synchronize``);
* the streaming route in its bf16 modes at the paths' shapes, by CUDA
  events over 5 calls after a warm-up: K3-bf16 and K3-bf16-dE (the scaled
  plan, 5,640 latents, n_pad 6,016, packed at chunk 256) and K2-bf16 and
  K2-bf16-dE (its dense matrix) at 2,048 chains x 4 sweeps under the
  32-rung ladder's beta; K2-bf16 on the 2,048-latent plan (n_pad 2,432) at
  256 chains x 16 sweeps, the shape that configuration trains at;
* scaled PT training (``bench.py --scaled``'s configuration): two epochs
  through K3, the median step after the first two (host clock after
  ``torch.cuda.synchronize``); four unscheduled steps with
  ``SWEEP_BLOCK_SPARSE="off"`` (K2), the median of the last three;
* the 2,048-latent configuration: one epoch, its wall time and median
  step;
* K4 at the graph-sharded scaled shapes (2,048 chain rows, the 4-rank
  mesh's windows of 1,504 columns, a bf16 carry, ΔE, Philox, the 32-rung
  ladder's beta), by CUDA events over 20 calls after a warm-up and on the
  host clock (the enqueue alone): the whole-span entry ``span_update`` at
  each class-span width; one sweep's update on each rank after the
  all-reduce, as the sweep composed it around ``span_update`` (the
  span's fields, the whole-span update, the slice, ΔE and the write for
  the 7 spans) and, where the tree has it, through ``SpanWindowUpdate``
  (one launch per owned span).  Every commit since the graph-sharded
  slice has ``span_update``, so the composed run times the other tree's
  K4 at the same shapes;
* the streaming route in f32 (``f32``), by CUDA events over 5 calls after
  a warm-up: K2-f32 and K3-f32 (packed at chunk 256), each with and
  without the energy carry, at 2,048 chains x 4 sweeps under the 32-rung
  ladder's beta on the scaled plan; on the 1,280-latent Advantage2_system1
  plan (n_pad 1,664) K2-f32 at 256 chains x 80 sweeps (a request) and x
  16 (a training refresh) and K2-f32-dE at 2,048 x 16 (the 8-rung PT
  refresh); then the 1,280-latent default configuration trained one epoch
  under plain Gibbs (saved) and one under PT (the median step after 4
  warm-up steps each, host clock after ``torch.cuda.synchronize``) and
  the saved model served: the lone request's median and p90 over 20
  after the warm-up.

Prints the card's name and power limit (``nvidia-smi``), one line per
number, and last one JSON object of them all (also written to ``--out``).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = ROOT / "runs" / "models" / "tpu_digits_40_epochs"
SCALED = dict(QPU="Advantage_system6", N_LATENTS=5640, NUM_READS=64, BATCH_SIZE=1024,
              N_REPLICAS=2, SAMPLER="pt", PT_NUM_BETAS=32, PT_BETA_MIN=0.2, GIBBS_SWEEPS=4,
              GIBBS_BURN_IN=4)
LATENTS2K = dict(QPU="Advantage_system6", N_LATENTS=2048)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k1_times(dev, out: dict) -> None:
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io.checkpoint import load_model_dir
    from image_generation_tpu_torch.models.grbm import scaled_ising
    from image_generation_tpu_torch.ops.gibbs import build_plan, permuted_model, random_spins
    from image_generation_tpu_torch.ops.gibbs_cuda import gibbs_sweeps_cuda as k1
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    cfg = TrainingConfig()
    _, params, graph, _, _ = load_model_dir(MODEL, dev)
    plan = build_plan(graph)
    served = permuted_model(plan, *scaled_ising(params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE))
    fgraph, _ = cached_latent_graph(cfg.QPU, cfg.N_LATENTS, cfg.RANDOM_SEED)
    fplan = build_plan(fgraph)
    rng = np.random.default_rng(256)
    flagship = permuted_model(
        fplan, torch.tensor(rng.uniform(-0.5, 0.5, fgraph.n), dtype=torch.float32, device=dev),
        torch.tensor(rng.uniform(-1.0, 1.0, fgraph.n_edges), dtype=torch.float32, device=dev))
    ladder = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32, device=dev)
    serve_sweeps = cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS
    g = torch.Generator(device=dev)
    for label, kplan, (hp, a), chains, sweeps, de in (
            ("serving", plan, served, 256, serve_sweeps, False),
            ("serving", plan, served, 4096, serve_sweeps, False),
            ("flagship", fplan, flagship, 256, cfg.GIBBS_SWEEPS, False),
            ("flagship PT", fplan, flagship, 2048, cfg.GIBBS_SWEEPS, True)):
        g.manual_seed(chains + sweeps)
        s = random_spins(g, kplan, chains, dev)
        beta = ladder.repeat_interleave(chains // len(ladder)) if de else 1.0
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            c = a.to(dtype)
            ms = cuda_ms(lambda: k1(hp, c, kplan, s, sweeps, beta, generator=g, track_delta_e=de),
                         10)
            key = f"K1-{name}{'-dE' if de else ''} {chains}x{sweeps} n_pad {kplan.n_pad}"
            out[key + " ms"] = ms
            print(f"[times] {key} ({label}): {ms:.4f} ms", flush=True)
        if chains == 256 and label == "serving":  # K1f: the fed entry at the serving shape
            u = torch.rand((sweeps, chains, kplan.n_pad), generator=g, device=dev)
            ms = cuda_ms(lambda: k1(hp, a, kplan, s, sweeps, uniforms=u), 10)
            key = f"K1f-f32 {chains}x{sweeps} n_pad {kplan.n_pad}"
            out[key + " ms"] = ms
            print(f"[times] {key} (serving, fed uniforms): {ms:.4f} ms", flush=True)


def flagship_times(dev, out: dict) -> None:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.trainer import Trainer

    w = WarmGenerator(ROOT / "runs", device=dev)
    w.warm_buckets(MODEL, 1)
    lat = []
    for _ in range(100):
        t0 = time.perf_counter()
        w.serve(MODEL)
        lat.append((time.perf_counter() - t0) * 1e3)
    out["warm request median ms"] = float(np.median(lat))
    out["warm request p90 ms"] = float(np.percentile(lat, 90))
    print(f"[times] warm request (256 images, {w._trainer.fns.sampler_impl}), 100 after the "
          f"warm-up: median {out['warm request median ms']:.3f} ms, p90 "
          f"{out['warm request p90 ms']:.3f} ms", flush=True)
    del w
    base = None
    for label, overrides in (("flagship plain", {}), ("flagship PT", dict(SAMPLER="pt"))):
        tr = Trainer(config=TrainingConfig(**overrides), device=dev)
        if base is None:
            tr.setup()
            base = tr
        else:
            tr.graph, tr.plan, tr.physical_nodes = base.graph, base.plan, base.physical_nodes
            tr.images, tr.data_source = base.images, base.data_source
        times, _wall = _epoch_steps(tr)
        med = float(np.median(times[4:]))
        out[f"{label} step median ms"] = med * 1e3
        print(f"[times] {label} training ({tr.fns.sampler_impl}): {len(times)} steps, median "
              f"after 4 {med * 1e3:.3f} ms; steps (ms) {', '.join(f'{t * 1e3:.3f}' for t in times)}",
              flush=True)
    del base, tr
    torch.cuda.empty_cache()


def _epoch_steps(tr, epochs: int = 1):
    """(seconds of each step of ``epochs`` epochs, seconds of the epochs
    after ``train_init``), host clock after ``torch.cuda.synchronize``."""
    times, last = [], [0.0]

    def cb(_epoch, _done, _nb):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    tr.train_init(epochs)
    torch.cuda.synchronize()
    t0 = last[0] = time.perf_counter()
    tr.train(epochs, batch_cb=cb, epoch_chunks=tr.n_batches)
    return times, time.perf_counter() - t0


def sweep_times(dev, out: dict) -> None:
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.ops.gibbs import build_plan, permuted_model, random_spins
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda as stream
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    cfg = TrainingConfig(**SCALED)
    ladder = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32,
                          device=dev).repeat_interleave(cfg.NUM_READS)
    g = torch.Generator(device=dev)
    for n_latents, chains, sweeps, beta, forms in (
            (5640, 2048, 4, ladder, ("K3", "K2")), (2048, 256, 16, 1.0, ("K2",))):
        graph, _ = cached_latent_graph("Advantage_system6", n_latents, cfg.RANDOM_SEED)
        plan = build_plan(graph)
        rng = np.random.default_rng(n_latents)
        hp, a = permuted_model(
            plan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1.0, 1.0, graph.n_edges), dtype=torch.float32, device=dev))
        a = a.to(torch.bfloat16)
        g.manual_seed(n_latents)
        s = random_spins(g, plan, chains, dev)
        for kernel in forms:
            c = pack_coupling(plan, a, cfg.SWEEP_BS_CHUNK) if kernel == "K3" else a
            for de in ((False, True) if n_latents == 5640 else (False,)):
                ms = cuda_ms(lambda: stream(hp, c, plan, s, sweeps, beta, generator=g,
                                            track_delta_e=de))
                key = (f"{kernel}-bf16{'-dE' if de else ''} {chains}x{sweeps} "
                       f"n_pad {plan.n_pad}")
                out[key + " ms"] = ms
                print(f"[times] {key}: {ms:.4f} ms", flush=True)


def train_times(dev, out: dict) -> None:
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.trainer import Trainer

    for label, overrides, epochs in (("scaled PT", SCALED, 2), ("2,048-latent", LATENTS2K, 1)):
        tr = Trainer(config=TrainingConfig(**overrides), device=dev)
        times, wall = _epoch_steps(tr, epochs)
        med = float(np.median(times[2:]))
        out[f"{label} step median ms"] = med * 1e3
        out[f"{label} {epochs}-epoch wall s"] = wall
        print(f"[times] {label} training ({tr.fns.sampler_impl}): {len(times)} steps, median "
              f"after 2 {med * 1e3:.3f} ms, {epochs} epoch(s) {wall:.3f} s; steps (ms) "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times)}", flush=True)
        if label == "scaled PT":
            k2 = Trainer(config=TrainingConfig(**SCALED).replace(SWEEP_BLOCK_SPARSE="off"),
                         device=dev)
            k2.graph, k2.plan, k2.physical_nodes = tr.graph, tr.plan, tr.physical_nodes
            k2.images, k2.data_source = tr.images, tr.data_source
            k2.train_init(1)
            batch = tr.images[: k2.config.BATCH_SIZE]
            steps = []
            for _ in range(4):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                k2.step(batch, 6)  # epoch 6: no scheduled GRBM update
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t1)
            med = float(np.median(steps[1:]))
            out["scaled PT K2-path step median ms"] = med * 1e3
            print(f"[times] scaled PT, SWEEP_BLOCK_SPARSE='off' ({k2.fns.sampler_impl}): median of "
                  f"3 unscheduled steps after 1 {med * 1e3:.3f} ms", flush=True)
            del k2
        del tr
        torch.cuda.empty_cache()


def k4_times(dev, out: dict) -> None:
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops import gibbs_graph_sharded_cuda as k4
    from image_generation_tpu_torch.ops.gibbs import build_plan, class_spans
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    cfg = TrainingConfig(**SCALED)
    graph, _ = cached_latent_graph(cfg.QPU, cfg.N_LATENTS, cfg.RANDOM_SEED)
    plan = build_plan(graph)
    rows, ranks = cfg.PT_NUM_BETAS * cfg.NUM_READS, 4
    l_loc = plan.n_pad // ranks
    beta = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32,
                        device=dev).repeat_interleave(cfg.NUM_READS)
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    seed = torch.tensor([0x5EED5EED1234], dtype=torch.int64, device=dev)
    hp = torch.randn(plan.n_pad, generator=g, device=dev)
    spans = [(a, b) for a, b, _b0, _b1 in class_spans(plan)]
    partials = {span: 3.0 * torch.randn((rows, span[1] - span[0]), generator=g, device=dev)
                for span in spans}
    for w in sorted({b - a for a, b in spans}):
        f = partials[next(span for span in spans if span[1] - span[0] == w)]
        ms = cuda_ms(lambda: k4.span_update(f, beta, seed=seed), 20)
        out[f"K4 whole span {rows}x{w} ms"] = ms
        print(f"[times] K4 whole-span entry {rows} x {w} (Philox, f32 out): {ms:.4f} ms",
              flush=True)

    def host_us(fn, reps: int = 20) -> float:
        """Host microseconds per call, the enqueue alone (no synchronise)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    for r in range(ranks):
        lo, hi = r * l_loc, (r + 1) * l_loc
        s = torch.where(torch.rand((rows, l_loc), generator=g, device=dev) < 0.5, 1.0,
                        -1.0).to(torch.bfloat16)
        de = torch.zeros(rows, device=dev)
        owned = [(a, b) for a, b in spans if max(a, lo) < min(b, hi)]

        def composed():  # the sweep's epilogue around the whole-span entry
            nonlocal de
            for a, b in spans:
                fields = partials[(a, b)] + hp[a:b]
                new = k4.span_update(fields, beta, seed=seed, row0=0, col0=a, sweep=1)
                x0, x1 = max(a, lo), min(b, hi)
                if x0 >= x1:
                    continue
                mine = new[:, x0 - a: x1 - a]
                old = s[:, x0 - lo: x1 - lo].to(torch.float32)
                de = de + (fields[:, x0 - a: x1 - a] * (mine - old)).sum(-1)
                s[:, x0 - lo: x1 - lo] = mine.to(s.dtype)

        key = f"K4 rank {r} sweep composed"
        out[key + " ms"], out[key + " host us"] = cuda_ms(composed, 20), host_us(composed)
        line = (f"[times] K4 one sweep on rank {r} (window [{lo}, {hi}), {len(owned)} owned "
                f"spans of 7): composed around span_update {out[key + ' ms']:.4f} ms, host "
                f"{out[key + ' host us']:.1f} us")
        if hasattr(k4, "SpanWindowUpdate"):
            upd = k4.SpanWindowUpdate(s, lo, beta, h=hp, seed=seed, delta_e=de)

            def window():
                for a, b in owned:
                    upd(partials[(a, b)], a, b, 1)

            key = f"K4 rank {r} sweep window"
            out[key + " ms"], out[key + " host us"] = cuda_ms(window, 20), host_us(window)
            line += (f"; owned-window kernel {out[key + ' ms']:.4f} ms, host "
                     f"{out[key + ' host us']:.1f} us")
        print(line, flush=True)


def f32_times(dev, out: dict) -> None:
    import shutil
    import tempfile

    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops.block_sparse import pack_coupling
    from image_generation_tpu_torch.ops.gibbs import build_plan, permuted_model, random_spins
    from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda as stream
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    scaled = TrainingConfig(**SCALED)
    ladder32 = torch.tensor(scaled.initial_pt_betas(), dtype=torch.float32,
                            device=dev).repeat_interleave(scaled.NUM_READS)
    ladder8 = torch.tensor(TrainingConfig().initial_pt_betas(), dtype=torch.float32,
                           device=dev).repeat_interleave(256)
    g = torch.Generator(device=dev)
    for qpu, n_latents, cases in (
            ("Advantage_system6", 5640, (("K2", 2048, 4, ladder32, False),
                                         ("K2", 2048, 4, ladder32, True),
                                         ("K3", 2048, 4, ladder32, False),
                                         ("K3", 2048, 4, ladder32, True))),
            ("Advantage2_system1", 1280, (("K2", 256, 80, 1.0, False),
                                          ("K2", 256, 16, 1.0, False),
                                          ("K2", 2048, 16, ladder8, True)))):
        graph, _ = cached_latent_graph(qpu, n_latents, scaled.RANDOM_SEED)
        plan = build_plan(graph)
        rng = np.random.default_rng(n_latents + 11)
        hp, a = permuted_model(
            plan, torch.tensor(rng.uniform(-0.5, 0.5, graph.n), dtype=torch.float32, device=dev),
            torch.tensor(rng.uniform(-1.0, 1.0, graph.n_edges), dtype=torch.float32, device=dev))
        packed = pack_coupling(plan, a, scaled.SWEEP_BS_CHUNK)
        for kernel, chains, sweeps, beta, de in cases:
            g.manual_seed(chains + sweeps)
            s = random_spins(g, plan, chains, dev)
            c = packed if kernel == "K3" else a
            ms = cuda_ms(lambda: stream(hp, c, plan, s, sweeps, beta, generator=g,
                                        track_delta_e=de))
            key = f"{kernel}-f32{'-dE' if de else ''} {chains}x{sweeps} n_pad {plan.n_pad}"
            out[key + " ms"] = ms
            print(f"[times] {key}: {ms:.4f} ms", flush=True)
        del a, packed
        torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="stream_times_1280_"))
    try:
        base = None
        for label, overrides in (("1,280-latent plain", {}), ("1,280-latent PT", dict(SAMPLER="pt"))):
            tr = Trainer(config=TrainingConfig(N_LATENTS=1280, **overrides), device=dev)
            if base is None:
                tr.setup()
                base = tr
            else:
                tr.graph, tr.plan, tr.physical_nodes = base.graph, base.plan, base.physical_nodes
                tr.images, tr.data_source = base.images, base.data_source
            times, _wall = _epoch_steps(tr)
            med = float(np.median(times[4:]))
            out[f"{label} step median ms"] = med * 1e3
            print(f"[times] {label} training ({tr.fns.sampler_impl}): {len(times)} steps, median "
                  f"after 4 {med * 1e3:.3f} ms; steps (ms) "
                  f"{', '.join(f'{t * 1e3:.3f}' for t in times)}", flush=True)
            if label == "1,280-latent plain":
                tr.save(tmp / "latents1280")
        del base, tr
        w = WarmGenerator(tmp, device=dev)
        w.warm_buckets(tmp / "latents1280", 1)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            w.serve(tmp / "latents1280")
            lat.append((time.perf_counter() - t0) * 1e3)
        out["1,280-latent request median ms"] = float(np.median(lat))
        out["1,280-latent request p90 ms"] = float(np.percentile(lat, 90))
        print(f"[times] 1,280-latent request (256 images, {w._trainer.fns.sampler_impl}), 20 after "
              f"the warm-up: median {out['1,280-latent request median ms']:.3f} ms, p90 "
              f"{out['1,280-latent request p90 ms']:.3f} ms", flush=True)
        del w
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


SECTIONS = ("k1", "flagship", "sweeps", "train", "k4", "f32")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                    help="the checkout whose image_generation_tpu_torch is timed")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON object here")
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help=f"comma-separated sections to time, of {', '.join(SECTIONS)}")
    args = ap.parse_args()
    only = args.only.split(",")
    if not set(only) <= set(SECTIONS):
        ap.error(f"--only takes {', '.join(SECTIONS)}")
    if not torch.cuda.is_available():
        print("stream_times: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import image_generation_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[times] card: {card}; port from {Path(image_generation_tpu_torch.__file__).parent}",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card, "root": str(args.root)}
    for name, fn in (("k1", k1_times), ("flagship", flagship_times), ("sweeps", sweep_times),
                     ("train", train_times), ("k4", k4_times), ("f32", f32_times)):
        if name in only:
            fn(dev, out)
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
