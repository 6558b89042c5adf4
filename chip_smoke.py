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
Advantage_system6 (the config defaults otherwise: a dense bf16 coupling
through K2-bf16, the gather kernel, in training; served int8 through
K1-int8; one epoch, resumed for a second) and the flagship with ``SAMPLER_MATMUL_DTYPE`` "bfloat16" and
"int8" (one epoch each); and the config defaults at 1,280 latents on
Advantage2_system1 (n_pad 1,664, too large for K1 in f32: a dense f32
coupling through K2-f32, the gather, in plain Gibbs, PT and serving; one
epoch each, at full width).  Phases:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   nvcc; exits non-zero without a CUDA device;
2. builds the kernels from ``csrc/``, two sources (the gather kernel
   ``gibbs_sparse.cu``, which takes K1, K2 and K3 in every value type, and
   K4's ``span_update.cu``; one ``nvcc`` per source, started together) and
   prints the build time and the ptxas report (registers and spills of
   every instantiation);
3. K1 (the gather, f32) against its plain PyTorch version with fed
   uniforms, on the checkpoint's plan at 80 sweeps and at 256·k chains for
   k = 1, 2, 4, 8, 16 (the serving group sizes at which the default chains
   per thread block, G, takes each of its values), with the checkpoint's
   scaled model and with |J| up to 1 and per-chain β: no chain may differ
   from the gather's plain version (the same f32 sums in the same order),
   at least 98% must be bit-identical to the dense plain version (another
   summation order, so a draw within an ulp of its probability may flip
   and the chain then diverges), and every G the kernel is built for must
   have been checked;
4. K1's in-kernel Philox: against the plain version fed the same Philox
   stream (no chain differing), and its moments against exact
   enumeration on a 12-spin graph at 4096 chains;
5. the slice: ``WarmGenerator(device="cuda")`` warms up, answers
   a lone request and a 4-way burst through K1 (the launch counter must
   move, fewer dispatches than requests, images (256, 32, 32, 1) finite in
   [0, 1]); the fused path's uint8 images against the plain pipeline on
   fed inputs;
6. times (CUDA events for kernels, host clock for requests), K1 by
   launch shape (G × threads 128 to 1,024) at 256 and 4,096 chains x 80
   sweeps, and a ``torch.profiler`` breakdown of one request by kernel
   (the gather's two kernels must appear), each printed with the card's
   name and power limit;
7. K1 with the energy carry (K1-ΔE) against its plain versions, fed
   uniforms, at 256 chains (β = 1) and 2,048 chains (the 8-rung ladder's
   per-chain β), 16 and 80 sweeps, for the checkpoint's model and a
   |J| ≤ 1 model on the fresh flagship plan: the rules of phase 3, and on
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
10. one unscheduled step of each sampler under ``torch.profiler`` (the
    gather's two kernels must appear);
11. K1 and K1-ΔE timed at the training shapes (CUDA events) beside the
    plain version and the least time the card could take (``sweep_bound``,
    on the bytes the gather reads and on the stored form), K1 with fed
    uniforms (K1f) at the serving shape, and K1 / K1-ΔE by launch shape
    at 256 and 2,048 chains x 16 sweeps on the fresh flagship plan;
12. K2 and K3 against their plain versions with fed uniforms on the
    scaled plan (47 color blocks, chunk 256 with the final chunk clamped):
    f32, bf16 and int8, each with and without ΔE, 256 chains at β = 1 and
    2,048 chains at the 32-rung ladder's per-chain β, 4 sweeps and 3 (run
    as 4), every mode the gather kernel, against the gather's plain
    version (f32: no chain differing; int8, bf16: >= 99.9 % of chains
    identical; the fraction printed), the f32 and bf16 modes also against
    the dense plain version ``gibbs_sweeps_hbm_reference`` (the chain
    rule, the fraction printed), the ΔE rule (1e-3·(1 + |E|)); K3 equal to
    K2 bit for bit on an integer-valued coupling; K3-int8 against the
    dense plain version at 256 chains x 80 sweeps (>= 99.9 %, printed);
    Philox mode against ``philox_uniforms`` (f32: no chain differing);
    moments against exact enumeration on the 12-spin graph through both
    kernels in f32 and in bf16 (the bf16-rounded model);
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
    sweeps; the served K3-int8 at 256 chains × 80 sweeps) beside the
    gather's plain version and ``sweep_bound`` on the bytes the gather
    reads (its table and the nonzeros) and on the stored form (dense,
    packed or int8 bytes; nonzeros from the plan's edge list);
    K3-bf16-dE and K2-f32-dE by launch shape at 2,048 x 4; the served K3-int8 by launch
    shape at 256 and 1,024 chains x 80 sweeps and 2,048 x 4 (G × threads
    128 to 1,024); one scaled step under the profiler;
17. K1-bf16 and K1-int8 (the gather) against the gather's plain version
    with fed uniforms, with and without dE: on the fresh flagship plan at
    256 chains (beta = 1) and 2,048 (the 8-rung ladder's per-chain beta)
    x 16 sweeps, and on the 2,048-latent plan (n_pad 2,432) at 256·k
    chains, k = 1, 2, 4, 8, 16 (every launch shape serving selects) x 80
    sweeps; no K1-bf16 chain may differ (the int8 modes: the chain rule),
    and K1-bf16 against the dense plain version under the chain rule; the
    dE rule (1e-3·(1 + |E|)); K1-int8 against the dense plain version at
    256 chains x 80 sweeps (>= 99.9 %, printed); Philox mode against
    ``philox_uniforms``;
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
    shapes beside the plain version and ``sweep_bound`` (on both the
    gather's bytes and the stored form), and K2-bf16 at the 2,048-latent
    training shape (the trained model's coupling and chains, 256 x 16,
    both bounds); by launch shape, K1-bf16 and K1-bf16-dE at the flagship
    shapes (256 and 2,048 chains x 16 sweeps) and K1-int8 at 256 and
    1,024 chains x 80 sweeps and 2,048 x 16 on the 2,048-latent plan;
22. the span-update kernel K4 against its plain version: the owned-window
    entry at 1, 37 and 2,048 chain rows on every window the 4-rank mesh
    gives the scaled plan and, at each class-span width, a window inside
    the span, straddling its left or right edge and covering it; in the
    f32, bf16 and int8 carries, with the span's products (f32, or int32
    totals and a scale) and without, scalar and per-chain beta, fed (a
    strided plane) and Philox: spins bit-identical, ΔE within
    1e-4·(1 + |ΔE|); the int8 fields rounded twice (not one fma) on totals
    where the two differ; the whole-span entry bit-identical at every
    class-span width and a 23,936-wide row (the P32 fabric's n_pad), and
    its Philox mode equal to the plain version fed
    ``philox_span_uniforms`` at a global row, column and sweep offset; ΔE
    repeating itself: 20 launches from the same spins and a zeroed ΔE
    equal bit for bit at 2,048 rows on every window, in every carry;
23. the scaled configuration with ``GRAPH_SHARDED="on"`` on a (1, 4) mesh:
    4 processes on cuda:0 (``torch.multiprocessing``), joined by a gloo
    process group (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through the host, so this is a real distributed run but not a
    multi-GPU measurement), each with TF32 off.  Each rank holds a quarter
    of the coupling rows (packed on its shard-local grid, bf16) and of the
    chain columns; one epoch (4 steps plus burn-in) through K4
    (``torch_graph_sharded+plrng+bs``), saved on rank 0, ``sample_spins(64)``;
    on every rank K4 launched exactly once for each (sweep, class span)
    the rank owns columns of, and K1/K2/K3 never, finite losses equal on
    all ranks; the 4-rank sweep with fed uniforms against the
    single-device K3 on the same chains (chain rule); two steps with
    ``SWEEP_BLOCK_SPARSE="off"`` (dense bf16 row blocks of 1,504 x 6,016);
24. the ideal Pegasus P32 fabric (23,560 spins, n_pad 23,936; the whole f32
    coupling is 2.29 GB) on the same 4 ranks, each building only its rows
    from the edge list: 64 chains x 2 sweeps dense bf16, then packed at
    chunk 128 in bf16 and in int8 (1 sweep), energies finite; each rank's
    coupling bytes and peak device memory below the whole f32 matrix;
25. K4 at the scaled path's owned windows (every rank's, 2,048 rows, bf16
    carry, ΔE, Philox, per-chain beta): per launch by CUDA events, by the
    profiler's device time and on the host clock, beside its bound (the
    owned window's bytes) and its plain version; its launches per rank in
    the epoch; the whole-span entry at each class-span width; the sharded
    step's median and the host clock's share of the collectives in it
    (gloo, 4 processes on one card);
26. (in a fresh process spawned after phase 21: in the main process,
    after the earlier phases, the profiler recorded none of the step's
    sweep launches) the 1,280-latent configuration (the config defaults with
    ``N_LATENTS=1280`` on Advantage2_system1, n_pad 1,664; batch 128, 8
    replicas, 256 chains x 16 sweeps): one epoch of plain Gibbs through
    K2-f32 and one of 8-rung PT through K2-f32-dE (``cuda_hbm``, K1 never
    launched, finite losses, carried ladder energies against
    ``ising_energies`` recomputed on the card), one profiled step of each
    (the gather's two kernels must appear), the model saved and served
    through ``WarmGenerator`` (256 x 80, every dispatch K2-f32; 256 finite
    images in [0, 1]; the lone-request latency over 10; a profiled
    request); K2-f32 and K2-f32-dE fed at the path's shapes against the
    gather's plain version (no chain differing) and the dense plain
    version (the chain rule), timed at 256 x 80, 256 x 16 and 2,048 x 16
    beside both bounds and by launch shape; the step medians;
27. (in a fresh process, as phase 26) the CLI on the card at the
    flagship's full width (the config defaults: 256 latents on
    Advantage2_system1, batch 128, 256 reads, 16 sweeps; ``--dataset-size
    4096``, 32 steps), each command through ``cli.main`` in one workdir:
    ``train --name flag --epochs 1``, ``generate --model flag``, ``generate
    --model runs/models/tpu_digits_40_epochs``, ``generate --model flag
    --sampler pt``, ``tune --model flag --epochs 1``, ``refresh --model
    flag``, ``tune-pt --model flag --iters 1 --chains 256``, ``models``.
    After each: the gather kernel's launch counters moved (``models``
    samples nothing), no plain sweep version ran on a CUDA tensor, the
    command's files exist, the images it generated are finite and in
    [0, 1], ``pt_betas.json`` ascends to 1.0; each command's host seconds
    beside the card's name and power limit;
28. (in a fresh process, as phase 26) the web app: ``make_server(...,
    warm_generate=True)`` on an ephemeral port in a thread, a workdir
    holding copies of ``runs/models/tpu_digits_40_epochs`` and
    ``tpu_digits_10_epochs``, ``--dataset-size 4096`` passed through.
    ``GET /`` equals ``_render_page()``, ``/api/models`` lists both;
    ``POST /api/generate_now`` for the 40-epoch model, one first request,
    10 lone ones (the HTTP round trip's median and the server's
    ``latency_ms``), the group sizes 1–16 warmed (``warm_buckets``), then a
    burst of 16 concurrent ones (``batched``, the coalescer's dispatches): K1-f32 launched exactly once a dispatch, no
    plain sweep version on a CUDA tensor, every figure's z finite in [0,
    255] and 256 images; a warm ``POST /api/generate`` job to done with its
    files; ``POST /api/train`` (``--epochs 1``): the port's CLI in a
    subprocess on the card, to done with rc 0 and ``models/web_flag/dvae.pth``,
    timed; ``/api/render/generated/0.png`` a PNG of the grid's size,
    ``/api/render/loss_mse/0.svg``, both models' topology SVGs (physical
    coordinates and the spring layout); a started ``train`` job cancelled
    (state failed).  Then ``evaluate_checkpoint`` of the 40-epoch model at
    its defaults (2,048 images, 256 reads, 4 rounds): K1-f32 launched,
    every metric finite, ``image_mmd`` beside its floor and noise (the
    card's pool is synthetic digits, not ``runs/generation_quality.json``'s).
29. the rest of training. (a)-(b), in a fresh process as phase 26: a
    flagship epoch in the gumbel latent mode (``GUMBEL_TAU=0.7``): K1-f32
    only, no plain sweep version on a CUDA tensor, the relaxed spins of a
    batch in [-1, 1] (f32 tanh rounds to +-1 beyond |x| ~ 9), finite
    losses; then the scaled PT configuration (phase 13's) seven epochs
    under each DVAE Adam moment lever (f32, ``ADAM_MOMENT_DTYPE="bfloat16"``,
    ``ADAM_FACTORED_NU="on"``, both): K3-bf16-dE launched and K1 never,
    finite losses, the optimizer's state bytes, the peak device memory and
    the step median after the first epoch (24 steps), the levers' state
    below 0.55 of the one they halve.
    (c) the flagship on 4 processes sharing cuda:0 (gloo), on the (2, 2)
    mesh ``Trainer()`` picks in that world and on (4, 1): one plain and
    one 8-rung PT epoch each, data-parallel batches and chains split over
    the mesh; on every rank K1-f32 (K1-f32-dE) on its 64 (512) rows exactly
    as often as the one-process epochs of phases 8 and 9 launched them, no
    plain sweep version on a CUDA tensor, the losses equal and the DVAE
    and GRBM parameters bit-equal across ranks; the same for a plain epoch
    of 254 chains, which do not tile 4 ranks (``sampler_impl`` ``torch`` as
    JAX's ``xla``, K1-f32 on each rank's 127 or 254 rows), and its
    ``sample_spins(10)``: K1-f32 on 5 or 10 rows, the same spins on every
    rank; one step fed the same
    uniforms on the mesh and in one process within the JAX package's
    tolerances for its sharded step (MSE 1e-4, loss 1e-3, < 0.5 % spins,
    parameters 5e-4); each rank's step median and the collectives' host
    seconds (not a multi-GPU measurement).
30. the scaled configuration on the data axis (4 processes sharing cuda:0,
    gloo; a rehearsal of the mesh, not a multi-GPU measurement). (a) the
    scaled PT configuration (phase 13's, 4,096 images: 4 steps) one epoch
    on (2, 2) and on (4, 1): its decoder's Linear(5640 -> 22560)
    column-sharded, a quarter of it and of its Adam moments a rank; per
    rank the layer's bytes, the DVAE optimizer's state bytes, the peak
    device memory, K3-bf16 1 (burn-in) + K3-bf16-dE 5 on 512 rows, the
    step median and the collectives' host seconds; the losses equal, the
    replicated parameters and the gathered layer bit-equal on every rank,
    no plain sweep on the card.  (b) one fed step on (4, 1) against the
    same step in one process within phase 29's tolerances.  (c) ``save``
    on (2, 2): ``dvae.pth`` holds the gathered layer; one process serves
    it through K3-int8.  (d) ``save_native`` on (2, 2): the global state
    in the one-device schema; restored on (2, 2), over the (4, 1) run's
    state and in one process, equal to the file bit for bit; the resumed
    (2, 2) run equal to the uninterrupted one.  (e) the flagship with
    ``PT_NUM_BETAS="auto"`` on (2, 2): the same ladder on every rank, the
    K1-f32-dE probe on each.  (f) ``parallel/dryrun.py --ranks 4`` on the
    card.  (g) with 4 cards, (a) again over NCCL, one card a rank;
    otherwise the line ``[30g] nccl: not run (1 card)``.

Each path (serving, plain training, PT training, scaled training, the K2
steps, scaled serving, the 2,048-latent training, resume and serving, the
flagship bf16 / int8 epochs, on every rank the graph-sharded epoch,
its sampling, its dense steps and the P32 sweeps, the 1,280-latent
training, PT training and serving, each CLI command, the server's lone
requests, burst, generate job and the evaluation, the gumbel epoch, each
Adam lever's scaled epoch, on every rank each data-axis epoch, each scaled
mesh epoch and the fed step, the mesh-saved model's request, the auto
ladder on the mesh) runs with the launch counters set to 0 just before it
and read just after; the dry run's ranks count their own.  The line before
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
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODEL = ROOT / "runs" / "models" / "tpu_digits_40_epochs"
CHAIN_RULE = 0.98  # least fraction of chains bit-identical to the plain version
# the gather kernel against its own plain version: the same sums in the same
# order, so every chain is expected identical; this is the least fraction held
# on the streaming route (K2, K3); K1's f32 and bf16 modes are held to it
# exactly (no chain differing)
GATHER_RULE = 0.999
# the least fraction of chains the streaming route's modes hold against the
# gather's plain version: f32 none differing, as K1-f32
TWIN_RULE = {"f32": 1.0, "bf16": GATHER_RULE, "int8": GATHER_RULE}
GATHER_SOURCE = "image_generation_tpu_torch/csrc/gibbs_sparse.cu"
VALUE_BYTES = {"f32": 4, "int8": 1, "bf16": 2}
SHAPE_THREADS = (128, 256, 512, 1024)  # threads per block the launch-shape sweeps time
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


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Chains (rows) of ``a`` not bit-identical to ``b``."""
    return int((~(a == b).all(dim=1)).sum())


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


def gather_bytes(plan, chunk=None, value_bytes: int = 1) -> int:
    """Bytes the gather kernel must read of the coupling: its neighbour
    table (two int32 words a slot), the nonzeros (``value_bytes`` each: 1
    int8, 2 bf16; both directions of every edge) and the class spans."""
    from image_generation_tpu_torch.ops.gibbs import class_spans
    from image_generation_tpu_torch.ops.gibbs_sparse import neighbor_table

    nbr, _off = neighbor_table(plan, chunk)
    return (8 * nbr.size + 2 * value_bytes * len(plan.perm_edge_i)
            + 8 * len(class_spans(plan)))


def shape_sweep(run, plan, tag: str, label: str, cases, card: str) -> dict:
    """Time the gather kernel at every launch shape (chains per block G,
    threads per block of ``SHAPE_THREADS``) for each (chains, sweeps) of
    ``cases``, on spins drawn here; ``run(spins, sweeps, shape)`` launches
    it once.  Prints one line per chain count beside the default
    ``launch_shape`` and returns {(chains, sweeps): {(G, threads): ms}}."""
    from image_generation_tpu_torch.ops import gibbs_sparse
    from image_generation_tpu_torch.ops.gibbs import random_spins

    gk = torch.Generator(device="cuda")
    gk.manual_seed(23)
    times = {}
    for n_c, n_sw in cases:
        s = random_spins(gk, plan, n_c, "cuda")
        by_shape = times[(n_c, n_sw)] = {}
        default = launch_shape(plan, n_c)
        for shape in sorted({(g, t) for g in gibbs_sparse._CHAINS for t in SHAPE_THREADS}
                            | {default}):
            by_shape[shape] = cuda_ms(lambda: run(s, n_sw, shape), 2, warmup=1)
        best = min(by_shape, key=by_shape.get)
        row = [f"G={g}/T={t}: {ms:.4f} ms" for (g, t), ms in by_shape.items()]
        print(f"[{tag}] {label} {n_c} chains x {n_sw} sweeps by launch shape (default "
              f"{default}: {by_shape[default]:.4f} ms; fastest {best}: {by_shape[best]:.4f} ms): "
              f"{'; '.join(row)}  [{card}]")
    return times


def launch_shape(plan, n_chains: int):
    """The gather's default launch shape on this card's SM count."""
    from image_generation_tpu_torch.ops import gibbs_sparse

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return gibbs_sparse.launch_shape(plan, n_chains, sms)


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


def _epoch_step_times(trainer, stats: Optional[dict] = None, epochs: int = 1) -> list:
    """``epochs`` epochs (``train_init`` then ``train``) with a
    CUDA-synchronised host clock around every step; returns the step times
    (s) and puts the last epoch's statistics into ``stats``."""
    times, last = [], [0.0]

    def on_batch(_epoch, _done, _nb):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    trainer.train_init(epochs)
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    trainer.train(epochs, batch_cb=on_batch, epoch_chunks=trainer.n_batches,
                  epoch_cb=lambda _e, st: (stats if stats is not None else {}).update(st))
    return times


def timed_epoch(trainer, label: str, card: str, require_fall: bool = True):
    """One epoch, a CUDA-synchronised host clock around every step:
    (the epoch's statistics, the median step after 4 warm-up steps).
    Raises unless the losses are finite and, with ``require_fall``, the
    last 8 steps' MSE is below the first 8's."""
    stats = {}
    times = _epoch_step_times(trainer, stats)
    mses = trainer.losses["mse_losses"]
    med = float(np.median(times[4:]))
    print(f"[{label}] {len(mses)} steps on '{trainer.data_source.origin}' data: loss finite "
          f"{bool(np.isfinite(trainer.losses['dvae_losses']).all())}; MSE first 8 "
          f"{np.mean(mses[:8]):.5f}, last 8 {np.mean(mses[-8:]):.5f}; step median "
          f"{med * 1e3:.3f} ms (after 4 warm-up steps, n = {len(times) - 4}), "
          f"{trainer.config.BATCH_SIZE / med:.1f} images/s  [{card}]")
    check(bool(np.isfinite(trainer.losses["dvae_losses"]).all()), f"[{label}] losses not finite")
    check(not require_fall or np.mean(mses[-8:]) < np.mean(mses[:8]),
          f"[{label}] MSE did not fall")
    return stats, med


def main() -> int:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io.checkpoint import load_model_dir
    from image_generation_tpu_torch.models.dvae import DVAE
    from image_generation_tpu_torch.models.grbm import GRBMGraph, scaled_ising
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda, gibbs_sparse
    from image_generation_tpu_torch.ops.cuda_build import load_libraries
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, gibbs_sweeps_kernel_reference, ising_energies, permuted_model, random_spins,
        to_original,
    )
    from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse_reference
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

    # ---- 2. build every kernel (one nvcc per source, started together) ----
    t0 = time.perf_counter()
    libs = load_libraries()
    gibbs_sparse.load_library()
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
    shapes_checked = set()
    print(f"[3] plan: n={plan.n} n_pad={plan.n_pad} blocks={len(plan.blocks)} "
          f"couplers={graph.n_edges}; {sweeps} sweeps, fed uniforms")
    for n_c in SERVING_CHAINS:
        shape = launch_shape(plan, n_c)
        g3 = torch.Generator(device=dev)
        g3.manual_seed(n_c)
        s3 = random_spins(g3, plan, n_c, dev)
        u3 = torch.rand((sweeps, n_c, plan.n_pad), generator=g3, device=dev)
        beta3 = 0.5 + 1.5 * torch.rand(n_c, generator=g3, device=dev)
        for name, hp, a, beta in (("checkpoint model", hp_ckpt, a_ckpt, 1.0),
                                  ("|J|<=1, beta in [0.5, 2]", hp_strong, a_strong, beta3)):
            k1 = gibbs_cuda.gibbs_sweeps_cuda(hp, a, plan, s3, sweeps, beta, uniforms=u3)
            twin = gibbs_sweeps_sparse_reference(hp, a, plan, s3, sweeps, beta, uniforms=u3)
            dense = gibbs_sweeps_kernel_reference(hp, a, plan, s3, sweeps, beta, uniforms=u3)
            torch.cuda.synchronize()
            err = float((k1 - twin).abs().max())
            max_abs_err = max(max_abs_err, err)
            n_diff, frac = differing(k1, twin), identical_fraction(k1, dense)
            print(f"[3] {n_c} chains (G, threads {shape}), {name}: {n_diff}/{n_c} chains differ "
                  f"from the gather's plain version, max|K1-twin| {err}; {frac:.6f} identical "
                  f"to the dense plain version")
            check(n_diff == 0, f"K1 vs the gather's plain version ({n_c} chains, {name}): "
                  f"{n_diff} chains differ")
            check(frac >= CHAIN_RULE, f"K1 vs the dense plain version ({n_c} chains, {name}): "
                  f"only {frac:.4f} of chains identical")
        shapes_checked.add(shape[0])
        del u3
    check(shapes_checked == set(gibbs_sparse._CHAINS),
          f"chains per block checked {sorted(shapes_checked)}, built {sorted(gibbs_sparse._CHAINS)}")

    # ---- 4. Philox mode --------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    probe = torch.Generator(device=dev)
    probe.set_state(gen.get_state())
    seed = int(gibbs_cuda.draw_seed(probe, dev).item())
    n_ph = 8
    k1 = gibbs_cuda.gibbs_sweeps_cuda(hp_strong, a_strong, plan, s0, n_ph, beta_mixed, generator=gen)
    u_ph = torch.tensor(gibbs_cuda.philox_uniforms(seed, n_ph, chains, plan.n_pad), device=dev)
    twin = gibbs_sweeps_sparse_reference(hp_strong, a_strong, plan, s0, n_ph, beta_mixed,
                                         uniforms=u_ph)
    n_diff = differing(k1, twin)
    print(f"[4] Philox stream vs the gather's plain version fed philox_uniforms: "
          f"{n_diff}/{chains} chains differ ({n_ph} sweeps)")
    check(n_diff == 0, f"K1 Philox stream: {n_diff} chains differ")

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
    twin_ms = cuda_ms(lambda: gibbs_sweeps_sparse_reference(hp6, a6, plan, s6, sweeps,
                                                            generator=g6), 3, warmup=1)
    print(f"[6] K1 256 chains x {sweeps} sweeps: {k1_ms:.4f} ms; plain twin {twin_ms:.4f} ms  [{card}]")
    shape_sweep(lambda s_, n_, shape: gibbs_cuda.gibbs_sweeps_cuda(
        hp6, a6, plan, s_, n_, generator=g6, _shape=shape),
        plan, "6", "K1-f32 (serving, n_pad 640)", ((256, sweeps), (4096, sweeps)), card)
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
    profile_request(lambda: w.serve(MODEL), "6", "flagship", card, expect=GATHER_KERNELS)

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
                ref, de_ref = gibbs_sweeps_sparse_reference(hp, a, mplan, s7, n_sw, beta,
                                                            uniforms=u7, track_delta_e=True)
                dense = gibbs_sweeps_kernel_reference(hp, a, mplan, s7, n_sw, beta, uniforms=u7)
                torch.cuda.synchronize()
                same = (out == ref).all(dim=1)
                err = (de - de_ref).abs()[same]
                e_abs = ising_energies(hp, a, ref).abs()[same]
                limit = 1e-3 * (1 + e_abs) if strong else torch.full_like(err, 1e-4)
                de_err = max(de_err, float(err.max()))
                frac = identical_fraction(out, dense)
                print(f"[7] {name}, {n_c} chains (G, threads {launch_shape(mplan, n_c)}), "
                      f"{n_sw} sweeps: {int((~same).sum())}/{n_c} chains differ from the "
                      f"gather's plain version, max|dE err| {float(err.max()):.3e} (|E| up to "
                      f"{float(e_abs.max()):.1f}); {frac:.6f} identical to the dense plain version")
                check(bool(same.all()), f"K1-dE vs the gather's plain version ({name}, "
                      f"{n_c} x {n_sw}): chains differ")
                check(frac >= CHAIN_RULE, f"K1-dE vs the dense plain version ({name}, "
                      f"{n_c} x {n_sw}): only {frac:.4f} of chains identical")
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
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    flag = Trainer(device=dev)
    flag.setup()
    print(f"[8] setup: n={flag.graph.n} couplers={flag.graph.n_edges} "
          f"colors={len(flag.plan.blocks)} n_pad={flag.plan.n_pad} "
          f"sampler {flag.config.SAMPLER}, {flag.config.NUM_READS} chains")
    check((flag.graph.n, flag.graph.n_edges, flag.plan.n_pad, len(flag.plan.blocks))
          == (256, 2327, 768, 6), "the flagship graph or plan differs from the JAX package's")
    _, gibbs_step_s = timed_epoch(flag, "8", card)
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
    pt_stats, pt_step_s = timed_epoch(pt, "9", card)
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
        profile_step(t, batch, "10", label, card, expect=GATHER_KERNELS)

    # ---- kernel times at the training shapes ----------------------------------
    gk = torch.Generator(device=dev)
    gk.manual_seed(5)
    hp8, a8 = flag.state.sampler_h, flag.state.sampler_coupling
    flag_n_pad = flag.plan.n_pad
    s8 = flag.state.chains
    sw = flag.config.GIBBS_SWEEPS
    k1_train_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp8, a8, flag.plan, s8, sw,
                                                               generator=gk), 50)
    k1_train_plain = cuda_ms(lambda: gibbs_sweeps_sparse_reference(hp8, a8, flag.plan, s8, sw,
                                                                   generator=gk), 3, warmup=1)
    hp9, a9 = st.sampler_h, st.sampler_coupling
    s9 = st.chains.reshape(-1, pt.plan.n_pad)
    b9 = st.pt_betas.repeat_interleave(pt.config.NUM_READS)
    de_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp9, a9, pt.plan, s9, sw, b9,
                                                         generator=gk, track_delta_e=True), 50)
    de_plain = cuda_ms(lambda: gibbs_sweeps_sparse_reference(hp9, a9, pt.plan, s9, sw, b9,
                                                             generator=gk, track_delta_e=True),
                       3, warmup=1)
    u_serve = torch.rand((sweeps, 256, plan.n_pad), generator=gk, device=dev)
    k1f_ms = cuda_ms(lambda: gibbs_cuda.gibbs_sweeps_cuda(hp6, a6, plan, s6, sweeps,
                                                          uniforms=u_serve), 20)
    k1f_plain = cuda_ms(lambda: gibbs_sweeps_sparse_reference(hp6, a6, plan, s6, sweeps,
                                                              uniforms=u_serve), 3, warmup=1)
    del u_serve

    def bounds(bplan, coupling, chains, n_sw, de, meta=0):
        """(bound on the bytes the gather reads, bound on the stored form)."""
        return (sweep_bound(bplan, gather_bytes(bplan, None, VALUE_BYTES["f32"]), PEAK_F32_FLOPS,
                            chains, n_sw, de, meta),
                sweep_bound(bplan, stored_bytes(coupling), PEAK_F32_FLOPS, chains, n_sw, de, meta))

    k1_bound, k1_stored = bounds(flag.plan, a8, s8.shape[0], sw, False)
    de_bound, de_stored = bounds(pt.plan, a9, s9.shape[0], sw, True)
    serve_bound, serve_stored = bounds(plan, a6, 256, sweeps, False)
    k1f_bound, k1f_stored = bounds(plan, a6, 256, sweeps, False,
                                   4 * sweeps * 256 * plan.n_pad)  # the fed uniforms
    print(f"[11] K1 {s8.shape[0]} chains x {sw} sweeps (training, n_pad {flag.plan.n_pad}, G, "
          f"threads {launch_shape(flag.plan, s8.shape[0])}): {k1_train_ms:.4f} ms, plain "
          f"{k1_train_plain:.4f} ms, bound {k1_bound[0] * 1e3:.3f} us ({k1_bound[1]}), "
          f"stored-form bound {k1_stored[0] * 1e3:.3f} us ({k1_stored[1]})  [{card}]")
    print(f"[11] K1-dE {s9.shape[0]} chains x {sw} sweeps (PT training, G, threads "
          f"{launch_shape(pt.plan, s9.shape[0])}): {de_ms:.4f} ms, plain {de_plain:.4f} ms, bound "
          f"{de_bound[0] * 1e3:.3f} us ({de_bound[1]}), stored-form bound "
          f"{de_stored[0] * 1e3:.3f} us ({de_stored[1]})  [{card}]")
    print(f"[11] K1 256 chains x {sweeps} sweeps (serving, n_pad {plan.n_pad}, G, threads "
          f"{launch_shape(plan, 256)}): {k1_ms:.4f} ms, bound {serve_bound[0] * 1e3:.3f} us "
          f"({serve_bound[1]}), stored-form bound {serve_stored[0] * 1e3:.3f} us "
          f"({serve_stored[1]}); dense-product work "
          f"{2 * 256 * sweeps * plan.n_pad ** 2 / 1e9:.2f} GFLOP = "
          f"{2 * 256 * sweeps * plan.n_pad ** 2 / PEAK_F32_FLOPS * 1e3:.3f} ms at the f32 peak")
    print(f"[11] K1f (fed uniforms) 256 chains x {sweeps} sweeps (serving shape): {k1f_ms:.4f} ms, "
          f"plain {k1f_plain:.4f} ms, bound {k1f_bound[0] * 1e3:.3f} us ({k1f_bound[1]}), "
          f"stored-form bound {k1f_stored[0] * 1e3:.3f} us ({k1f_stored[1]})  [{card}]")
    # the launch shape at the flagship training shapes (measured, not tuned)
    shape_sweep(lambda s_, n_, shape: gibbs_cuda.gibbs_sweeps_cuda(
        hp8, a8, flag.plan, s_, n_, generator=gk, _shape=shape),
        flag.plan, "11", "K1-f32 (flagship training)", ((256, sw),), card)
    shape_sweep(lambda s_, n_, shape: gibbs_cuda.gibbs_sweeps_cuda(
        hp9, a9, pt.plan, s_, n_, b9, generator=gk, track_delta_e=True, _shape=shape),
        pt.plan, "11", "K1-f32-dE (flagship PT)", ((s9.shape[0], sw),), card)
    print(f"[11] step medians: plain Gibbs {gibbs_step_s * 1e3:.3f} ms, PT {pt_step_s * 1e3:.3f} ms"
          f"  [{card}]")
    del flag, pt, st, w, trainer
    torch.cuda.empty_cache()

    scaled = scaled_phases(dev, card, rng)
    torch.cuda.empty_cache()
    k1_dtypes = k1_dtype_phases(dev, card, rng)
    torch.cuda.empty_cache()
    latents1280 = run_in_fresh_process(_latents1280_child)
    sharded = graph_sharded_phases(dev, card)
    cli27 = run_in_fresh_process(_cli_child)
    server28 = run_in_fresh_process(_server_child)
    leftovers29 = run_in_fresh_process(_leftovers_child)
    data29 = data_axis_phase(card, {"gibbs": gibbs_counts, "pt": pt_counts})
    mesh30 = scaled_mesh_phase(card)

    print(card_line())
    paths = {"serving": serving_counts, "train_gibbs": gibbs_counts, "train_pt": pt_counts,
             **scaled["paths"], **k1_dtypes["paths"], **sharded["paths"],
             **latents1280["paths"], **cli27["paths"], **server28["paths"],
             **leftovers29["paths"], **data29["paths"], **mesh30["paths"]}
    print(json.dumps({"kernels": [
        {
            "name": "gibbs_sparse (K1-f32)",
            "route": "cuda",
            "source": GATHER_SOURCE,
            "kernel": "sparse_sweeps_kernel<float, G>",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:141",
            "launches": sum(v.get("K1-f32", 0) for v in paths.values()),
            "launches_by_path": {k: v.get("K1-f32", 0) for k, v in paths.items()},
            "max_abs_err": max_abs_err,
            "tolerance": "no chain differing from the gather's plain version; >= "
                         f"{CHAIN_RULE:.0%} of chains bit-identical to the dense plain version",
            "ms": k1_train_ms,
            "plain_ms": k1_train_plain,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "bound_stored_ms": k1_stored[0],
            "bound_stored_by": k1_stored[1],
            "library_ms": None,
            "shape": f"{s8.shape[0]} chains x {sw} sweeps, n_pad {flag_n_pad}",
            "serving_ms": k1_ms,
            "serving_bound_ms": serve_bound[0],
            "serving_bound_stored_ms": serve_stored[0],
            "serving_shape": f"256 chains x {sweeps} sweeps, n_pad {plan.n_pad}",
        },
        {
            "name": "gibbs_sparse with fed uniforms (K1f)",
            "route": "cuda",
            "source": GATHER_SOURCE,
            "kernel": "sparse_sweeps_kernel<float, G>, uniforms given",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:166",
            "launches": 0,  # no path feeds uniforms: the checks of phases 3, 5 and 7 do
            "max_abs_err": max_abs_err,
            "tolerance": "as K1-f32",
            "ms": k1f_ms,
            "plain_ms": k1f_plain,
            "bound_ms": k1f_bound[0],
            "bound_by": k1f_bound[1],
            "bound_stored_ms": k1f_stored[0],
            "bound_stored_by": k1f_stored[1],
            "library_ms": None,
            "shape": f"256 chains x {sweeps} sweeps, n_pad {plan.n_pad}, fed uniforms",
        },
        {
            "name": "gibbs_sparse with the energy carry (K1-f32-dE)",
            "route": "cuda",
            "source": GATHER_SOURCE,
            "kernel": "sparse_sweeps_kernel<float, G>, delta_e given",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:121",
            "launches": sum(v.get("K1-f32-dE", 0) for v in paths.values()),
            "launches_by_path": {k: v.get("K1-f32-dE", 0) for k, v in paths.items()},
            "max_abs_err": de_err,
            "tolerance": "chain rules as K1-f32; dE within 1e-4 (checkpoint model), "
                         "1e-3*(1+|E|) (|J|<=1 model) on identical chains",
            "ms": de_ms,
            "plain_ms": de_plain,
            "bound_ms": de_bound[0],
            "bound_by": de_bound[1],
            "bound_stored_ms": de_stored[0],
            "bound_stored_by": de_stored[1],
            "library_ms": None,
            "shape": f"{s9.shape[0]} chains x {sw} sweeps, n_pad {flag_n_pad}",
        },
        *[dict(entry, launches_by_path={k: v.get(entry["mode"], 0) for k, v in paths.items()})
          for entry in (scaled["kernels"] + k1_dtypes["kernels"] + sharded["kernels"]
                        + latents1280["kernels"])],
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


# the gather's two kernels, which every K1 launch runs
GATHER_KERNELS = ("sparse_sweeps_kernel", "gather_table_kernel")


def is_sweep_kernel(name: str) -> bool:
    """Whether a profiler kernel name is one of the sweep kernels: the
    gather (sparse_sweeps_kernel and its gather_table_kernel pass), which
    takes K1, K2 and K3 in every value type."""
    return any(k in name for k in GATHER_KERNELS)


def check_profiled(events, expect, tag: str, label: str) -> None:
    """Raise unless every kernel name of ``expect`` is among the profiled
    device events."""
    missing = [k for k in expect if not any(k in e.key for e in events)]
    check(not missing, f"[{tag}] the profiled {label} shows no {missing}")


def profile_request(serve, tag: str, label: str, card: str, expect=()) -> None:
    """One warm request under ``torch.profiler``: device busy share of the
    wall clock, the top kernels by device time and the sweep kernels among
    the rest; every name of ``expect`` must appear."""
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
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in ranked[:6] + [e for e in ranked[6:] if is_sweep_kernel(e.key)]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")
    check_profiled(events, expect, tag, f"{label} request")


def profile_step(trainer, batch, tag: str, label: str, card: str, expect=()) -> None:
    """One unscheduled training step under ``torch.profiler``: device busy
    share of the wall clock and the top kernels by device time; every
    name of ``expect`` must appear."""
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
    sweeps = [e for e in ranked[6:] if is_sweep_kernel(e.key)]  # if not in the top 6
    for e in ranked[:6] + sweeps:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:80]}")
    if not any(is_sweep_kernel(e.key) for e in ranked):
        print(f"[{tag}]   the profiler recorded no sweep kernel (see the CUDA-event times)")
    check_profiled(events, expect, tag, f"{label} training step")


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
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse, gibbs_sweeps_sparse_reference,
    )
    from image_generation_tpu_torch.ops.quant import quantize_coupling
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    stream = gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda
    dense_plain = gibbs_hbm_cuda.gibbs_sweeps_hbm_reference

    def plain(hp_, c_, plan_, s_, n_, beta_=1.0, **kw):
        """Every mode's plain version: the gather kernel's, run for the even
        sweep count as the route runs it."""
        return gibbs_sweeps_sparse_reference(hp_, c_, plan_, s_,
                                             gibbs_hbm_cuda.round_sweeps(n_), beta_, **kw)

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
                    ref = plain(hp, c, plan, s0, n_sw, beta, uniforms=u,
                                          track_delta_e=de)
                    torch.cuda.synchronize()
                    if de:
                        (out, d_out), (ref, d_ref) = out, ref
                    same = (out == ref).all(dim=1)
                    check(float(same.float().mean()) >= TWIN_RULE[dtype],
                          f"{name} vs plain ({n_c} chains x {n_sw} sweeps): chains differ")
                    note = f"{name} {int((~same).sum())} ({float(same.float().mean()):.6f} identical)"
                    if dtype in ("bf16", "f32"):  # the gather against the dense plain version
                        dense = dense_plain(hp, c, plan, s0, n_sw, beta, uniforms=u)
                        frac = identical_fraction(out, dense)
                        check(frac >= CHAIN_RULE, f"{name} vs the dense plain version "
                              f"({n_c} x {n_sw}): {frac:.6f} of chains identical")
                        note += f" (vs dense plain: {frac:.6f} identical)"
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
                  f" chains differing from the gather's plain version (f32: none; int8, bf16: "
                  f">= {GATHER_RULE:.1%} identical): {'; '.join(line)}")
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
    # the K3 route's int8 gather against the dense plain version at the serving shape
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    s0 = random_spins(g, plan, 256, dev)
    u = torch.rand((80, 256, plan.n_pad), generator=g, device=dev)
    out = stream(hp, couplings[("K3", "int8")], plan, s0, 80, uniforms=u)
    frac = identical_fraction(out, dense_plain(hp, couplings[("K3", "int8")], plan, s0, 80,
                                               uniforms=u))
    print(f"[12] K3-int8 (the gather kernel) vs the dense plain version gibbs_sweeps_hbm_reference, "
          f"256 chains x 80 sweeps, fed uniforms: {frac:.6f} of chains identical")
    check(frac >= 0.999, "K3-int8 disagrees with the dense plain version")
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
    for key in (("K2", "f32"), ("K3", "f32"), ("K3", "bf16"), ("K2", "bf16"), ("K3", "int8"),
                ("K2", "int8")):
        g.set_state(state)
        out = stream(hp, couplings[key], plan, s0, 3, generator=g)
        ref = plain(hp, couplings[key], plan, s0, 3, uniforms=u_ph)
        frac = identical_fraction(out, ref)
        check(frac >= (1.0 if key[1] == "f32" else CHAIN_RULE),
              f"{key} Philox stream: only {frac:.4f} of chains identical")
        line.append(f"{'-'.join(key)} {int(round((1 - frac) * 256))}/256")
    print(f"[12] Philox stream vs plain fed philox_uniforms (256 chains, 3 sweeps run as 4): "
          f"chains differing {'; '.join(line)}")
    del u_ph
    small = GRBMGraph(n=12, edge_i=np.array(SMALL_EDGES)[:, 0], edge_j=np.array(SMALL_EDGES)[:, 1])
    small_plan = build_plan(small)
    hs = rng.uniform(-0.3, 0.3, small.n).astype(np.float32)
    js = rng.uniform(-0.5, 0.5, small.n_edges).astype(np.float32)
    hps, aps = permuted_model(small_plan, torch.tensor(hs, device=dev), torch.tensor(js, device=dev))
    aps_bf16 = aps.to(torch.bfloat16)
    ei = torch.as_tensor(small_plan.perm_edge_i, device=dev)
    ej = torch.as_tensor(small_plan.perm_edge_j, device=dev)
    for name, c in (("K2-f32", aps), ("K3-f32", pack_coupling(small_plan, aps, 128)),
                    ("K2-bf16", aps_bf16), ("K3-bf16", pack_coupling(small_plan, aps_bf16, 128))):
        j_model = (aps if "f32" in name else aps_bf16)[ei, ej].double().cpu().numpy()
        e1, e2 = exact_moments(hs, small.edge_i, small.edge_j, j_model)  # the model it samples
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
        plain_ms = cuda_ms(lambda: plain(*args, generator=gk, track_delta_e=de), 2,
                           warmup=1)
        k_chunk = chunk if kernel == "K3" else None
        n_run = gibbs_hbm_cuda.round_sweeps(n_sw)
        # the gather: bound on the bytes it must read, and on the stored form
        bound = sweep_bound(args[2], gather_bytes(args[2], k_chunk, VALUE_BYTES[dtype]),
                            PEAK_OPS[dtype], n_c, n_run, de)
        stored = sweep_bound(args[2], stored_bytes(args[1]), PEAK_OPS[dtype], n_c, n_run, de)
        print(f"[16] {name} {n_c} chains x {n_sw} sweeps: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound[0] * 1e3:.3f} us ({bound[1]}), stored-form bound "
              f"{stored[0] * 1e3:.3f} us ({stored[1]})  [{card}]")
        kernels.append({
            "name": f"gibbs_sparse ({name})",
            "mode": name,
            "route": "cuda",
            "source": GATHER_SOURCE,
            "replaces": STREAM_REPLACES[kernel],
            "launches": sum(cnt.get(name, 0) for cnt in (train_counts, k2_counts, serve_counts)),
            "max_abs_err": errs[name],
            "tolerance": (f">= {TWIN_RULE[dtype]:.1%} of chains bit-identical to the gather's "
                          f"plain version"
                          + (f", >= {CHAIN_RULE:.0%} to the dense plain version"
                             if dtype != "int8" else "")
                          + ("; dE within 1e-3*(1+|E|) on identical chains" if de else "")),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "bound_stored_ms": stored[0],
            "bound_stored_by": stored[1],
            "library_ms": None,
            "shape": f"{n_c} chains x {n_sw} sweeps, n_pad {plan.n_pad}, {len(plan.blocks)} blocks"
                     + (f", chunk {chunk}" if kernel == "K3" else ""),
        })
    # the gather's launch shape for K3-bf16-dE and K2-f32-dE at the PT shape
    # (measured, not tuned)
    for key in (("K3", "bf16"), ("K2", "f32")):
        shape_sweep(lambda s, n, shape: gibbs_sweeps_sparse(
            hp, couplings[key], plan, s, gibbs_hbm_cuda.round_sweeps(n), ladder,
            generator=gk, track_delta_e=True, _shape=shape),
            plan, "16", f"{mode_name(*key, True)}", ((2048, cfg.GIBBS_SWEEPS),), card)
    # the gather's launch shape on the served coupling: serving, a 4-way burst, PT
    shape_sweep(lambda s, n, shape: gibbs_sweeps_sparse(
        hp_s, c_s, plan_s, s, gibbs_hbm_cuda.round_sweeps(n), generator=gk, _shape=shape),
        plan_s, "16", "K3-int8", ((256, serve_sweeps), (1024, serve_sweeps),
                                  (2048, cfg.GIBBS_SWEEPS)), card)
    profile_step(tr, batch, "16", "scaled PT", card)
    return {"paths": {"train_scaled": train_counts, "train_scaled_k2": k2_counts,
                      "serve_scaled": serve_counts},
            "kernels": kernels}


# the 2,048-latent configuration: Advantage_system6's Pegasus fabric cut to
# 2,048 latents, the config defaults otherwise (bf16 coupling under "auto":
# K2-bf16 in training; served int8 through K1-int8)
SERVE2K = dict(QPU="Advantage_system6", N_LATENTS=2048)
K1_MODES = [(dtype, de) for dtype in ("bf16", "int8") for de in (False, True)]
K1_KERNEL_TYPES = {"bf16": "bf16 bits", "int8": "int8"}  # the kernel's value type


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
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda, gibbs_sparse
    from image_generation_tpu_torch.ops.exact import exact_moments
    from image_generation_tpu_torch.ops.gibbs import (
        build_plan, gibbs_sweeps_kernel_reference, ising_energies, permuted_model,
        random_spins, to_original,
    )
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse, gibbs_sweeps_sparse_reference,
    )
    from image_generation_tpu_torch.ops.quant import dequantize_coupling
    from image_generation_tpu_torch.training.observability import MetricsLog
    from image_generation_tpu_torch.training.trainer import Trainer
    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    k1 = gibbs_cuda.gibbs_sweeps_cuda
    plain = gibbs_sweeps_sparse_reference  # every K1 mode's plain version: the gather's
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
    shapes_checked = {"bf16": set(), "int8": set()}  # the gather's chains per block G
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
            check(bool(same.all()) if dtype == "bf16" else float(same.float().mean()) >= CHAIN_RULE,
                  f"{name} vs plain ({label}, {n_c} x {n_sw}): chains differ")
            note = f"{name} {int((~same).sum())}"
            if dtype == "bf16" and not de:  # the gather against the dense plain version
                frac = identical_fraction(out, gibbs_sweeps_kernel_reference(
                    hp, c, mplan, s0, n_sw, beta, uniforms=u))
                check(frac >= CHAIN_RULE, f"{name} vs the dense plain version ({label}, "
                      f"{n_c} x {n_sw}): {frac:.6f} of chains identical")
                note += f" (vs dense plain: {frac:.6f} identical)"
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
                shapes_checked[dtype].add(launch_shape(mplan, n_c)[0])
        if mplan is plan2k and n_c == 256:  # the K1 route's gather against the dense plain version
            frac = identical_fraction(k1(hp, forms["int8"], mplan, s0, n_sw, beta, uniforms=u),
                                      gibbs_sweeps_kernel_reference(hp, forms["int8"], mplan, s0,
                                                                    n_sw, beta, uniforms=u))
            line.append(f"K1-int8 vs the dense plain version gibbs_sweeps_kernel_reference: "
                        f"{frac:.6f} of chains identical")
            check(frac >= 0.999, "K1-int8 disagrees with the dense plain version")
        print(f"[17] {label}, {n_c} chains x {n_sw} sweeps, fed uniforms; chains differing "
              f"from the plain version: {'; '.join(line)}")
        del u
    for dtype, checked in shapes_checked.items():
        check(checked == set(gibbs_sparse._CHAINS),
              f"K1-{dtype}: chains per block checked {sorted(checked)}, built "
              f"{sorted(gibbs_sparse._CHAINS)}")
    print(f"[17] chains per block checked on the serving chain counts: "
          f"{ {d: sorted(v) for d, v in shapes_checked.items()} }")
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
        check(frac == 1.0 if dtype == "bf16" else frac >= CHAIN_RULE,
              f"K1-{dtype} Philox stream: only {frac:.4f} of chains identical")
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
        rs = resumed.state  # the trained sampler model and chains: K2-bf16's shape (phase 21)
        k2_train = (rs.sampler_h, rs.sampler_coupling, resumed.plan, rs.chains,
                    cfg2k.GIBBS_SWEEPS, 1.0)
        del tr, resumed, rs
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
        # the gather: bound on the bytes it must read, and on the stored form
        bound = sweep_bound(args[2], gather_bytes(args[2], None, VALUE_BYTES[dtype]),
                            PEAK_OPS[dtype], n_c, n_sw, de)
        stored = sweep_bound(args[2], stored_bytes(args[1]), PEAK_OPS[dtype], n_c, n_sw, de)
        print(f"[21] {name} {n_c} chains x {n_sw} sweeps ({what}, n_pad {args[2].n_pad}, G, "
              f"threads {launch_shape(args[2], n_c)}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound[0] * 1e3:.3f} us ({bound[1]}), stored-form bound "
              f"{stored[0] * 1e3:.3f} us ({stored[1]})  [{card}]")
        kernels.append({
            "name": f"gibbs_sparse ({name})",
            "mode": name,
            "route": "cuda",
            "source": GATHER_SOURCE,
            "kernel": f"sparse_sweeps_kernel<{K1_KERNEL_TYPES[dtype]}, G>",
            "replaces": "image_generation_tpu/ops/gibbs_pallas.py:" + ("121" if de else "141"),
            "launches": 0,  # filled in from the paths below
            "max_abs_err": errs[name],
            "tolerance": ("no chain differing from the gather's plain version; >= "
                          f"{CHAIN_RULE:.0%} bit-identical to the dense plain version"
                          if dtype == "bf16" else
                          f">= {CHAIN_RULE:.0%} of chains bit-identical to the plain version")
                         + ("; dE within 1e-3*(1+|E|) on identical chains" if de else ""),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "bound_stored_ms": stored[0],
            "bound_stored_by": stored[1],
            "library_ms": None,
            "shape": f"{n_c} chains x {n_sw} sweeps, n_pad {args[2].n_pad} ({what})",
        })
    # K2-bf16 (the gather) at the 2,048-latent training shape: the trained model and chains
    stream = gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda
    plan_k2, n_c, n_sw = k2_train[2], k2_train[3].shape[0], k2_train[4]
    u = torch.rand((n_sw, n_c, plan_k2.n_pad), generator=gk, device=dev)
    out = stream(*k2_train, uniforms=u)
    ref = gibbs_sweeps_sparse_reference(*k2_train, uniforms=u)
    frac = identical_fraction(out, ref)
    check(frac >= GATHER_RULE, f"K2-bf16 at the 2,048-latent training shape: {frac:.6f} of "
          f"chains identical to the gather's plain version")
    del u
    ms = cuda_ms(lambda: stream(*k2_train, generator=gk), 10, warmup=2)
    plain_ms = cuda_ms(lambda: gibbs_sweeps_sparse_reference(*k2_train, generator=gk), 3,
                       warmup=1)
    dense_ms = cuda_ms(lambda: gibbs_hbm_cuda.gibbs_sweeps_hbm_reference(*k2_train, generator=gk),
                       3, warmup=1)
    bound = sweep_bound(plan_k2, gather_bytes(plan_k2, None, VALUE_BYTES["bf16"]),
                        PEAK_OPS["bf16"], n_c, n_sw, False)
    stored = sweep_bound(plan_k2, stored_bytes(k2_train[1]), PEAK_OPS["bf16"], n_c, n_sw, False)
    print(f"[21] K2-bf16 {n_c} chains x {n_sw} sweeps (2,048-latent training, the trained model, "
          f"n_pad {plan_k2.n_pad}, G, threads {launch_shape(plan_k2, n_c)}): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, dense plain {dense_ms:.4f} ms, bound {bound[0] * 1e3:.3f} us "
          f"({bound[1]}), stored-form bound {stored[0] * 1e3:.3f} us ({stored[1]}); fed "
          f"uniforms {frac:.6f} of chains identical to the plain version  [{card}]")
    kernels.append({
        "name": "gibbs_sparse (K2-bf16, 2,048-latent training)",
        "mode": "K2-bf16",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": STREAM_REPLACES["K2"],
        "launches": 0,  # filled in from the paths below
        "max_abs_err": float((out - ref).abs().max()),
        "tolerance": f">= {GATHER_RULE:.1%} of chains bit-identical to the plain version",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "bound_stored_ms": stored[0],
        "bound_stored_by": stored[1],
        "library_ms": None,
        "shape": f"{n_c} chains x {n_sw} sweeps, n_pad {plan_k2.n_pad} (2,048-latent training)",
    })
    # K1-bf16's launch shape at the flagship training shapes (measured, not tuned)
    for name, (args, _what) in (("K1-bf16", shapes["K1-bf16"]),
                                ("K1-bf16-dE", shapes["K1-bf16-dE"])):
        shape_sweep(lambda s, n, shape: k1(*args[:3], s, n, args[5], generator=gk,
                                           track_delta_e=name.endswith("dE"), _shape=shape),
                    args[2], "21", f"{name} (flagship)", ((args[3].shape[0], args[4]),), card)
    # the int8 gather's launch shape on the served coupling: serving, a 4-way burst, a PT round
    shape_sweep(lambda s, n, shape: gibbs_sweeps_sparse(hp_s, c_s, plan_s, s, n, generator=gk,
                                                        _shape=shape),
                plan_s, "21", "K1-int8", ((256, serve_sweeps), (1024, serve_sweeps),
                                          (2048, cfg2k.GIBBS_SWEEPS)), card)
    paths = {"train_2k": train2k_counts, "resume_2k": resume_counts, "serve_2k": serve2k_counts,
             "serve_2k_pt": serve2k_pt_counts, **flag_paths}
    for entry in kernels:
        entry["launches"] = sum(cnt.get(entry["mode"], 0) for cnt in paths.values())
    return {"paths": paths, "kernels": kernels}


# the scaled configuration with its graph split over 4 ranks on one card
# the 1,280-latent configuration: the config defaults on Advantage2_system1
# with N_LATENTS=1280 (n_pad 1,664), too large for K1 in f32 ("auto" stays
# f32 below n_pad 2,048), so plain Gibbs, PT and serving stream a dense f32
# coupling through K2-f32 (the gather)
LATENTS1280 = dict(N_LATENTS=1280)


def run_in_fresh_process(task) -> dict:
    """Run ``task(rank, out_path)`` in one spawned process on cuda:0 and
    return the JSON it wrote; its exception fails the run.  Phase 26 runs
    so: in this process, after the earlier phases, ``torch.profiler``
    recorded none of the profiled step's sweep launches (made through the
    kernels' ctypes entries) in two runs, while a fresh process records
    every one."""
    import torch.multiprocessing as mp

    sys.stdout.flush()  # the child's lines follow this process's
    with tempfile.TemporaryDirectory(prefix="chip_smoke_child_") as tmp:
        out = Path(tmp) / "result.json"
        mp.start_processes(task, args=(str(out),), nprocs=1, join=True, start_method="spawn")
        return json.loads(out.read_text())


def _latents1280_child(_rank: int, out_path: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twins in full f32
    torch.backends.cudnn.allow_tf32 = False
    result = latents1280_phases(torch.device("cuda", 0), card_line())
    Path(out_path).write_text(json.dumps(result))


def latents1280_phases(dev, card: str) -> dict:
    """Phase 26: the 1,280-latent default configuration at full width
    (batch 128, 8 replicas, 256 chains x 16 sweeps) trained one epoch under
    plain Gibbs through K2-f32 and one under 8-rung PT through K2-f32-dE,
    saved and served (256 x 80, K2-f32); K2-f32 / K2-f32-dE held to the
    gather's plain version and the dense plain version at the path's
    shapes, timed beside both bounds and by launch shape.  Returns the
    launch counts of each path and the kernels' JSON entries."""
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs import ising_energies, random_spins
    from image_generation_tpu_torch.ops.gibbs_sparse import (
        gibbs_sweeps_sparse, gibbs_sweeps_sparse_reference,
    )
    from image_generation_tpu_torch.training.trainer import Trainer

    stream = gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda
    cfg = TrainingConfig(**LATENTS1280)

    # ---- 26. the 1,280-latent configuration through K2-f32 ----------------------
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    tr = Trainer(config=cfg, device=dev)
    tr.setup()
    plan = tr.plan
    print(f"[26] 1,280-latent configuration: {cfg.QPU} n={tr.graph.n} couplers="
          f"{tr.graph.n_edges} n_pad={plan.n_pad} blocks {[c1 - c0 for c0, _v, c1 in plan.blocks]}; "
          f"batch {cfg.BATCH_SIZE} x {cfg.N_REPLICAS} replicas, {cfg.NUM_READS} chains x "
          f"{cfg.GIBBS_SWEEPS} sweeps, SAMPLER_MATMUL_DTYPE={cfg.SAMPLER_MATMUL_DTYPE}")
    check((tr.graph.n, tr.graph.n_edges, plan.n_pad, len(plan.blocks)) == (1280, 12194, 1664, 6),
          "the 1,280-latent graph or plan differs from the one the JAX package builds")
    _, gibbs_step_s = timed_epoch(tr, "26", card, require_fall=False)
    gibbs_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    st = tr.state
    print(f"[26] plain Gibbs: sampler {tr.fns.sampler_impl}, coupling "
          f"{tuple(st.sampler_coupling.shape)} {st.sampler_coupling.dtype}; launches {gibbs_counts}")
    check(tr.fns.sampler_impl == "cuda_hbm", "the 1,280-latent trainer did not select K2")
    check(st.sampler_coupling.dtype == torch.float32
          and tuple(st.sampler_coupling.shape) == (plan.n_pad, plan.n_pad),
          "the 1,280-latent coupling is not the dense f32 matrix")
    check(gibbs_counts.get("K2-f32", 0) > 0, "1,280-latent training never launched K2-f32")
    check(not any(k.startswith("K1") for k in gibbs_counts), "1,280-latent training launched K1")

    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    pt = Trainer(config=cfg.replace(SAMPLER="pt"), device=dev)
    pt.graph, pt.plan, pt.physical_nodes = tr.graph, tr.plan, tr.physical_nodes
    pt.images, pt.data_source = tr.images, tr.data_source  # the same data
    pt_stats, pt_step_s = timed_epoch(pt, "26", card, require_fall=False)
    pt_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    pst = pt.state
    e_rec = ising_energies(pst.sampler_h, pst.sampler_coupling, pst.chains)
    e_gap = float((pst.chain_energies - e_rec).abs().max())
    print(f"[26] PT ({pt.config.PT_NUM_BETAS} rungs): sampler {pt.fns.sampler_impl}; launches "
          f"{pt_counts}; ladder {tuple(pst.chains.shape)}; carried vs recomputed energies: max "
          f"gap {e_gap:.3e} (|E| up to {float(e_rec.abs().max()):.2f}); acceptance mean "
          f"{pt_stats['pt_accept_mean']:.4f}")
    check(pt.fns.sampler_impl == "cuda_hbm", "the 1,280-latent PT trainer did not select K2")
    check(pt_counts.get("K2-f32-dE", 0) > 0, "1,280-latent PT training never launched K2-f32-dE")
    check(not any(k.startswith("K1") for k in pt_counts), "1,280-latent PT training launched K1")
    check(e_gap <= 1e-3 * (1 + float(e_rec.abs().max())), "carried PT energies drifted")
    batch = tr.images[: cfg.BATCH_SIZE]
    for label, t in (("1,280-latent plain Gibbs", tr), ("1,280-latent PT", pt)):
        profile_step(t, batch, "26", label, card, expect=GATHER_KERNELS)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_1280_"))
    try:
        model_dir = tmp / "latents1280_1_epoch"
        tr.save(model_dir)
        w = WarmGenerator(tmp, device=dev)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        w.warm_buckets(model_dir, 1)
        lat, outs = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            outs.append(w.serve(model_dir)["images"])
            lat.append((time.perf_counter() - t0) * 1e3)
        serve_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        sc = w._trainer.config
        serve_sweeps = sc.GIBBS_BURN_IN + sc.GIBBS_SWEEPS
        print(f"[26] served: SAMPLER={sc.SAMPLER} NUM_READS={sc.NUM_READS} sweeps {serve_sweeps} "
              f"SAMPLER_MATMUL_DTYPE={sc.SAMPLER_MATMUL_DTYPE}; sampler "
              f"{w._trainer.fns.sampler_impl}; launches {serve_counts}; lone request over 10: "
              f"median {np.median(lat):.3f} ms, max {max(lat):.3f} ms  [{card}]")
        check(w._trainer.fns.sampler_impl == "cuda_hbm", "1,280-latent serving did not select K2")
        check(serve_counts == {"K2-f32": 11}, "1,280-latent serving did not run K2-f32 alone")
        for img in outs:
            check(img.shape == (256, 32, 32, 1) and bool(np.isfinite(img).all())
                  and img.min() >= 0.0 and img.max() <= 1.0, "1,280-latent served images")
        profile_request(lambda: w.serve(model_dir), "26", "1,280-latent", card,
                        expect=GATHER_KERNELS)
        hp_s, c_s = w._trainer.fns.build_sampler_model(w._trainer.grbm_params)
        del w
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # K2-f32 / K2-f32-dE at the path's shapes: fed, against both plain versions
    gk = torch.Generator(device=dev)
    gk.manual_seed(26)
    hp_t, a_t, s_t = st.sampler_h, st.sampler_coupling, st.chains
    hp_p, a_p = pst.sampler_h, pst.sampler_coupling
    s_p = pst.chains.reshape(-1, plan.n_pad)
    b_p = pst.pt_betas.repeat_interleave(pt.config.NUM_READS)
    s_s = random_spins(gk, plan, 256, dev)
    cases = {  # label: (mode, (hp, coupling, spins, beta), sweeps, dE)
        "serving": ("K2-f32", (hp_s, c_s, s_s, 1.0), serve_sweeps, False),
        "training": ("K2-f32", (hp_t, a_t, s_t, 1.0), cfg.GIBBS_SWEEPS, False),
        "PT training": ("K2-f32-dE", (hp_p, a_p, s_p, b_p), cfg.GIBBS_SWEEPS, True),
    }
    errs = {"K2-f32": 0.0, "K2-f32-dE": 0.0}
    line = []
    for label, (name, (hp_, c_, s_, b_), n_sw, de) in cases.items():
        u = torch.rand((n_sw, s_.shape[0], plan.n_pad), generator=gk, device=dev)
        out = stream(hp_, c_, plan, s_, n_sw, b_, uniforms=u, track_delta_e=de)
        twin = gibbs_sweeps_sparse_reference(hp_, c_, plan, s_, n_sw, b_, uniforms=u,
                                             track_delta_e=de)
        dense = gibbs_hbm_cuda.gibbs_sweeps_hbm_reference(hp_, c_, plan, s_, n_sw, b_,
                                                          uniforms=u, track_delta_e=de)
        torch.cuda.synchronize()
        if de:
            (out, d_out), (twin, d_twin), (dense, d_dense) = out, twin, dense
        n_diff = differing(out, twin)
        frac = identical_fraction(out, dense)
        check(n_diff == 0, f"{name} ({label}) differs from the gather's plain version")
        check(frac >= CHAIN_RULE, f"{name} ({label}) vs the dense plain version: {frac:.6f}")
        note = (f"{name} {s_.shape[0]} x {n_sw} ({label}): {n_diff} chains differing from the "
                f"gather's plain version, {frac:.6f} identical to the dense one")
        if de:
            same = (out == dense).all(dim=1)
            e_abs = ising_energies(hp_, c_, twin).abs()
            err = (d_out - d_twin).abs()
            err_dense = (d_out - d_dense).abs()[same]
            check(bool((err <= 1e-3 * (1 + e_abs)).all())
                  and bool((err_dense <= 1e-3 * (1 + e_abs[same])).all()), f"{name}: dE")
            errs[name] = max(errs[name], float(err.max()))
            note += f", dE err {float(err.max()):.2e} (dense {float(err_dense.max()):.2e})"
        else:
            errs[name] = max(errs[name], float((out - twin).abs().max()))
        line.append(note)
        del u
    print(f"[26] fed uniforms: {'; '.join(line)}")

    # times beside both bounds, and by launch shape
    kernels, timed = [], {}
    for label, (name, (hp_, c_, s_, b_), n_sw, de) in cases.items():
        ms = cuda_ms(lambda: stream(hp_, c_, plan, s_, n_sw, b_, generator=gk,
                                    track_delta_e=de), 10)
        plain_ms = cuda_ms(lambda: gibbs_sweeps_sparse_reference(
            hp_, c_, plan, s_, n_sw, b_, generator=gk, track_delta_e=de), 2, warmup=1)
        bound = sweep_bound(plan, gather_bytes(plan, None, VALUE_BYTES["f32"]), PEAK_F32_FLOPS,
                            s_.shape[0], n_sw, de)
        stored = sweep_bound(plan, stored_bytes(c_), PEAK_F32_FLOPS, s_.shape[0], n_sw, de)
        timed[label] = (ms, plain_ms, bound, stored)
        print(f"[26] {name} {s_.shape[0]} chains x {n_sw} sweeps ({label}, n_pad {plan.n_pad}, "
              f"G, threads {launch_shape(plan, s_.shape[0])}): {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound[0] * 1e3:.3f} us ({bound[1]}), stored-form bound "
              f"{stored[0] * 1e3:.3f} us ({stored[1]})  [{card}]")
    for label, (name, (hp_, c_, _s, b_), n_sw, de) in cases.items():
        shape_sweep(lambda s_, n_, shape: gibbs_sweeps_sparse(
            hp_, c_, plan, s_, n_, b_, generator=gk, track_delta_e=de, _shape=shape),
            plan, "26", f"{name} ({label})", ((cases[label][1][2].shape[0], n_sw),), card)
    paths = {"train_1280": gibbs_counts, "train_1280_pt": pt_counts, "serve_1280": serve_counts}
    for name, label in (("K2-f32", "training"), ("K2-f32-dE", "PT training")):
        ms, plain_ms, bound, stored = timed[label]
        entry = {
            "name": f"gibbs_sparse ({name}, 1,280-latent path)",
            "mode": name,
            "route": "cuda",
            "source": GATHER_SOURCE,
            "kernel": "sparse_sweeps_kernel<float, G> on dense offsets",
            "replaces": STREAM_REPLACES["K2"],
            "launches": sum(cnt.get(name, 0) for cnt in paths.values()),
            "max_abs_err": errs[name],
            "tolerance": "no chain differing from the gather's plain version; >= "
                         f"{CHAIN_RULE:.0%} bit-identical to the dense plain version"
                         + ("; dE within 1e-3*(1+|E|)" if "dE" in name else ""),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "bound_stored_ms": stored[0],
            "bound_stored_by": stored[1],
            "library_ms": None,
            "shape": f"{cases[label][1][2].shape[0]} chains x {cases[label][2]} sweeps, "
                     f"n_pad {plan.n_pad}",
        }
        if name == "K2-f32":
            s_ms, _p, s_bound, s_stored = timed["serving"]
            entry.update(serving_ms=s_ms, serving_bound_ms=s_bound[0],
                         serving_bound_stored_ms=s_stored[0],
                         serving_shape=f"256 chains x {serve_sweeps} sweeps")
        kernels.append(entry)
    print(f"[26] step medians: plain Gibbs {gibbs_step_s * 1e3:.3f} ms, PT {pt_step_s * 1e3:.3f} "
          f"ms  [{card}]")
    del tr, pt
    torch.cuda.empty_cache()
    return {"paths": paths, "kernels": kernels}


# phase 27: the CLI's commands, each (label, argv after --workdir, files it must
# leave under the workdir); the config defaults are the flagship's
CLI_DATA = ["--dataset-size", "4096"]
CLI_FIGURES = ["generated_json/generated_epoch_0.json",
               "generated_json/reconstructed_epoch_0.json",
               "generated_json/loss_mse_epoch_0.json", "generated_json/problem_details.json",
               "assets/model_diagram/step_5_output.png",
               "assets/model_diagram/latent_qpu.json"]
CLI_COMMANDS = [
    ("cli_train", ["train", "--name", "flag", "--epochs", "1"] + CLI_DATA,
     CLI_FIGURES + ["models/flag/dvae.pth", "models/flag/grbm.pth",
                    "models/flag/parameters.json", "generated_json/metrics.jsonl"]),
    ("cli_generate", ["generate", "--model", "flag"] + CLI_DATA, CLI_FIGURES),
    ("cli_generate_checkpoint", ["generate", "--model", str(MODEL)] + CLI_DATA, CLI_FIGURES),
    ("cli_generate_pt", ["generate", "--model", "flag", "--sampler", "pt"] + CLI_DATA,
     CLI_FIGURES),
    ("cli_tune", ["tune", "--model", "flag", "--epochs", "1"] + CLI_DATA,
     CLI_FIGURES + ["models/flag_tuned_1_epochs/dvae.pth",
                    "models/flag_tuned_1_epochs/parameters.json"]),
    ("cli_refresh", ["refresh", "--model", "flag"] + CLI_DATA,
     ["assets/model_diagram/step_1_input.png", "assets/model_diagram/step_2_encode.png",
      "assets/model_diagram/step_4_decode.png", "assets/model_diagram/latent_encoded.json"]),
    ("cli_tune_pt", ["tune-pt", "--model", "flag", "--iters", "1", "--chains", "256"]
     + CLI_DATA, ["models/flag/pt_betas.json"]),
    ("cli_models", ["models"], []),
]
PLAIN_SWEEPS = ("gibbs_sweeps_reference", "gibbs_sweeps_kernel_reference",
                "gibbs_sweeps_sparse_reference", "gibbs_sweeps_hbm_reference")


def _cli_child(_rank: int, out_path: str) -> None:
    result = cli_phase(card_line())
    Path(out_path).write_text(json.dumps(result))


def _count_plain_on_card(counts: dict) -> None:
    """Wrap every plain sweep version, in every port module that holds it,
    to count its calls on CUDA tensors into ``counts``."""
    import image_generation_tpu_torch.app.cli  # noqa: F401  (and the modules below)
    import image_generation_tpu_torch.ops.gibbs_hbm_cuda  # noqa: F401
    import image_generation_tpu_torch.ops.pt_tune  # noqa: F401
    import image_generation_tpu_torch.samplers.gibbs_sampler  # noqa: F401
    import image_generation_tpu_torch.training.trainer  # noqa: F401

    def counted(name, fn):
        def wrapper(hp, *args, **kw):
            if hp.device.type == "cuda":
                counts[name] = counts.get(name, 0) + 1
            return fn(hp, *args, **kw)
        return wrapper

    originals = {}
    for mod in [m for k, m in sys.modules.items() if k.startswith("image_generation_tpu_torch")]:
        for name in PLAIN_SWEEPS:
            fn = getattr(mod, name, None)
            if callable(fn):
                originals.setdefault(name, fn)
                setattr(mod, name, counted(name, originals[name]))


def cli_phase(card: str) -> dict:
    """Phase 27: the CLI's commands on the card at the flagship's width
    (``CLI_COMMANDS``), each with the launch counters set to 0 just before
    it and read just after.  Returns the launch counts and host seconds of
    each command."""
    from image_generation_tpu_torch.app import cli
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.training.trainer import Trainer

    plain: dict = {}
    _count_plain_on_card(plain)
    images: list = []  # (method, shape, finite, min, max) of every image stack made
    originals = {}
    for name in ("generate_output", "generate_reconstructed_samples"):
        fn = originals[name] = getattr(Trainer, name)

        def recorded(self, *a, _fn=fn, _name=name, **kw):
            out = _fn(self, *a, **kw)
            img = np.asarray(out["images"])
            images.append((_name, img.shape, bool(np.isfinite(img).all()), float(img.min()),
                           float(img.max())))
            return out

        setattr(Trainer, name, recorded)
    paths, times = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        for label, argv, files in CLI_COMMANDS:
            plain.clear()
            images.clear()
            reset_counts(gibbs_cuda, gibbs_hbm_cuda)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["--workdir", str(work), *argv])
            torch.cuda.synchronize()
            times[label] = time.perf_counter() - t0
            counts = paths[label] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
            missing = [f for f in files if not (work / f).is_file()]
            print(f"[27] {' '.join(argv)}: {times[label]:.3f} s host; launches {counts}; plain "
                  f"sweeps on the card {plain}; images {images}  [{card}]", flush=True)
            check(not plain, f"[27] {label}: a plain sweep version ran on a CUDA tensor")
            check(not missing, f"[27] {label}: missing {missing}")
            if label != "cli_models":  # listing the models samples nothing
                check(sum(counts.values()) > 0, f"[27] {label}: the gather kernel never launched")
                check(set(counts) <= {"K1-f32", "K1-f32-dE"},
                      f"[27] {label}: the flagship path left K1-f32: {counts}")
            for name, _shape, finite, lo, hi in images:
                check(finite and lo >= 0.0 and hi <= 1.0,
                      f"[27] {label}: {name} images are not finite values in [0, 1]")
            if label.startswith("cli_generate"):
                check(any(n == "generate_output" and tuple(s) == (256, 32, 32, 1)
                          for n, s, *_ in images), f"[27] {label}: no 256 generated images")
        for label, mode in (("cli_train", "K1-f32"), ("cli_generate", "K1-f32"),
                            ("cli_generate_pt", "K1-f32-dE"), ("cli_tune_pt", "K1-f32-dE")):
            check(paths[label].get(mode, 0) > 0, f"[27] {label} never launched {mode}")
        ladder = json.loads((work / "models" / "flag" / "pt_betas.json").read_text())["betas"]
        print(f"[27] tuned ladder {[round(b, 5) for b in ladder]}")
        check(len(ladder) == 8 and ladder[-1] == 1.0
              and all(b2 > b1 for b1, b2 in zip(ladder, ladder[1:])),
              "[27] pt_betas.json does not ascend to 1.0")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        for name, fn in originals.items():
            setattr(Trainer, name, fn)
    print("[27] CLI host seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"  [{card}]")
    return {"paths": paths, "times": times}


# phase 28: the web app over HTTP with warm serving, and checkpoint evaluation
SERVER_MODELS = ("tpu_digits_40_epochs", "tpu_digits_10_epochs")
SERVER_EXTRA = ["--dataset-size", "4096"]  # the jobs' and the warm trainer's data


def _server_child(_rank: int, out_path: str) -> None:
    result = server_phase(card_line())
    Path(out_path).write_text(json.dumps(result))


def _http(port: int, path: str, body=None):
    """GET (``body`` None) or POST JSON to the local server: (status, bytes)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_job(port: int, label: str, deadline_s: float = 600.0) -> dict:
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        state = json.loads(_http(port, "/api/state")[1])
        if state["job"]["state"] in ("done", "failed"):
            return state
        time.sleep(0.2)
    raise RuntimeError(f"[28] {label}: the job did not finish in {deadline_s:.0f} s")


def _check_figure(fig: dict, label: str) -> tuple:
    z = np.asarray(fig["data"][0]["z"], np.float64)
    check(z.ndim == 2 and np.isfinite(z).all() and z.min() >= 0 and z.max() <= 255,
          f"[28] {label}: the figure's z is not finite values in [0, 255]")
    return z.shape


def server_phase(card: str) -> dict:
    """Phase 28: ``make_server(warm_generate=True)`` on an ephemeral port in
    a thread, driven over HTTP at the flagship's width (the page, the
    models, ``/api/generate_now`` lone and in a burst, a warm ``generate``
    job, a ``train`` job of the port's CLI in a subprocess on the card, the
    render and topology endpoints, a cancelled job), then
    ``evaluate_checkpoint`` of the serving checkpoint at its defaults.
    Each path runs with the launch counters set to 0 just before it and
    read just after; no plain sweep version may run on a CUDA tensor."""
    from image_generation_tpu_torch.app import server as srvmod
    from image_generation_tpu_torch.app.evaluate import evaluate_checkpoint
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.utils.grid import make_grid

    plain: dict = {}
    _count_plain_on_card(plain)
    paths, times = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_server_"))
    srv = None
    try:
        for name in SERVER_MODELS:
            shutil.copytree(ROOT / "runs" / "models" / name, work / "models" / name)
        t0 = time.perf_counter()
        srv = srvmod.make_server(work, port=0, extra_cli=SERVER_EXTRA, warm_generate=True)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        times["server_start_s"] = time.perf_counter() - t0
        check(srv.warm.device.type == "cuda", "[28] the warm trainer is not on the card")
        status, page = _http(port, "/")
        check(status == 200 and page == srvmod._render_page().encode(),
              "[28] GET / is not the rendered page")
        names = sorted(m["name"] for m in json.loads(_http(port, "/api/models")[1]))
        check(names == sorted(SERVER_MODELS), f"[28] /api/models lists {names}")
        model = {"model": SERVER_MODELS[0]}
        coal = srv.warm._coalescer
        grid_256 = make_grid(np.zeros((256, 32, 32, 1)), nrow=16).shape[:2]

        def generate_now():
            t = time.perf_counter()
            status, body = _http(port, "/api/generate_now", model)
            rt = (time.perf_counter() - t) * 1e3
            check(status == 200, f"[28] /api/generate_now answered {status}: {body[:200]!r}")
            resp = json.loads(body)
            shape = _check_figure(resp["figure"], "generate_now")
            check(shape == grid_256, f"[28] generate_now grid {shape}, not 256 images")
            return rt, resp

        torch.cuda.synchronize()
        first_ms, _ = generate_now()  # loads the model; launches its one dispatch
        plain.clear()
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        d0 = coal.dispatches
        lone = [generate_now() for _ in range(10)]
        counts = paths["server_generate_now_lone"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        n_disp = coal.dispatches - d0
        check(counts == {"K1-f32": n_disp} and n_disp == 10,
              f"[28] 10 lone requests: launches {counts}, dispatches {n_disp}")
        check(all(r["batched"] == 1 for _, r in lone), "[28] a lone request was batched")
        times["lone_roundtrip_ms"] = float(np.median([rt for rt, _ in lone]))
        times["lone_latency_ms"] = float(np.median([r["latency_ms"] for _, r in lone]))
        times["first_request_ms"] = first_ms

        # every group size a burst of 16 can form pays its first cuDNN plans
        # and allocations once: warm them, as a deployment would before
        # traffic, so that the burst times the warmed path
        t0 = time.perf_counter()
        srv.warm.warm_buckets(work / "models" / SERVER_MODELS[0], 16)
        torch.cuda.synchronize()
        times["warm_buckets_s"] = time.perf_counter() - t0
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        d0, s0 = coal.dispatches, coal.served
        burst: list = [None] * 16
        threads = [threading.Thread(target=lambda i=i: burst.__setitem__(i, generate_now()))
                   for i in range(16)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        times["burst16_wall_ms"] = (time.perf_counter() - t0) * 1e3
        check(all(b is not None for b in burst), "[28] a burst request did not finish")
        counts = paths["server_generate_now_burst16"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        n_disp = coal.dispatches - d0
        batched = [r["batched"] for _, r in burst]
        check(coal.served - s0 == 16 and counts == {"K1-f32": n_disp} and n_disp < 16
              and max(batched) > 1,
              f"[28] burst of 16: launches {counts}, dispatches {n_disp}, batched {batched}")
        times["burst16_dispatches"] = n_disp
        times["burst16_roundtrip_median_ms"] = float(np.median([rt for rt, _ in burst]))
        check(not plain, f"[28] a plain sweep version ran on a CUDA tensor: {plain}")
        print(f"[28] /api/generate_now ({SERVER_MODELS[0]}, 256 images): first request "
              f"{first_ms:.3f} ms; 10 lone requests, median round trip "
              f"{times['lone_roundtrip_ms']:.3f} ms, server latency_ms "
              f"{times['lone_latency_ms']:.3f} ms; group sizes 1-16 warmed in "
              f"{times['warm_buckets_s']:.3f} s; a burst of 16 in "
              f"{times['burst16_wall_ms']:.3f} ms over {n_disp} dispatches (batched "
              f"{sorted(batched)}), median round trip "
              f"{times['burst16_roundtrip_median_ms']:.3f} ms  [{card}]", flush=True)

        plain.clear()
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        t0 = time.perf_counter()
        status, body = _http(port, "/api/generate", model)
        check(status == 200 and json.loads(body)["started"], f"[28] /api/generate: {body!r}")
        state = _wait_job(port, "generate")
        torch.cuda.synchronize()
        times["generate_job_s"] = time.perf_counter() - t0
        counts = paths["server_generate_job"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        check(state["job"] == {"state": "done", "kind": "generate"}, f"[28] generate: {state}")
        check(counts.get("K1-f32", 0) > 0 and set(counts) == {"K1-f32"} and not plain,
              f"[28] the generate job: launches {counts}, plain on the card {plain}")
        for f in ("generated_json/generated_epoch_0.json", "assets/model_diagram/latent_qpu.json",
                  "assets/model_diagram/step_5_output.png"):
            check((work / f).is_file(), f"[28] the generate job left no {f}")

        t0 = time.perf_counter()
        status, body = _http(port, "/api/train", {"name": "web_flag", "epochs": 1})
        check(status == 200 and json.loads(body)["started"], f"[28] /api/train: {body!r}")
        check(srv.jobs.proc.args[2] == "image_generation_tpu_torch.app.cli",
              f"[28] the train job runs {srv.jobs.proc.args}")
        state = _wait_job(port, "train")
        times["train_job_s"] = time.perf_counter() - t0
        check(state["job"] == {"state": "done", "kind": "train", "rc": 0}, f"[28] train: {state}")
        check((work / "models" / "web_flag" / "dvae.pth").is_file(), "[28] no web_flag/dvae.pth")
        meta = json.loads((work / "models" / "web_flag" / "parameters.json").read_text())
        check(meta["n_latents"] == 256, f"[28] the train job's model has {meta['n_latents']} latents")
        fig = json.loads(_http(port, "/api/figure/generated/0")[1])
        h, w = _check_figure(fig, "the train job's generated grid")
        status, png = _http(port, "/api/render/generated/0.png")
        check(status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
              and (int.from_bytes(png[16:20], "big"), int.from_bytes(png[20:24], "big")) == (w, h),
              f"[28] /api/render/generated/0.png is not a {w} x {h} PNG")
        status, svg = _http(port, "/api/render/loss_mse/0.svg")
        check(status == 200 and svg.startswith(b"<svg") and b"polyline" in svg,
              "[28] /api/render/loss_mse/0.svg")
        for name in SERVER_MODELS:
            t1 = time.perf_counter()
            status, svg = _http(port, f"/api/render/topology/{name}/encoded.svg")
            times[f"topology_{name}_ms"] = (time.perf_counter() - t1) * 1e3
            check(status == 200 and svg.count(b"<circle") == 256,
                  f"[28] /api/render/topology/{name}/encoded.svg")

        status, body = _http(port, "/api/train", {"name": "web_cancel", "epochs": 1})
        check(json.loads(body)["started"], "[28] the job to cancel did not start")
        time.sleep(1.0)
        cancelled = json.loads(_http(port, "/api/cancel", {})[1])
        state = _wait_job(port, "cancel")
        check(cancelled == {"cancelled": True} and state["job"]["state"] == "failed",
              f"[28] cancel: {cancelled}, {state}")
        print(f"[28] warm generate job {times['generate_job_s']:.3f} s (launches "
              f"{paths['server_generate_job']}); train job (the port's CLI in a subprocess, "
              f"256 latents, 1 epoch of 4,096) {times['train_job_s']:.3f} s to done, rc 0; "
              f"topology SVGs {times['topology_tpu_digits_40_epochs_ms']:.3f} ms (physical "
              f"coordinates) / {times['topology_tpu_digits_10_epochs_ms']:.3f} ms (spring "
              f"layout); a started train job cancelled  [{card}]", flush=True)
    finally:
        if srv is not None:
            if srv.jobs.running():
                srv.jobs.cancel()
            srv.shutdown()
            srv.server_close()
        shutil.rmtree(work, ignore_errors=True)

    plain.clear()
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = evaluate_checkpoint(MODEL, device="cuda")
    torch.cuda.synchronize()
    times["evaluate_s"] = time.perf_counter() - t0
    counts = paths["evaluate"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    check(counts.get("K1-f32", 0) > 0 and set(counts) == {"K1-f32"} and not plain,
          f"[28] evaluate: launches {counts}, plain on the card {plain}")
    check(all(np.isfinite(v) for v in r.values() if isinstance(v, (int, float))),
          f"[28] evaluate: a metric is not finite: {r}")
    print(f"[28] evaluate_checkpoint({MODEL.name}) at its defaults (2,048 images, 256 reads, "
          f"4 rounds) on the {r['data_source']} pool: image_mmd {r['image_mmd']} (floor "
          f"{r['image_mmd_floor']}, noise {r['image_mmd_noise']}), latent_mmd "
          f"{r['latent_mmd']}, recon_mse {r['recon_mse']}; {times['evaluate_s']:.3f} s, "
          f"launches {counts}. runs/generation_quality.json was measured on the "
          f"sklearn-digits pool: a number on another pool does not compare with it  [{card}]",
          flush=True)
    return {"paths": paths, "times": times, "evaluation": r}


GS_RANKS = 4
GS_SCALED = dict(SCALED, GRAPH_SHARDED="on")
K4_REPLACES = "image_generation_tpu/ops/gibbs_graph_sharded_pallas.py:127"
K4_REPEATS = 20  # launches on the same inputs that must give the same dE


def span_bound(rows: int, width: int, per_row_beta: bool, fed: bool, spin_bytes: int = 4,
               delta_e: bool = False, h: bool = False):
    """(bound ms, "bytes") of one K4 launch over ``width`` owned columns:
    the f32 partial (or fields) in, the new spin out in the carry's dtype
    (``spin_bytes``), with ΔE the old spin in and the (rows,) accumulator
    read and written, h's columns, the fed uniforms, beta and the seed, each
    once at HBM bandwidth; its handful of f32 operations per element take
    far less (its Philox integer work has no peak in the table)."""
    per = 4 + spin_bytes * (2 if delta_e else 1) + (4 if fed else 0)
    nbytes = (float(rows) * width * per + 4.0 * (rows if per_row_beta else 1) + 8
              + (4.0 * width if h else 0.0) + (8.0 * rows if delta_e else 0.0))
    return nbytes / PEAK_BYTES_S * 1e3, "bytes"


def owned_spans(plan, lo: int, hi: int) -> list:
    """The class spans (start, stop) a rank with window [lo, hi) owns
    columns of: one K4 launch each per sweep."""
    from image_generation_tpu_torch.ops.gibbs import class_spans

    return [(a, b) for a, b, _b0, _b1 in class_spans(plan) if max(a, lo) < min(b, hi)]


SWEEPS = [0]  # graph-sharded sweeps run in this process since the last reset


def k4_windows(plan, ranks: int = GS_RANKS) -> list:
    """(label, start, stop, lo, cols) of K4's owned-window launches: every
    rank's owned spans at a (1, ranks) mesh, and at each class-span width a
    window inside a span, straddling its left or right edge, and covering
    it."""
    from image_generation_tpu_torch.ops.gibbs import class_spans

    l_loc = plan.n_pad // ranks
    out = [(f"rank {r} [{a}, {b})", a, b, r * l_loc, l_loc) for r in range(ranks)
           for a, b in owned_spans(plan, r * l_loc, (r + 1) * l_loc)]
    spans = {b - a: (a, b) for a, b, _b0, _b1 in class_spans(plan)
             if a >= 64 and b + 64 <= plan.n_pad}
    for w, (a, b) in sorted(spans.items()):
        for case, (lo, cols) in (("inside", (a + w // 4, w // 2)),
                                 ("left", (a - 37, 37 + w // 3)),
                                 ("right", (b - w // 3, w // 3 + 50)),
                                 ("covering", (a - 5, w + 10))):
            out.append((f"{case} [{a}, {b})", a, b, lo, cols))
    return out


def count_sweeps() -> None:
    """Count the sweeps every ``gibbs_sweeps_graph_sharded`` call runs
    (the training step imports the function at call time)."""
    from image_generation_tpu_torch.ops import gibbs_graph_sharded as gs

    run = gs.gibbs_sweeps_graph_sharded

    def counted(*args, **kw):
        SWEEPS[0] += args[4] if len(args) > 4 else kw["n_sweeps"]
        return run(*args, **kw)

    gs.gibbs_sweeps_graph_sharded = counted


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
    SWEEPS[0] = 0


def _gs_rank(rank: int, world: int, port: int, out_dir: str, task: str, task_arg) -> None:
    """One rank of the graph-sharded phases: joins the gloo world on
    cuda:0, builds the (1, world) mesh, runs ``task`` and writes its
    result to ``out_dir/<task>_<rank>.json``."""
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.parallel.mesh import create_mesh

    torch.cuda.set_device(0)
    count_sweeps()
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
    counts, sweeps = launch_counts(), SWEEPS[0]
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
        "coupling_bytes": stored_bytes(cp), "n_batches": tr.n_batches, "sweeps": sweeps,
        "owned": owned_spans(plan, lo, hi),
    }
    reset_launch_counts()
    tr.save(model_dir)
    spins = tr.sample_spins(64)
    out["sample_counts"], out["sample_sweeps"] = launch_counts(), SWEEPS[0]
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
               dense_step_s=dense_times, dense_counts=launch_counts(), dense_sweeps=SWEEPS[0],
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
               counts=launch_counts(), sweeps=SWEEPS[0], owned=owned_spans(plan, lo, hi))
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
        SpanWindowUpdate,
        load_library,
        philox_span_uniforms,
        span_update,
        span_update_reference,
        span_update_window,
        span_update_window_reference,
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
    n_pad, row0, sweep = plan.n_pad, 64, 3
    seed_v = 0x5EED5EED1234
    seed = torch.tensor([seed_v], dtype=torch.int64, device=dev)
    windows = k4_windows(plan)
    max_err, de_err, checked, whole = 0.0, 0.0, 0, 0
    h = torch.randn(n_pad, generator=g, device=dev)
    scale = torch.tensor(0.0123456789, device=dev)
    for rows in (1, 37, c_path):
        u_all = torch.rand((2, rows, n_pad), generator=g, device=dev)
        u_ph = torch.tensor(philox_span_uniforms(seed_v, sweep, row0, rows, 0, n_pad), device=dev)
        beta = 0.2 + 1.8 * torch.rand(rows, generator=g, device=dev)
        for (start, stop, _b0, _b1) in class_spans(plan):  # the whole-span entry
            f = 3.0 * torch.randn((rows, stop - start), generator=g, device=dev)
            for b in (1.0, beta):
                u = u_all[1, :, start:stop]  # the span's columns of a sweep: a strided view
                out = span_update(f, b, uniforms=u)
                ref = span_update_reference(f, b, uniforms=u)
                torch.cuda.synchronize()
                check(torch.equal(out, ref), f"K4 whole span fed != plain ({rows} x "
                                             f"{stop - start})")
                whole += 1
        for label, start, stop, lo, cols in windows:  # the owned-window entry
            width = stop - start
            wide = 3.0 * torch.randn((rows, width + 9), generator=g, device=dev)
            ints = torch.randint(-300, 301, (rows, width + 9), generator=g, device=dev,
                                 dtype=torch.int32)
            for carry in (torch.float32, torch.bfloat16, torch.int8):
                old = torch.where(torch.rand((rows, cols + 7), generator=g, device=dev) < 0.5,
                                  1.0, -1.0).to(carry)
                for partial, sc in (((ints, scale) if carry == torch.int8 else (wide, None)),
                                    (None, None)):
                    part = None if partial is None else partial[:, 3:3 + width]  # rows strided
                    for b in (0.7, beta):
                        for fed in (True, False):
                            s_k, s_p = old.clone()[:, :cols], old.clone()[:, :cols]
                            de_k = torch.zeros(rows, device=dev)
                            de_p = torch.zeros(rows, device=dev)
                            span_update_window(part, h, b, s_k, lo, start, stop, scale=sc,
                                               uniforms=u_all[1] if fed else None,
                                               seed=None if fed else seed, row0=row0,
                                               sweep=sweep, delta_e=de_k)
                            span_update_window_reference(part, h, b, s_p, lo, start, stop,
                                                         scale=sc, uniforms=u_all[1] if fed
                                                         else u_ph, row0=row0, sweep=sweep,
                                                         delta_e=de_p)
                            torch.cuda.synchronize()
                            what = (f"K4 window != plain ({rows} x {label}, {carry}, "
                                    f"{'products' if part is not None else 'h only'}, "
                                    f"{'fed' if fed else 'Philox'})")
                            check(torch.equal(s_k, s_p), what)
                            max_err = max(max_err, float((s_k.float() - s_p.float()).abs().max()))
                            err = (de_k - de_p).abs()
                            check(bool((err <= 1e-4 * (1 + de_p.abs())).all()), what + ": dE")
                            de_err = max(de_err, float(err.max()))
                            checked += 1
        del u_all, u_ph
    # dE repeats itself: one summation order, whatever the launch
    repeats = 0
    for label, start, stop, lo, cols in windows:
        part = 3.0 * torch.randn((c_path, stop - start), generator=g, device=dev)
        beta = 0.2 + 1.8 * torch.rand(c_path, generator=g, device=dev)
        for carry in (torch.float32, torch.bfloat16, torch.int8):
            s0 = torch.where(torch.rand((c_path, cols), generator=g, device=dev) < 0.5, 1.0,
                             -1.0).to(carry)
            runs = []
            for _ in range(K4_REPEATS):
                s_k, de_k = s0.clone(), torch.zeros(c_path, device=dev)
                span_update_window(part, h, beta, s_k, lo, start, stop, seed=seed, sweep=1,
                                   delta_e=de_k)
                runs.append((s_k, de_k))
            torch.cuda.synchronize()
            check(all(torch.equal(s_k, runs[0][0]) and torch.equal(de_k, runs[0][1])
                      for s_k, de_k in runs), f"K4 dE or spins differ between launches "
                                              f"({c_path} x {label}, {carry})")
            repeats += 1
    print(f"[22] K4 dE repeats itself: {K4_REPEATS} launches from the same spins and a zeroed "
          f"dE equal bit for bit (dE and spins) at {c_path} rows on each of the {len(windows)} "
          f"windows x 3 carries ({repeats} cases; Philox, per-chain beta)")
    # the int8 scale-out and + h round twice (the JAX body's fields), not one fma
    q = np.random.default_rng(0).integers(-5000, 5001, 4096).astype(np.int32)
    sc_v, h_v = np.float32(0.0123456789), np.float32(0.3456789)
    two = (q.astype(np.float32) * sc_v) + h_v
    fused = (q.astype(np.float64) * np.float64(sc_v) + np.float64(h_v)).astype(np.float32)
    s1 = torch.full((q.size, 1), -1, dtype=torch.int8, device=dev)
    de1 = torch.zeros(q.size, device=dev)
    span_update_window(torch.tensor(q.reshape(-1, 1), device=dev),
                       torch.tensor([0.0, 0.0, 0.0, float(h_v)], device=dev), 1e-3, s1, 3, 3, 4,
                       scale=torch.tensor(sc_v, device=dev),
                       uniforms=torch.zeros((q.size, 4), device=dev), delta_e=de1)
    torch.cuda.synchronize()
    check(bool((s1 == 1).all()) and np.array_equal(de1.cpu().numpy() / 2, two),
          "K4's int8 fields are not the two roundings of the plain version")
    for rows in (1, 64):
        f = 3.0 * torch.randn((rows, 23936), generator=g, device=dev)
        u = torch.rand((rows, 23936), generator=g, device=dev)
        check(torch.equal(span_update(f, 0.9, uniforms=u),
                          span_update_reference(f, 0.9, uniforms=u)),
              f"K4 whole span fed != plain ({rows} x 23936)")
        whole += 1
    f = 3.0 * torch.randn((c_path, max(widths)), generator=g, device=dev)
    beta = 0.2 + 1.8 * torch.rand(c_path, generator=g, device=dev)
    out = span_update(f, beta, seed=seed, row0=64, col0=2816, sweep=3)
    u = torch.tensor(philox_span_uniforms(seed_v, 3, 64, c_path, 2816, max(widths)),
                     device=dev)
    check(torch.equal(out, span_update_reference(f, beta, uniforms=u)),
          "K4 whole span Philox != plain fed philox_span_uniforms")
    print(f"[22] K4 owned-window entry equal to its plain version in {checked} checks (rows 1, "
          f"37, {c_path} x {len(windows)} windows: every rank's owned spans at the (1, 4) mesh "
          f"and inside / left / right / covering at widths {sorted(set(widths))}; carries f32, "
          f"bf16, int8; products and h only; scalar and per-chain beta; fed strided and Philox): "
          f"spins bit-identical, dE max |diff| {de_err:.3e} (<= 1e-4 (1 + |dE|)); int8 fields "
          f"the two roundings on 4,096 totals of which {(two != fused).sum()} differ from one "
          f"fma; whole-span entry bit-identical in {whole} checks (span widths {widths}, rows 1 "
          f"and 64 x 23936) and in Philox mode at row 64, column 2816, sweep 3")

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
            print(f"[23] rank {r}: losses {x['losses']}; launches {x['counts']} ({x['sweeps']} "
                  f"sweeps x {len(x['owned'])} owned spans {x['owned']}); step times (ms) "
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
            n_owned = len(x["owned"])
            check(x["counts"].get("K4", 0) == x["sweeps"] * n_owned > 0,
                  f"K4 launches {x['counts'].get('K4', 0)} != {x['sweeps']} sweeps x {n_owned} "
                  "owned spans on a rank")
            check(not any(k.startswith(("K1", "K2", "K3")) for k in x["counts"]),
                  "a rank launched K1, K2 or K3 on the graph-sharded path")
            check(x["sample_counts"].get("K4", 0) == x["sample_sweeps"] * n_owned > 0
                  and not any(k.startswith(("K1", "K2", "K3")) for k in x["sample_counts"]),
                  "sample_spins did not run through K4 alone, once per owned span and sweep")
            check(x["sample"] == r0["sample"], "the ranks sampled different spins")
            check(x["dense_impl"] == "torch_graph_sharded+plrng", "dense steps: sampler")
            check(x["dense_coupling"] == [[plan.n_pad // 4, plan.n_pad], "torch.bfloat16"],
                  "dense row block is not a quarter of the coupling")
            check(x["dense_counts"].get("K4", 0) == x["dense_sweeps"] * n_owned > 0
                  and not any(k.startswith(("K1", "K2", "K3")) for k in x["dense_counts"]),
                  "dense steps did not run through K4 alone, once per owned span and sweep")
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
        check(x["counts"].get("K4", 0) == x["sweeps"] * len(x["owned"]) > 0
              and not any(k.startswith(("K1", "K2", "K3")) for k in x["counts"]),
              "the P32 sweeps did not run through K4 alone, once per owned span and sweep")

    # ---- 25. times ------------------------------------------------------------
    g.manual_seed(25)
    beta = torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32,
                        device=dev).repeat_interleave(cfg.NUM_READS)
    h = torch.randn(plan.n_pad, generator=g, device=dev)
    u_sweep = torch.rand((c_path, plan.n_pad), generator=g, device=dev)
    l_loc = plan.n_pad // GS_RANKS
    per_win, tot = [], {"ms": 0.0, "plain": 0.0, "bound": 0.0, "host": 0.0}
    n_win = 0
    for r in range(GS_RANKS):  # the path's launches: bf16 carry, dE, Philox, per-chain beta
        lo = r * l_loc
        spins = torch.where(torch.rand((c_path, l_loc), generator=g, device=dev) < 0.5, 1.0,
                            -1.0).to(torch.bfloat16)
        de = torch.zeros(c_path, device=dev)
        upd = SpanWindowUpdate(spins, lo, beta, h=h, seed=seed, row0=0, delta_e=de)
        for a, b in owned_spans(plan, lo, lo + l_loc):
            part = 3.0 * torch.randn((c_path, b - a), generator=g, device=dev)
            ms = cuda_ms(lambda: upd(part, a, b, 1), 50, warmup=3)
            plain_ms = cuda_ms(lambda: span_update_window_reference(
                part, h, beta, spins, lo, a, b, uniforms=u_sweep, delta_e=de), 20, warmup=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                upd(part, a, b, 1)
            host_us = (time.perf_counter() - t0) / 50 * 1e6  # enqueue only: no synchronise
            torch.cuda.synchronize()
            own = min(b, lo + l_loc) - max(a, lo)
            bound = span_bound(c_path, own, True, False, spin_bytes=2, delta_e=True, h=True)[0]
            per_win.append(f"rank {r} [{max(a, lo)}, {min(b, lo + l_loc)}) of [{a}, {b}): "
                           f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {bound * 1e3:.3f} us, "
                           f"host {host_us:.2f} us)")
            for k, v in (("ms", ms), ("plain", plain_ms), ("bound", bound), ("host", host_us)):
                tot[k] += v
            n_win += 1
    # the device's own time per launch: back-to-back launches of a kernel
    # this short can be paced by the wrapper's host work, not the card
    from torch.profiler import ProfilerActivity, profile

    a, b = owned_spans(plan, l_loc, 2 * l_loc)[0]  # rank 1's widest window: [1504, 2816)
    part = 3.0 * torch.randn((c_path, b - a), generator=g, device=dev)
    spins = torch.ones((c_path, l_loc), dtype=torch.bfloat16, device=dev)
    upd = SpanWindowUpdate(spins, l_loc, beta, h=h, seed=seed, delta_e=torch.zeros(c_path,
                                                                                  device=dev))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            upd(part, a, b, 1)
        torch.cuda.synchronize()
    k4_events = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "span_window" in e.key]
    n_ev = sum(e.count for e in k4_events)
    device_us = sum(e.self_device_time_total for e in k4_events) / n_ev if n_ev else None
    print(f"[25] K4 device time per launch by torch.profiler on rank 1's window [{l_loc}, {b}) "
          f"({c_path} x {b - l_loc}, bf16, dE, Philox): "
          + (f"{device_us:.3f} us over {n_ev} launches" if n_ev else "not recorded")
          + f"  [{card}]")
    print(f"[25] K4 (owned window, bf16 carry, dE, Philox, per-chain beta) per launch at "
          f"{c_path} rows, by CUDA events: {'; '.join(per_win)}; mean over the {n_win} launches "
          f"of a sweep on the 4 ranks {tot['ms'] / n_win:.4f} ms, plain "
          f"{tot['plain'] / n_win:.4f} ms, bound {tot['bound'] / n_win * 1e3:.3f} us (bytes), "
          f"host {tot['host'] / n_win:.2f} us a launch  [{card}]")
    whole_ms = []
    for w in sorted(set(widths)):  # the whole-span entry, the same kernel
        f = 3.0 * torch.randn((c_path, w), generator=g, device=dev)
        whole_ms.append(f"{w}: {cuda_ms(lambda: span_update(f, beta, seed=seed), 50, warmup=3):.4f}"
                        f" ms")
    print(f"[25] K4's whole-span entry (fresh f32 buffer, Philox) at {c_path} rows by span "
          f"width: {'; '.join(whole_ms)}  [{card}]")
    steps = [t for x in res for t in x["step_s"]]
    med = float(np.median(r0["step_s"]))
    share = [x["comm_s"] / x["epoch_s"] for x in res]
    by_rank = [x["counts"].get("K4", 0) for x in res]
    print(f"[25] K4 launches per rank in the graph-sharded epoch (burn-in + {r0['n_batches']} "
          f"steps): {by_rank} ({[x['sweeps'] for x in res]} sweeps x "
          f"{[len(x['owned']) for x in res]} owned spans; the whole-span update launched "
          f"{len(widths)} a sweep on every rank)")
    print(f"[25] graph-sharded scaled step (gloo, 4 processes on one card; not a multi-GPU "
          f"number): rank 0 median {med * 1e3:.3f} ms over {len(r0['step_s'])} steps (all ranks' "
          f"steps {min(steps) * 1e3:.3f}-{max(steps) * 1e3:.3f} ms); host-clock share of the "
          f"collectives in the epoch by rank {', '.join(f'{s:.1%}' for s in share)}  [{card}]")
    paths = {"train_scaled_sharded": _sum_counts(x["counts"] for x in res),
             "sample_scaled_sharded": _sum_counts(x["sample_counts"] for x in res),
             "train_scaled_sharded_dense": _sum_counts(x["dense_counts"] for x in res),
             "p32_sharded": _sum_counts(x["counts"] for x in res32)}
    kernel = {
        "name": "span_update (K4), owned window",
        "mode": "K4",
        "kernel": "span_window_kernel<bf16 bits, false> (one launch a rank's owned columns of a "
                  "class span: + h, draw, write in the carry's dtype, dE)",
        "route": "cuda",
        "source": "image_generation_tpu_torch/csrc/span_update.cu",
        "replaces": K4_REPLACES,
        "launches": paths["train_scaled_sharded"].get("K4", 0),
        "launches_by_rank": by_rank,
        "max_abs_err": max_err,
        "max_de_err": de_err,
        "tolerance": "spins bit-identical to the plain version (fed and Philox), dE within "
                     f"1e-4 (1 + |dE|); dE and spins bit-identical over {K4_REPEATS} launches "
                     "on the same inputs",
        "ms": tot["ms"] / n_win,
        "plain_ms": tot["plain"] / n_win,
        "bound_ms": tot["bound"] / n_win,
        "bound_by": "bytes",
        "library_ms": None,
        "device_us_by_profiler": device_us,
        "host_us_per_launch": tot["host"] / n_win,
        "shape": f"{c_path} rows x each rank's owned columns of each class span at the (1, 4) "
                 f"mesh (n_pad {plan.n_pad}, windows of {l_loc}), bf16 carry, dE, Philox, "
                 f"per-chain beta; mean per launch over a sweep's {n_win} launches",
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


# phase 29: the training leftovers (the gumbel mode, the Adam moment
# levers) and the mesh's data axis
ADAM_LEVERS = (("f32", {}), ("bf16", dict(ADAM_MOMENT_DTYPE="bfloat16")),
               ("factored", dict(ADAM_FACTORED_NU="on")),
               ("both", dict(ADAM_MOMENT_DTYPE="bfloat16", ADAM_FACTORED_NU="on")))
GUMBEL = dict(LATENT_TO_DISCRETE="gumbel", GUMBEL_TAU=0.7)
# the levers' step times: the median of the steps after the first epoch
LEVER_EPOCHS = 7
DATA_AXIS_MESHES = ((2, 2), (4, 1))
# a chain count that does not tile 4 ranks: the JAX package drops to its
# XLA sweep, the port runs K1 on each rank's rows at the sweeps asked for
UNTILED_READS = 254
UNTILED_SAMPLES = 10
DATA_AXIS_RANKS = 4
# the JAX package's own tolerances for its sharded step (tests/test_sharding.py:106-130)
SHARDED_STEP = dict(mse_rtol=1e-4, loss_rtol=1e-3, spins_differing=0.005, params_atol=5e-4)


def _leftovers_child(_rank: int, out_path: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = leftovers_phase(torch.device("cuda", 0), card_line())
    Path(out_path).write_text(json.dumps(result))




def leftovers_phase(dev, card: str) -> dict:
    """Phase 29 (a)-(b): a flagship epoch in the gumbel latent mode through
    K1-f32, then the scaled PT configuration (phase 13's) one epoch under
    each Adam moment lever, with the DVAE optimizer's state bytes, the peak
    device memory and the step median.  Returns each path's launch counts
    and the levers' numbers."""
    import gc

    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.training.optim import AdamMoments, optimizer_state_bytes
    from image_generation_tpu_torch.training.trainer import Trainer

    plain: dict = {}
    _count_plain_on_card(plain)
    paths: dict = {}

    # (b) the gumbel mode at the flagship's width
    reset_counts(gibbs_cuda, gibbs_hbm_cuda)
    gum = Trainer(TrainingConfig(**GUMBEL), device=dev)
    _stats, med = timed_epoch(gum, "29b", card, require_fall=False)
    counts = paths["train_gumbel"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    with torch.no_grad():
        _, spins, _ = gum.dvae.train()(gum.images[:gum.config.BATCH_SIZE], gum.config.N_REPLICAS,
                                       g)
    inside = float((spins.abs() < 1).float().mean())
    print(f"[29b] gumbel (tau {gum.config.GUMBEL_TAU}) flagship epoch: launches {counts}, plain "
          f"sweeps on the card {plain}; a batch's relaxed spins {tuple(spins.shape)} in "
          f"[{float(spins.min()):.6f}, {float(spins.max()):.6f}], {inside:.6f} of them strictly "
          f"inside (-1, 1) (f32 tanh rounds to +-1 beyond |x| ~ 9); step median "
          f"{med * 1e3:.3f} ms  [{card}]", flush=True)
    check(set(counts) == {"K1-f32"} and counts["K1-f32"] > 0,
          f"[29b] the gumbel epoch left K1-f32: {counts}")
    check(not plain, "[29b] a plain sweep version ran on a CUDA tensor")
    check(bool((spins.abs() <= 1).all()) and inside > 0.5,
          "[29b] the gumbel spins are not relaxed values in [-1, 1]")
    del gum
    torch.cuda.empty_cache()

    # (a) the scaled PT configuration under each Adam moment lever
    levers = {}
    for name, lever in ADAM_LEVERS:
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        plain.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(TrainingConfig(**SCALED, **lever), device=dev)
        times = _epoch_step_times(tr, epochs=LEVER_EPOCHS)
        counts = paths[f"scaled_adam_{name}"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        warm = tr.n_batches
        opt = tr.state.dvae_opt
        losses = tr.losses["dvae_losses"]
        w = tr.state.dvae._decoder.increase_latent_dim.weight
        levers[name] = dict(
            optimizer=type(opt).__name__, state_bytes=optimizer_state_bytes(opt),
            peak_bytes=torch.cuda.max_memory_allocated(),
            step_ms=float(np.median(times[warm:])) * 1e3, steps=len(times), losses=losses,
            step_spread_ms=[float(np.min(times[warm:])) * 1e3, float(np.max(times[warm:])) * 1e3],
            dense_moments=sorted(k for k, v in opt.state[w].items() if torch.is_tensor(v)),
            mu_dtype=str(opt.state[w]["exp_avg"].dtype))
        lv = levers[name]
        print(f"[29a] scaled PT, Adam {name} ({lv['optimizer']}; the 127M dense layer's state "
              f"{lv['dense_moments']}, mu {lv['mu_dtype']}): DVAE optimizer state "
              f"{lv['state_bytes'] / 1e6:.3f} MB, peak device memory "
              f"{lv['peak_bytes'] / 2**30:.3f} GiB, step median {lv['step_ms']:.3f} ms over "
              f"steps {warm + 1}-{len(times)} (min {lv['step_spread_ms'][0]:.3f}, max "
              f"{lv['step_spread_ms'][1]:.3f}; first epoch "
              f"{', '.join(f'{t * 1e3:.3f}' for t in times[:warm])} ms); losses of epoch 1 "
              f"{[round(x, 5) for x in losses[:warm]]}, last {round(losses[-1], 5)}; launches "
              f"{counts}  [{card}]", flush=True)
        check(bool(np.isfinite(losses).all()), f"[29a] {name}: losses not finite")
        check(counts.get("K3-bf16-dE", 0) > 0 and not any(k.startswith("K1") for k in counts),
              f"[29a] {name}: scaled PT training left K3-bf16-dE: {counts}")
        check(not plain, f"[29a] {name}: a plain sweep version ran on a CUDA tensor")
        check((lv["optimizer"] == "Adam") == (name == "f32")
              and (name == "f32" or isinstance(opt, AdamMoments)), f"[29a] {name}: optimizer")
        del tr, opt, w
        gc.collect()
        torch.cuda.empty_cache()
    b = {k: v["state_bytes"] for k, v in levers.items()}
    check(b["bf16"] < 0.55 * b["f32"] and b["factored"] < 0.55 * b["f32"]
          and b["both"] < 0.55 * b["bf16"], f"[29a] the levers did not shrink the moments: {b}")
    return {"paths": paths, "levers": levers, "gumbel_inside": inside}


def _data_axis_rank(rank: int, world: int, port: int, out_dir: str, shape, expect) -> None:
    """One rank of phase 29 (c): joins the gloo world on cuda:0, trains the
    flagship one plain epoch, one of ``UNTILED_READS`` chains (then samples
    ``UNTILED_SAMPLES``) and one 8-rung PT epoch on the ``shape`` mesh (the
    (2, 2) one as ``Trainer()``'s default), records each K1 launch's rows,
    the losses and a digest of the replicated parameters, then takes one
    fed step on the mesh and the same step in one process and compares
    them; writes ``out_dir/rank_<rank>.json``."""
    import copy
    import hashlib
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.models.decoder import draw_dropout_masks
    from image_generation_tpu_torch.models.grbm import GRBMParams
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.ops.gibbs import random_spins
    from image_generation_tpu_torch.parallel.mesh import create_mesh
    from image_generation_tpu_torch.training import step as tstep
    from image_generation_tpu_torch.training.trainer import Trainer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=300))
    plain: dict = {}
    _count_plain_on_card(plain)
    rows: list = []
    k1 = tstep.gibbs_sweeps_cuda

    def recorded(hp, coupling, plan, spins, *a, **kw):
        rows.append(int(spins.shape[0]))
        return k1(hp, coupling, plan, spins, *a, **kw)

    tstep.gibbs_sweeps_cuda = recorded
    try:
        out = {}
        mesh = None if tuple(shape) == (2, 2) else create_mesh(shape=shape, backend="gloo")
        for sampler, kw in (("gibbs", {}), ("untiled", dict(NUM_READS=UNTILED_READS)),
                            ("pt", dict(SAMPLER="pt"))):
            reset_counts(gibbs_cuda, gibbs_hbm_cuda)
            plain.clear()
            rows.clear()
            t = Trainer(TrainingConfig(**kw), device=dev, mesh="auto" if mesh is None else mesh)
            mesh = t.mesh
            comm0 = mesh.comm_seconds
            times = _epoch_step_times(t)
            counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
            h = hashlib.sha256()
            for v in list(t.dvae.state_dict().values()) + [t.grbm_params.linear,
                                                           t.grbm_params.quadratic]:
                h.update(v.detach().cpu().numpy().tobytes())
            out[sampler] = dict(
                mesh=list(mesh.shape), impl=t.fns.sampler_impl, rows_axes=list(t.fns.train_rows.axes),
                counts=counts, rows=sorted(set(rows)), plain=dict(plain), digest=h.hexdigest(),
                losses=t.losses["dvae_losses"], step_ms=float(np.median(times[4:])) * 1e3,
                comm_s=mesh.comm_seconds - comm0, epoch_s=float(sum(times)),
                chains=list(t.state.chains.shape))
            if sampler == "untiled":  # a sample call whose count does not tile the mesh
                reset_counts(gibbs_cuda, gibbs_hbm_cuda)
                rows.clear()
                spins = t.sample_spins(UNTILED_SAMPLES)
                out["sample"] = dict(
                    counts=read_counts(gibbs_cuda, gibbs_hbm_cuda), rows=sorted(set(rows)),
                    plain=dict(plain), shape=list(spins.shape),
                    digest=hashlib.sha256(spins.cpu().numpy().tobytes()).hexdigest(),
                    pm1=bool(((spins == 1) | (spins == -1)).all()))
        # one fed step on the mesh against the same step in one process
        cfg = TrainingConfig()
        fns_m = tstep.make_train_fns(cfg, t.graph, 10, t.plan, device=dev, mesh=mesh)
        fns_1 = tstep.make_train_fns(cfg, t.graph, 10, t.plan, device=dev, mesh=None)

        def gen(seed):
            g_ = torch.Generator(device=dev)
            g_.manual_seed(seed)
            return g_

        dvae = fns_1.new_dvae()
        tstep._flax_init_(dvae, torch.Generator().manual_seed(29))
        grbm = t.graph.init_params(gen(29), device=dev)
        chains = random_spins(gen(30), t.plan, cfg.NUM_READS, dev)
        g = gen(31)
        n_img = cfg.BATCH_SIZE * cfg.N_REPLICAS
        feed = tstep.StepFeed(
            sweeps1=torch.rand((cfg.GIBBS_SWEEPS, cfg.NUM_READS, t.plan.n_pad), generator=g,
                               device=dev),
            sweeps2=torch.rand((cfg.GIBBS_SWEEPS, cfg.NUM_READS, t.plan.n_pad), generator=g,
                               device=dev),
            spin_uniforms=torch.rand((cfg.BATCH_SIZE, cfg.N_REPLICAS, cfg.N_LATENTS),
                                     generator=g, device=dev),
            dropout_masks=draw_dropout_masks(n_img, g, dev))
        st_m = fns_m.state_from(copy.deepcopy(dvae), GRBMParams(grbm.linear.clone(),
                                                                grbm.quadratic.clone()),
                                chains, gen(32), burn_in=False)
        st_1 = fns_1.state_from(dvae, grbm, chains, gen(32), burn_in=False)
        images = t.images[:cfg.BATCH_SIZE]
        m1 = fns_1.step_body(st_1, images, 0, feed)
        mm = fns_m.step_body(st_m, images, 0, feed)
        n_loc = st_m.chains.shape[0]
        lo = fns_m.train_rows.index * n_loc
        p_err = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(st_m.dvae.parameters(),
                                                                st_1.dvae.parameters()))
        out["fed_step"] = dict(
            mse=[float(mm.mse), float(m1.mse)], loss=[float(mm.dvae_loss), float(m1.dvae_loss)],
            nll=[float(mm.nll), float(m1.nll)],
            spins_differing=float((st_m.chains != st_1.chains[lo:lo + n_loc]).float().mean()),
            params_max_abs=p_err,
            grbm_max_abs=float((st_m.grbm_params.quadratic - st_1.grbm_params.quadratic)
                               .abs().max()))
        (Path(out_dir) / f"rank_{rank}.json").write_text(json.dumps(out))
    finally:
        tstep.gibbs_sweeps_cuda = k1
        dist.destroy_process_group()


def data_axis_phase(card: str, expect: dict) -> dict:
    """Phase 29 (c): the flagship on four gloo processes sharing cuda:0, on
    a (2, 2) and a (4, 1) mesh, one plain and one 8-rung PT epoch each: on
    every rank K1-f32 (under PT K1-f32-dE, and K1-f32 for the burn-in) on
    its 64 (512) rows as often as the one-process epoch of phase 8 (9)
    launched them (``expect``: those epochs' counts), no plain sweep version on a
    CUDA tensor, the losses equal and the parameters bit-equal on all
    ranks; a plain epoch and a ``sample_spins`` call whose chain counts do
    not tile the mesh (``UNTILED_READS``, ``UNTILED_SAMPLES``) through K1
    on each rank's rows, no plain sweep on the card; one fed step agreeing
    with the one-process step within the CPU test's tolerance (the JAX
    package's for its sharded step).  A real
    distributed run, but not a multi-GPU measurement: gloo stages every
    collective through the host."""
    import socket

    import torch.multiprocessing as mp

    paths, report = {}, {}
    for shape in DATA_AXIS_MESHES:
        label = f"{shape[0]}x{shape[1]}"
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        sys.stdout.flush()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_axis_") as tmp:
            mp.start_processes(_data_axis_rank,
                               args=(DATA_AXIS_RANKS, port, tmp, shape, expect),
                               nprocs=DATA_AXIS_RANKS, join=True, start_method="spawn")
            ranks = [json.loads((Path(tmp) / f"rank_{r}.json").read_text())
                     for r in range(DATA_AXIS_RANKS)]
        untiled_rows = UNTILED_READS // (shape[0] if UNTILED_READS % shape[0] == 0 else 1)
        for sampler, n_rows, impl in (("gibbs", 64, "cuda_vmem_sharded"),
                                      ("untiled", untiled_rows, "torch"),
                                      ("pt", 512, "cuda_vmem_sharded")):
            r0 = ranks[0][sampler]
            want = expect["pt" if sampler == "pt" else "gibbs"]
            for r, res in enumerate(ranks):
                x = res[sampler]
                print(f"[29c] mesh {label} {sampler} rank {r}: {x['impl']}, chains over "
                      f"{x['rows_axes']} {x['chains']}, launches {x['counts']} on rows "
                      f"{x['rows']}, plain sweeps on the card {x['plain']}; step median "
                      f"{x['step_ms']:.3f} ms, epoch {x['epoch_s']:.3f} s of which "
                      f"collectives {x['comm_s']:.3f} s (gloo, 4 processes on one card: not a "
                      f"multi-GPU measurement)  [{card}]", flush=True)
                check(x["mesh"] == list(shape), f"[29c] rank {r} trained on mesh {x['mesh']}")
                check(x["impl"] == impl, f"[29c] {label} {sampler} rank {r}: {x['impl']}")
                check(x["counts"] == want and x["rows"] == [n_rows],
                      f"[29c] {label} {sampler} rank {r}: {x['counts']} on rows {x['rows']}, "
                      f"the one-process epoch launched {want}")
                check(not x["plain"], f"[29c] {label} rank {r}: a plain sweep ran on the card")
                check(bool(np.isfinite(x["losses"]).all()) and x["losses"] == r0["losses"],
                      f"[29c] {label} {sampler}: the losses differ across ranks")
                check(x["digest"] == r0["digest"],
                      f"[29c] {label} {sampler}: the replicated parameters differ across ranks")
            paths[f"data_axis_{label}_{sampler}"] = _sum_counts([x[sampler]["counts"]
                                                                 for x in ranks])
        sample_rows = UNTILED_SAMPLES // (shape[0] if UNTILED_SAMPLES % shape[0] == 0 else 1)
        for r, res in enumerate(ranks):
            x = res["sample"]
            print(f"[29c] mesh {label} rank {r}: sample_spins({UNTILED_SAMPLES}) (does not tile "
                  f"the mesh): launches {x['counts']} on rows {x['rows']}, plain sweeps on the "
                  f"card {x['plain']}, spins {x['shape']}", flush=True)
            check(set(x["counts"]) == {"K1-f32"} and x["counts"]["K1-f32"] > 0
                  and x["rows"] == [sample_rows] and not x["plain"],
                  f"[29c] {label} rank {r}: sample_spins({UNTILED_SAMPLES}) left K1 on "
                  f"{sample_rows} rows: {x}")
            check(x["shape"][0] == UNTILED_SAMPLES and x["pm1"]
                  and x["digest"] == ranks[0]["sample"]["digest"],
                  f"[29c] {label} rank {r}: the samples are not the same +-1 spins on all ranks")
        paths[f"data_axis_{label}_sample"] = _sum_counts([x["sample"]["counts"] for x in ranks])
        for r, res in enumerate(ranks):
            f = res["fed_step"]
            print(f"[29c] mesh {label} rank {r}: one fed step against one process: mse "
                  f"{f['mse']}, loss {f['loss']}, nll {f['nll']}, chain spins differing "
                  f"{f['spins_differing']:.6f}, DVAE params max|diff| {f['params_max_abs']:.3e}, "
                  f"GRBM {f['grbm_max_abs']:.3e}", flush=True)
            check(abs(f["mse"][0] - f["mse"][1]) <= SHARDED_STEP["mse_rtol"] * abs(f["mse"][1])
                  and abs(f["loss"][0] - f["loss"][1])
                  <= SHARDED_STEP["loss_rtol"] * abs(f["loss"][1])
                  and f["spins_differing"] < SHARDED_STEP["spins_differing"]
                  and f["params_max_abs"] <= SHARDED_STEP["params_atol"],
                  f"[29c] {label} rank {r}: the fed step disagrees with one process: {f}")
        report[label] = ranks
    return {"paths": paths, "report": report}


# phase 30: the scaled PT configuration on the data axis with the
# column-sharded dense layer, native checkpoints and the auto ladder on a
# mesh, the multi-rank dry run, NCCL
MESH30_RANKS = 4
MESH30_MESHES = ((2, 2), (4, 1))
SCALED_MESH = dict(SCALED, DATASET_SIZE=4096)
DENSE_KEY = "_decoder.increase_latent_dim.weight"


def _digest(obj, h=None):
    """A sha256 over a nest of dicts, lists and tensors (their dtype and
    bytes), keys in sorted order: equal digests, equal state bit for bit."""
    import hashlib

    top = h is None
    h = hashlib.sha256() if top else h
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            h.update(repr(k).encode())
            _digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _digest(x, h)
    elif torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous().reshape(-1)
        h.update(f"{t.dtype}{tuple(obj.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    else:
        h.update(repr(obj).encode())
    return h.hexdigest() if top else h


def _state_digest(payload: dict) -> str:
    """The digest of a native checkpoint dict's state: every field, the
    optimizers' per-parameter state without their hyperparameters (the LR
    is set again before every step)."""
    return _digest({k: (v["state"] if k in ("dvae_opt", "grbm_opt") else v)
                    for k, v in payload.items()})


def _timed_epoch_steps(trainer, epoch: int) -> list:
    """One epoch (``train_epoch``) with a CUDA-synchronised host clock
    around every step; returns the step times (s)."""
    times, last = [], [0.0]

    def on_batch(_done, _nb):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    trainer.train_epoch(epoch, batch_cb=on_batch, n_chunks=trainer.n_batches)
    return times


def _mesh30_rank(rank: int, world: int, port: int, out_dir: str, backend: str,
                 full: bool) -> None:
    """One rank of phase 30: joins the world (gloo on cuda:0, or NCCL on
    cuda:<rank>), builds the (2, 2) and (4, 1) meshes and trains the scaled
    PT configuration one epoch on each (a); with ``full`` also saves the
    model (c) and a native checkpoint (d) on (2, 2), trains on, resumes on
    (2, 2) and (4, 1), takes one fed step on (4, 1) against one process
    (b) and resolves the flagship's auto ladder on (2, 2) (e).  Writes
    ``out_dir/rank_<rank>.json``."""
    import copy
    import gc
    from datetime import timedelta

    import torch.distributed as dist

    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io import native_ckpt
    from image_generation_tpu_torch.models.decoder import draw_dropout_masks
    from image_generation_tpu_torch.models.grbm import GRBMParams
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.parallel.dense import gather_large_dense
    from image_generation_tpu_torch.parallel.mesh import create_mesh
    from image_generation_tpu_torch.training import step as tstep
    from image_generation_tpu_torch.training.optim import optimizer_state_bytes
    from image_generation_tpu_torch.training.trainer import Trainer

    nccl = backend == "nccl"
    torch.cuda.set_device(rank if nccl else 0)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=600))
    plain: dict = {}
    _count_plain_on_card(plain)
    rows: list = []
    k3 = tstep.gibbs_sweeps_hbm_cuda

    def recorded(hp, coupling, plan, spins, *a, **kw):
        rows.append(int(spins.shape[0]))
        return k3(hp, coupling, plan, spins, *a, **kw)

    work = Path(out_dir)
    cfg = TrainingConfig(**SCALED_MESH)

    def gen(seed):
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        return g_

    def reset():
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        plain.clear()
        rows.clear()

    def payload(t):
        return native_ckpt.global_payload(t.state, t.fns,
                                          {"seed_stream": t._seeds.bit_generator.state})

    def free():  # after the caller dropped its references
        gc.collect()
        torch.cuda.empty_cache()

    def scaled_epoch(t, epochs):
        """(a): train_init(epochs) then epoch 0, with every count and byte."""
        reset()
        torch.cuda.reset_peak_memory_stats()
        t.train_init(epochs)
        peak_init = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        comm0, calls0 = t.mesh.comm_seconds, t.mesh.comm_calls
        times = _timed_epoch_steps(t, 0)
        counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        layer = t.dvae._decoder.increase_latent_dim
        whole = gather_large_dense(t.dvae)[DENSE_KEY]
        opt = t.state.dvae_opt
        rep = {k: v for k, v in t.dvae.state_dict().items() if k != DENSE_KEY}
        return dict(
            mesh=list(t.mesh.shape), backend=t.mesh.backend, impl=t.fns.sampler_impl,
            chains=list(t.state.chains.shape), rows_axes=list(t.fns.train_rows.axes),
            counts=counts, rows=sorted(set(rows)),
            plain=dict(plain), layer=type(layer).__name__, layer_shape=list(layer.weight.shape),
            layer_bytes=layer.weight.numel() * layer.weight.element_size(),
            whole_bytes=whole.numel() * whole.element_size(),
            moments={k: list(v.shape) for k, v in opt.state[layer.weight].items()
                     if torch.is_tensor(v) and v.ndim},
            opt_bytes=optimizer_state_bytes(opt), peak_init=peak_init,
            peak=torch.cuda.max_memory_allocated(), losses=t.losses["dvae_losses"][-len(times):],
            steps_ms=[x * 1e3 for x in times], step_ms=float(np.median(times[1:])) * 1e3,
            comm_s=t.mesh.comm_seconds - comm0, comm_calls=t.mesh.comm_calls - calls0,
            replicated=_digest([rep, t.grbm_params.linear, t.grbm_params.quadratic]),
            whole=_digest(whole))

    tstep.gibbs_sweeps_hbm_cuda = recorded
    try:
        meshes = {f"{d}x{g}": create_mesh(shape=(d, g), backend=backend)
                  for d, g in MESH30_MESHES}
        out: dict = {"rank": rank}
        # (a) on (2, 2), then (c) save, (d) a native checkpoint and the run on
        t = Trainer(cfg, device=dev, mesh=meshes["2x2"])
        out["2x2"] = scaled_epoch(t, 2 if full else 1)
        graph, plan, images = t.graph, t.plan, t.images[:cfg.BATCH_SIZE].clone()
        if full:
            t.save(work / "model")
            ck = t.save_native(work / "ck")
            if rank == 0:
                out["file"] = _state_digest(native_ckpt.load_payload(work / "ck",
                                                                     map_location="cpu"))
                out["file_bytes"] = ck.stat().st_size
            reset()
            t.train_epoch(1)
            out["uninterrupted"] = dict(state=_state_digest(payload(t)), losses=t.losses)
            del t
            free()
            r = Trainer(cfg, device=dev, mesh=meshes["2x2"])
            reset()
            t0 = time.perf_counter()
            r.resume_native(work / "ck", 2)
            restore_s = time.perf_counter() - t0
            restored = _state_digest(payload(r))
            ran: list = []
            r.train(2, epoch_cb=lambda e, _s: ran.append(e))
            out["resumed_2x2"] = dict(restored=restored, state=_state_digest(payload(r)),
                                      losses=r.losses, epochs=ran, restore_s=restore_s,
                                      counts=read_counts(gibbs_cuda, gibbs_hbm_cuda))
            del r
        else:
            del t
        free()
        # (a) on (4, 1), and (d) the (2, 2) checkpoint restored over its state
        t = Trainer(cfg, device=dev, mesh=meshes["4x1"])
        out["4x1"] = scaled_epoch(t, 2 if full else 1)
        if full:
            t.resume_native(work / "ck", 2)
            out["restored_4x1"] = _state_digest(payload(t))
        del t
        free()
        if full:
            # (b) one fed step on (4, 1) against the same step in one process
            mesh = meshes["4x1"]
            fns_m = tstep.make_train_fns(cfg, graph, 10, plan, device=dev, mesh=mesh)
            dvae = fns_m.new_dvae()
            tstep._flax_init_(dvae, torch.Generator().manual_seed(30))
            grbm = graph.init_params(gen(30), device=dev)
            chains = fns_m.new_chains(gen(31))
            g = gen(32)
            t_dim, c_dim = cfg.PT_NUM_BETAS, cfg.NUM_READS
            sw = (cfg.GIBBS_SWEEPS, t_dim * c_dim, plan.n_pad)

            def swaps():
                return tuple(torch.rand((t_dim - 1, c_dim), generator=g, device=dev)
                             for _ in range(2))

            feed = tstep.StepFeed(
                sweeps1=torch.rand(sw, generator=g, device=dev), swaps1=swaps(),
                sweeps2=torch.rand(sw, generator=g, device=dev), swaps2=swaps(),
                spin_uniforms=torch.rand((cfg.BATCH_SIZE, cfg.N_REPLICAS, cfg.N_LATENTS),
                                         generator=g, device=dev),
                dropout_masks=draw_dropout_masks(cfg.BATCH_SIZE * cfg.N_REPLICAS, g, dev))
            st_m = fns_m.state_from(copy.deepcopy(dvae), GRBMParams(grbm.linear.clone(),
                                                                    grbm.quadratic.clone()),
                                    chains, gen(33), burn_in=False)
            reset()
            mm = fns_m.step_body(st_m, images, 0, feed)
            fed_counts = read_counts(gibbs_cuda, gibbs_hbm_cuda)
            sd_m = gather_large_dense(st_m.dvae)
            chains_m = fns_m.unlocal(st_m.chains)
            out["fed_counts"] = fed_counts
            out["fed_rows"] = sorted(set(rows))
            if rank == 0:
                fns_1 = tstep.make_train_fns(cfg, graph, 10, plan, device=dev)
                st_1 = fns_1.state_from(dvae, grbm, chains, gen(33), burn_in=False)
                m1 = fns_1.step_body(st_1, images, 0, feed)
                sd_1 = st_1.dvae.state_dict()
                out["fed_step"] = dict(
                    mse=[float(mm.mse), float(m1.mse)],
                    loss=[float(mm.dvae_loss), float(m1.dvae_loss)],
                    nll=[float(mm.nll), float(m1.nll)],
                    spins_differing=float((chains_m != st_1.chains).float().mean()),
                    params_max_abs=max(float((sd_m[k].float() - v.float()).abs().max())
                                       for k, v in sd_1.items() if v.is_floating_point()),
                    layer_max_abs=float((sd_m[DENSE_KEY] - sd_1[DENSE_KEY]).abs().max()),
                    grbm_max_abs=float((st_m.grbm_params.quadratic
                                        - st_1.grbm_params.quadratic).abs().max()))
                del st_1, fns_1, sd_1
            del st_m, sd_m, dvae, chains_m, feed
            free()
            mesh.barrier()
            # (e) the flagship's auto ladder on (2, 2)
            reset()
            a = Trainer(TrainingConfig(SAMPLER="pt", PT_NUM_BETAS="auto"), device=dev,
                        mesh=meshes["2x2"])
            a.train_init(1)
            out["auto"] = dict(counts=read_counts(gibbs_cuda, gibbs_hbm_cuda),
                               betas=list(a.config.PT_BETAS), info=a.pt_auto_info,
                               chains=list(a.state.chains.shape), plain=dict(plain))
            del a
            free()
        (work / f"rank_{rank}.json").write_text(json.dumps(out))
        meshes["2x2"].barrier()
    finally:
        tstep.gibbs_sweeps_hbm_cuda = k3
        dist.destroy_process_group()


def _spawn_mesh30(work: Path, backend: str, full: bool) -> list:
    """Phase 30's four ranks as spawned processes; returns their results."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    sys.stdout.flush()
    mp.start_processes(_mesh30_rank, args=(MESH30_RANKS, port, str(work), backend, full),
                       nprocs=MESH30_RANKS, join=True, start_method="spawn")
    return [json.loads((work / f"rank_{r}.json").read_text()) for r in range(MESH30_RANKS)]


def _check_mesh_epochs(ranks: list, card: str, tag: str) -> dict:
    """(a) on each mesh: per rank the sharded layer's bytes, the optimizer
    state, peak memory, K3 launches and rows, step median and collectives;
    fails unless losses are equal, the replicated parameters and the
    gathered layer bit-equal on every rank, and no plain sweep ran on the
    card.  Returns each mesh's summed launch counts."""
    paths = {}
    for label in ("2x2", "4x1"):
        r0 = ranks[0][label]
        for r, res in enumerate(ranks):
            x = res[label]
            print(f"[{tag}] scaled PT on mesh {label} ({x['backend']}) rank {r}: {x['impl']}, "
                  f"chains {x['chains']} over {x['rows_axes']}; dense layer {x['layer']} "
                  f"{x['layer_shape']} = {x['layer_bytes'] / 1e6:.3f} MB f32 of "
                  f"{x['whole_bytes'] / 1e6:.3f} MB whole, its moments {x['moments']}; DVAE "
                  f"optimizer state {x['opt_bytes'] / 1e6:.3f} MB; peak device memory "
                  f"{x['peak'] / 2**30:.3f} GiB in the epoch ({x['peak_init'] / 2**30:.3f} "
                  f"through train_init); launches {x['counts']} on rows {x['rows']}; plain sweeps "
                  f"on the card {x['plain']}; steps {[round(v, 3) for v in x['steps_ms']]} ms, "
                  f"median of steps 2-{len(x['steps_ms'])} {x['step_ms']:.3f} ms; collectives "
                  f"{x['comm_s']:.3f} s in {x['comm_calls']} calls; losses "
                  f"{[round(v, 6) for v in x['losses']]}  [{card}]", flush=True)
            check(x["mesh"] == [int(v) for v in label.split("x")],
                  f"[{tag}] rank {r} trained on mesh {x['mesh']}")
            check(x["impl"] == "cuda_hbm_sharded+bs", f"[{tag}] {label} rank {r}: {x['impl']}")
            check(x["layer"] == "ColumnShardedLinear" and x["layer_shape"] == [5640, 5640]
                  and 4 * x["layer_bytes"] == x["whole_bytes"],
                  f"[{tag}] {label} rank {r}: the dense layer is not a quarter a rank")
            check(all(v[0] == 5640 for v in x["moments"].values() if len(v) == 2),
                  f"[{tag}] {label} rank {r}: the moments are not the rank's rows")
            check(x["counts"] == {"K3-bf16": 1, "K3-bf16-dE": 5} and x["rows"] == [512],
                  f"[{tag}] {label} rank {r}: {x['counts']} on rows {x['rows']}, not K3-bf16 1 "
                  "+ K3-bf16-dE 5 on 512 rows")
            check(not x["plain"], f"[{tag}] {label} rank {r}: a plain sweep ran on the card")
            check(bool(np.isfinite(x["losses"]).all()) and x["losses"] == r0["losses"],
                  f"[{tag}] {label}: the losses differ across ranks")
            check(x["replicated"] == r0["replicated"],
                  f"[{tag}] {label}: the replicated parameters differ across ranks")
            check(x["whole"] == r0["whole"],
                  f"[{tag}] {label}: the gathered dense layer differs across ranks")
        paths[f"scaled_mesh_{label}" + ("_nccl" if r0["backend"] == "nccl" else "")] = \
            _sum_counts([x[label]["counts"] for x in ranks])
    return paths


def scaled_mesh_phase(card: str) -> dict:
    """Phase 30 (a)-(g) (the module docstring).  A real distributed run,
    but on one card a rehearsal of the mesh, not a multi-GPU measurement:
    gloo stages every collective through the host."""
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.io import native_ckpt
    from image_generation_tpu_torch.io.torch_pth import load_state_dict
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.training.trainer import Trainer

    from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

    dev = torch.device("cuda", 0)
    flagship = TrainingConfig()
    for qpu, n in ((SCALED["QPU"], SCALED["N_LATENTS"]), (flagship.QPU, flagship.N_LATENTS)):
        cached_latent_graph(qpu, n, flagship.RANDOM_SEED)  # built once, read by every rank
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh30_"))
    try:
        t0 = time.perf_counter()
        ranks = _spawn_mesh30(work, "gloo", True)
        print(f"[30] 4 ranks (gloo, 4 processes on cuda:0) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        paths = _check_mesh_epochs(ranks, card, "30a")
        # (b) the fed step
        f = ranks[0]["fed_step"]
        print(f"[30b] one fed scaled PT step on (4, 1) against one process: mse {f['mse']}, "
              f"loss {f['loss']}, nll {f['nll']}, chain spins differing "
              f"{f['spins_differing']:.6f}, DVAE params max|diff| {f['params_max_abs']:.3e} "
              f"(the sharded layer {f['layer_max_abs']:.3e}), GRBM {f['grbm_max_abs']:.3e}; "
              f"launches a rank {[x['fed_counts'] for x in ranks]} on rows "
              f"{ranks[0]['fed_rows']}", flush=True)
        check(abs(f["mse"][0] - f["mse"][1]) <= SHARDED_STEP["mse_rtol"] * abs(f["mse"][1])
              and abs(f["loss"][0] - f["loss"][1]) <= SHARDED_STEP["loss_rtol"] * abs(f["loss"][1])
              and f["spins_differing"] < SHARDED_STEP["spins_differing"]
              and f["params_max_abs"] <= SHARDED_STEP["params_atol"],
              f"[30b] the fed step on the mesh disagrees with one process: {f}")
        check(all(x["fed_counts"].get("K3-bf16-dE", 0) == 2 for x in ranks)
              and ranks[0]["fed_rows"] == [512], "[30b] the fed step left K3-bf16-dE on 512 rows")
        paths["scaled_mesh_fed_step"] = _sum_counts([x["fed_counts"] for x in ranks])
        # (c) the model saved on (2, 2), served by one process through K3-int8
        model = work / "model"
        saved = load_state_dict(model / "dvae.pth")[DENSE_KEY]
        check(tuple(saved.shape) == (22560, 5640), f"[30c] dvae.pth's layer is {saved.shape}")
        check(_digest(saved) == ranks[0]["2x2"]["whole"],
              "[30c] dvae.pth does not hold the gathered dense layer")
        w = WarmGenerator(work, device=dev)
        reset_counts(gibbs_cuda, gibbs_hbm_cuda)
        t0 = time.perf_counter()
        imgs = w.serve(model)["images"]
        serve_ms = (time.perf_counter() - t0) * 1e3
        counts = paths["mesh_saved_served"] = read_counts(gibbs_cuda, gibbs_hbm_cuda)
        impl = w._trainer.fns.sampler_impl
        print(f"[30c] saved on (2, 2): dvae.pth's dense layer {tuple(saved.shape)} equals the "
              f"gathered one; served by one process: {impl}, launches {counts}, 256 images in "
              f"{serve_ms:.3f} ms (first request: the model's load included)  [{card}]",
              flush=True)
        check(impl == "cuda_hbm+int8+bs" and counts.get("K3-int8", 0) >= 1,
              f"[30c] the mesh-saved model was not served through K3-int8: {impl} {counts}")
        check(imgs.shape == (256, 32, 32, 1) and bool(np.isfinite(imgs).all())
              and imgs.min() >= 0.0 and imgs.max() <= 1.0, "[30c] served images")
        del w, saved
        torch.cuda.empty_cache()
        # (d) native checkpoints across topologies
        one = Trainer(TrainingConfig(**SCALED_MESH), device=dev, mesh=None)
        one.resume_native(work / "ck", 2)
        one_digest = _state_digest(native_ckpt.global_payload(
            one.state, one.fns, {"seed_stream": one._seeds.bit_generator.state}))
        del one
        torch.cuda.empty_cache()
        file_digest = ranks[0]["file"]
        un, re = ranks[0]["uninterrupted"], ranks[0]["resumed_2x2"]
        print(f"[30d] native checkpoint saved on (2, 2): {ranks[0]['file_bytes'] / 1e6:.3f} MB, "
              f"the one-device schema; restored on (2, 2) / (4, 1) / one process equal to the "
              f"file: {[x['resumed_2x2']['restored'] == file_digest for x in ranks]} / "
              f"{[x['restored_4x1'] == file_digest for x in ranks]} / "
              f"{one_digest == file_digest}; resumed on (2, 2) (epochs {re['epochs']}, restore "
              f"{re['restore_s']:.3f} s) equal to the uninterrupted run: "
              f"{[x['resumed_2x2']['state'] == x['uninterrupted']['state'] for x in ranks]}",
              flush=True)
        for r, x in enumerate(ranks):
            check(x["resumed_2x2"]["restored"] == file_digest
                  and x["restored_4x1"] == file_digest,
                  f"[30d] rank {r}: the restored global state differs from the file")
            check(x["resumed_2x2"]["state"] == x["uninterrupted"]["state"]
                  and x["resumed_2x2"]["losses"] == x["uninterrupted"]["losses"]
                  and x["resumed_2x2"]["epochs"] == [1],
                  f"[30d] rank {r}: the resumed run differs from the uninterrupted one")
            check(x["uninterrupted"]["state"] == un["state"],
                  "[30d] the global state differs across ranks")
        check(one_digest == file_digest, "[30d] one process restored another state")
        # (e) the auto ladder on (2, 2)
        a0 = ranks[0]["auto"]
        for r, x in enumerate(ranks):
            a = x["auto"]
            print(f"[30e] flagship PT_NUM_BETAS='auto' on (2, 2) rank {r}: {a['info']}, ladder "
                  f"{[round(b, 5) for b in a['betas']]}, chains {a['chains']}; launches "
                  f"{a['counts']}, plain sweeps on the card {a['plain']}", flush=True)
            check(a["betas"] == a0["betas"] and a["info"] == a0["info"],
                  f"[30e] rank {r} froze another ladder")
            check(a["counts"].get("K1-f32-dE", 0) > 0 and not a["plain"],
                  f"[30e] rank {r}: the probe did not launch K1-f32-dE: {a['counts']}")
        paths["auto_ladder_mesh"] = _sum_counts([x["auto"]["counts"] for x in ranks])
        # (f) the dry run on 4 ranks on the card
        out = work / "dryrun.json"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "image_generation_tpu_torch.parallel.dryrun",
                               "--ranks", "4", "--out", str(out)], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        dry_s = time.perf_counter() - t0
        line = [x for x in proc.stdout.splitlines() if x.startswith("dryrun")]
        report = json.loads(out.read_text()) if out.exists() else {"ranks": []}
        dry_counts = paths["dryrun"] = _sum_counts([x["launches"] for x in report["ranks"]])
        print(f"[30f] parallel/dryrun.py --ranks 4 on the card: exit {proc.returncode} in "
              f"{dry_s:.1f} s; launches {dry_counts}; {line[-1] if line else proc.stderr[-2000:]}",
              flush=True)
        check(proc.returncode == 0 and line and line[-1].startswith("dryrun ok"),
              "[30f] the dry run failed")
        check(all(x["device"].startswith("cuda") for x in report["ranks"])
              and dry_counts.get("K1-f32", 0) > 0 and dry_counts.get("K4", 0) > 0,
              f"[30f] the dry run did not run K1 and K4 on the card: {dry_counts}")
        # (g) NCCL, one card a rank
        cards = torch.cuda.device_count()
        if cards >= MESH30_RANKS:
            nccl_dir = work / "nccl"
            nccl_dir.mkdir()
            t0 = time.perf_counter()
            nranks = _spawn_mesh30(nccl_dir, "nccl", False)
            print(f"[30g] nccl, {MESH30_RANKS} processes on cuda:0-{MESH30_RANKS - 1}, in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            paths.update(_check_mesh_epochs(nranks, card, "30g"))
        else:
            print(f"[30g] nccl: not run ({cards} card{'s' if cards > 1 else ''})", flush=True)
        return {"paths": paths, "ranks": ranks}
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
