"""Time the port's gather sweep kernel (``csrc/gibbs_sparse.cu``) at every
launch shape on the served flagship plan, and report the occupancy its
build gets.

For each group size k of the serving coalescer (256·k chains, Philox, f32
coupling, 80 sweeps: burn-in and sweeps of the served checkpoint) it times
every (chains per block G, threads), after two warm-ups, beside the
default ``launch_shape``: the sweep kernel's mean device time over
``--reps`` launches (``torch.profiler``), and CUDA events around the
calls (host work included where it outlasts the kernels).  With
``--occupancy`` it compiles a probe that includes the kernel source with
the library's flags: ``ptxas -v``'s registers of each
``sparse_sweeps_kernel`` instance and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at each (G, threads) for
the plan's shared memory.

``--root`` names the tree whose package (and kernel source) is timed, so
two commits compare in one call (run each in its own process):

    python scripts/time_gather_shapes.py --root _chip_checkouts/parent --out p.json
    python scripts/time_gather_shapes.py --root . --occupancy --out c.json

Needs an NVIDIA H100 (sm_90a) and ``nvcc``.
"""

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

CHECKPOINT = Path(__file__).resolve().parents[1] / "portbench" / "checkpoints" / "flagship"

_PROBE = """
#include "gibbs_sparse.cu"
#include <cstdio>

template <typename V, int G>
void occupancy(const char* name, int n_pad) {
  const int smem = G * n_pad;
  cudaFuncSetAttribute(sparse_sweeps_kernel<V, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  for (int threads = 128; threads <= 1024; threads *= 2) {
    if (threads % G) continue;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sparse_sweeps_kernel<V, G>, threads,
                                                  smem);
    printf("%s %d %d %d\\n", name, G, threads, blocks);
  }
}

template <typename V>
void every_g(const char* name, int n_pad) {
  occupancy<V, 1>(name, n_pad);
  occupancy<V, 2>(name, n_pad);
  occupancy<V, 4>(name, n_pad);
  occupancy<V, 8>(name, n_pad);
  occupancy<V, 16>(name, n_pad);
}

int main(int argc, char** argv) {
  const int n_pad = atoi(argv[1]);
  every_g<float>("f32", n_pad);
  every_g<bf16_bits>("bf16", n_pad);
  every_g<int8_t>("int8", n_pad);
  return 0;
}
"""


def occupancy(root: Path, n_pad: int) -> dict:
    """{"registers": {kernel instance: registers}, "blocks_per_sm": {"f32 G
    threads": blocks}} of the kernel source under ``root``."""
    from image_generation_tpu_torch.ops import cuda_build

    csrc = root / "image_generation_tpu_torch" / "csrc"
    flags = [f for f in cuda_build._NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "probe.cu", Path(tmp) / "probe"
        src.write_text(_PROBE)
        build = subprocess.run([cuda_build._nvcc(), *flags, "-I", str(csrc), "-o", str(exe),
                                str(src)], capture_output=True, text=True, check=True)
        run = subprocess.run([str(exe), str(n_pad)], capture_output=True, text=True, check=True)
    registers, current = {}, None
    for line in (build.stdout + build.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current and "sparse_sweeps_kernel" in current:
            registers[current] = int(m.group(1))
    blocks = {}
    for line in run.stdout.splitlines():
        name, g, threads, n = line.split()
        blocks[f"{name} G={g} T={threads}"] = int(n)
    return {"registers": registers, "blocks_per_sm": blocks}


def device_ms(call, reps: int) -> float:
    """Mean device milliseconds of the sweep kernel over ``reps`` calls
    (over the launches the profiler records, which may miss one)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "sparse_sweeps_kernel" in e.key]
    seen = sum(e.count for e in rows)
    if seen < reps // 2:
        raise RuntimeError(f"the profiler recorded {seen} sweep launches of {reps}")
    return sum(e.device_time_total for e in rows) / seen / 1000.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="tree whose package is timed")
    ap.add_argument("--ks", default="1,2,4,8,12,16", help="group sizes: 256·k chains")
    ap.add_argument("--threads", default="512,1024", help="threads a block to time at each G")
    ap.add_argument("--sweeps", type=int, default=80)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--occupancy", action="store_true")
    ap.add_argument("--out", default=None, help="JSON file for the times")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    from image_generation_tpu_torch.io.checkpoint import load_model_dir
    from image_generation_tpu_torch.models.grbm import scaled_ising
    from image_generation_tpu_torch.ops import gibbs_sparse
    from image_generation_tpu_torch.ops.gibbs import build_plan, permuted_model, random_spins

    dev = torch.device("cuda", 0)
    gibbs_sparse.load_library()
    _, params, graph, _, _ = load_model_dir(CHECKPOINT, dev)
    plan = build_plan(graph)
    hp, a = permuted_model(plan, *scaled_ising(params, 0.05, (-4.0, 4.0), (-1.0, 1.0)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = {"root": str(root), "card": card, "sms": sms, "n_pad": plan.n_pad,
           "sweeps": args.sweeps, "times_ms": {}, "events_ms": {}}
    threads = [int(t) for t in args.threads.split(",")]
    for k in (int(x) for x in args.ks.split(",")):
        chains = 256 * k
        spins = random_spins(gen, plan, chains, dev)
        default = gibbs_sparse.launch_shape(plan, chains, sms)
        shapes = sorted({(g, t) for g in gibbs_sparse._CHAINS for t in threads if t % g == 0}
                        | {default})
        by_shape, events = {}, {}
        for g, t in shapes:
            def call():
                gibbs_sparse.gibbs_sweeps_sparse(hp, a, plan, spins, args.sweeps, generator=gen,
                                                 _shape=(g, t))
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                call()
            stop.record()
            torch.cuda.synchronize()
            events[f"G={g} T={t}"] = start.elapsed_time(stop) / args.reps
            by_shape[f"G={g} T={t}"] = device_ms(call, args.reps)
        out["times_ms"][f"k={k}"] = {"default": f"G={default[0]} T={default[1]}", **by_shape}
        out["events_ms"][f"k={k}"] = events
        best = min(by_shape, key=by_shape.get)
        print(f"k={k} ({chains} chains x {args.sweeps} sweeps), device ms a launch: default "
              f"G={default[0]} T={default[1]} {by_shape[f'G={default[0]} T={default[1]}']:.4f}, "
              f"fastest {best} {by_shape[best]:.4f}; "
              + "; ".join(f"{s} {ms:.4f}" for s, ms in by_shape.items()) + f"  [{card}]")
    if args.occupancy:
        out["occupancy"] = occupancy(root, plan.n_pad)
        print(json.dumps(out["occupancy"], indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
