#!/usr/bin/env python3
"""Time variants of K4's owned-window kernel on one CUDA card.

    python3 k4_variants.py [--parent DIR]

Builds each variant from a copy of
``image_generation_tpu_torch/csrc/span_update.cu`` with one change, loads
it in place of the shipped library and times it through
``SpanWindowUpdate`` by CUDA events (100 launches back to back after a
warm-up) at the graph-sharded scaled shapes: 2,048 chain rows, the
widest window (1,408 columns of span [0, 1,408)) with a bf16 carry and ΔE
under Philox and fed uniforms, without ΔE, and with f32 and int8
carries; and one sweep's 10 launches over the 4 ranks' windows of 1,504
columns (bf16, ΔE, Philox).  The variants are the designs that sum a
row's ΔE in one fixed order:

* ``shipped``: with ΔE two warps share all of a row's owned columns (a
  grid of row groups only), their totals added in warp order through
  shared memory;
* ``dE 1 / 4 / 8 warps a row``: that many warps share a row's columns;
* ``dE chunk partials, last block sums``: the grid of (row groups,
  256-column chunks) kept with ΔE, each (row, chunk) warp writing its
  partial to a scratch buffer that the row group's last block (found
  with a ``__threadfence`` and an atomic counter) sums in chunk order;
* ``parent`` (with ``--parent DIR``, a checkout of another commit): that
  tree's source as it is, e.g. the earlier kernel whose column chunks
  added a row's ΔE with float atomics.

Every variant's spins must equal the shipped kernel's bit for bit (its ΔE
is printed beside them), and at the widest window with ΔE (bf16, Philox)
20 launches from the same inputs are compared: the number of distinct ΔE
vectors among them is printed (1: the sum repeats itself).  Prints the
card's name and power limit and one line per variant and round (two
rounds).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "image_generation_tpu_torch" / "csrc"
REPEATS = 20
# design (b): scratch for the (row, chunk) partials and the row groups' counters
B_GLOBALS = """__device__ float g_partial[1 << 16];       // rows x chunks of one launch
__device__ unsigned int g_arrived[1 << 13];  // blocks of a row group done

template <typename S, bool kFed>
__global__ void __launch_bounds__(kThreads)
span_window_kernel("""
B_MAP = """  const int r = blockIdx.x * kRowsPerBlock + warp;
  const int c_begin = a + blockIdx.y * kChunk + lane;
  const int c_end = min(b, a + (static_cast<int>(blockIdx.y) + 1) * kChunk);
  const int step = kWarp;
  const bool live = r < args.rows;
  if (!live && de == nullptr) return;
"""
B_SUM = """    if (live && lane == 0) g_partial[r * gridDim.y + blockIdx.y] = acc;
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    if (threadIdx.x == 0) last = atomicAdd(&g_arrived[blockIdx.x], 1u) == gridDim.y - 1;
    __syncthreads();
    if (last) {
      if (live && lane == 0) {
        float sum = 0.0f;
        for (unsigned k = 0; k < gridDim.y; ++k) sum += __ldcg(&g_partial[r * gridDim.y + k]);
        de[r] += sum;
      }
      if (threadIdx.x == 0) g_arrived[blockIdx.x] = 0u;
    }
  }
}
"""


def _between(text: str, begin: str, end: str) -> str:
    """The text from ``begin`` up to (not including) ``end``."""
    i = text.index(begin)
    return text[i:text.index(end, i)]


def variants(src: str, parent: Path = None) -> dict:
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"the source no longer has {old.strip()[:80]!r}")
        return text.replace(old, new)

    out = {"shipped": src}
    for w in (1, 4, 8):
        out[f"dE {w} warp{'s' if w > 1 else ''} a row"] = sub(
            src, "constexpr int kDeWarps = 2;", f"constexpr int kDeWarps = {w};")
    b = sub(src, "template <typename S, bool kFed>\n__global__ void __launch_bounds__(kThreads)\n"
                 "span_window_kernel(", B_GLOBALS)
    b = sub(b, _between(b, "  // without dE a warp takes (row, chunk)", "\n  const float neg2beta"),
            B_MAP)
    b = sub(b, _between(b, "    __shared__ float total[kThreads / kWarp];",
                        "template <typename S, bool kFed>\nvoid launch("), B_SUM + "\n")
    out["dE chunk partials, last block sums"] = sub(
        b, "const bool whole_rows = x.delta_e != nullptr;", "const bool whole_rows = false;")
    if parent is not None:
        out["parent"] = (parent / "image_generation_tpu_torch" / "csrc" /
                         "span_update.cu").read_text()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose span_update.cu is timed as the variant 'parent'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from image_generation_tpu_torch.ops import cuda_build
    from image_generation_tpu_torch.ops import gibbs_graph_sharded_cuda as k4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="k4_variants_"))
    (tmp / "gibbs_common.cuh").write_text((CSRC / "gibbs_common.cuh").read_text())
    builds = {}
    for i, (name, text) in enumerate(variants((CSRC / "span_update.cu").read_text(),
                                              args.parent).items()):
        (tmp / f"v{i}.cu").write_text(text)
        cmd = [cuda_build._nvcc(), *cuda_build._NVCC_FLAGS, "-o", str(tmp / f"v{i}.so"),
               str(tmp / f"v{i}.cu")]
        builds[name] = (tmp / f"v{i}.so",
                        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True))
    for name, (_so, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"[variants] {name}: registers {regs}", flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows, n_pad, l_loc, width = 2048, 6016, 1504, 1408
    spans = [(0, 1408), (1408, 2816), (2816, 4224), (4224, 5632), (5632, 5760), (5760, 5888),
             (5888, 6016)]
    h = torch.randn(n_pad, generator=g, device=dev)
    beta = 0.2 + 1.8 * torch.rand(rows, generator=g, device=dev)
    seed = torch.tensor([12345], dtype=torch.int64, device=dev)
    u = torch.rand((rows, n_pad), generator=g, device=dev)
    parts = {sp: 3.0 * torch.randn((rows, sp[1] - sp[0]), generator=g, device=dev)
             for sp in spans}
    init = torch.where(torch.rand((rows, n_pad), generator=g, device=dev) < 0.5, 1.0, -1.0)

    def us(fn, reps=100):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps * 1e3

    cases = [(torch.bfloat16, True, False), (torch.bfloat16, True, True),
             (torch.bfloat16, False, False), (torch.float32, True, False),
             (torch.int8, True, False)]
    ref = None
    for rnd in range(2):
        for name, (so, _proc) in builds.items():
            lib = ctypes.CDLL(str(so))
            k4._library = None
            k4.load_libraries = lambda lib=lib: {
                "span_update": cuda_build.KernelLibrary(lib, so, 0.0, "")}
            res = []
            for carry, de_on, fed in cases:
                s = init[:, :width].to(carry).contiguous()
                upd = k4.SpanWindowUpdate(s, 0, beta, h=h, uniforms=u if fed else None,
                                          seed=None if fed else seed,
                                          delta_e=torch.zeros(rows, device=dev) if de_on else None)
                t = us(lambda: upd(parts[(0, width)], 0, width, 1))
                res.append(f"{str(carry)[6:]}{' dE' if de_on else ''} "
                           f"{'fed' if fed else 'Philox'} {t:.2f} us")
                if carry == torch.bfloat16 and de_on and not fed:  # does dE repeat itself?
                    runs = []
                    for _ in range(REPEATS):
                        s.copy_(init[:, :width].to(carry))
                        upd.delta_e.zero_()
                        upd(parts[(0, width)], 0, width, 1)
                        runs.append(upd.delta_e.clone())
                    distinct = len({tuple(x.tolist()) for x in runs})
                    res.append(f"dE distinct over {REPEATS} launches {distinct}")
            sweep_us, outs, des = 0.0, [], []
            for r in range(4):
                lo = r * l_loc
                own = [sp for sp in spans if max(sp[0], lo) < min(sp[1], lo + l_loc)]
                for timed in (True, False):
                    s = init[:, lo:lo + l_loc].to(torch.bfloat16).contiguous()
                    de = torch.zeros(rows, device=dev)
                    upd = k4.SpanWindowUpdate(s, lo, beta, h=h, seed=seed, delta_e=de)
                    if timed:
                        sweep_us += sum(us(lambda sp=sp: upd(parts[sp], sp[0], sp[1], 1), 50)
                                        for sp in own)
                    else:
                        for sp in own:
                            upd(parts[sp], sp[0], sp[1], 1)
                        outs.append(s)
                        des.append(de)
            out, de = torch.cat(outs, 1), torch.stack(des)
            if ref is None:
                ref = (out, de)
            if not torch.equal(out, ref[0]):
                raise AssertionError(f"{name}: spins differ from the shipped kernel's")
            print(f"[variants] round {rnd} {name}: at {rows} x {width}: {'; '.join(res)}; one "
                  f"sweep's 10 launches on the 4 ranks (bf16, dE, Philox) {sweep_us:.1f} us; "
                  f"spins equal the shipped kernel's, dE max |diff| "
                  f"{float((de - ref[1]).abs().max()):.2e}  [{card}]", flush=True)
    k4._library = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
