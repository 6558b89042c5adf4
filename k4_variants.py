#!/usr/bin/env python3
"""Time variants of K4's owned-window kernel on one CUDA card.

    python3 k4_variants.py

Builds each variant from a copy of
``image_generation_tpu_torch/csrc/span_update.cu`` with one change, loads
it in place of the shipped library and times it through
``SpanWindowUpdate`` by CUDA events (100 launches back to back after a
warm-up) at the graph-sharded scaled shapes: 2,048 chain rows, the
widest window (1,408 columns of span [0, 1,408)) with a bf16 carry and ΔE
under Philox and fed uniforms, without ΔE, and with f32 and int8
carries; and one sweep's 10 launches over the 4 ranks' windows of 1,504
columns (bf16, ΔE, Philox).  The variants:

* ``shipped``: the source as it is;
* ``old spin where used``: the old spin loaded after Philox, where ΔE
  uses it, instead of first;
* ``chunk 32`` / ``64`` / ``128``: columns a warp walks (shipped: 256);
* ``unroll 4``: the column loop unrolled 4 times.

Every variant's spins must equal the shipped kernel's bit for bit (its ΔE
is printed beside them).  Prints the card's name and power limit and one
line per variant and round (two rounds).  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "image_generation_tpu_torch" / "csrc"
LOOP = "  for (int c = c_begin + lane; c < c_end; c += kWarp) {\n"
OLD_FIRST = "    const float old = de != nullptr ? Spin<S>::load(slot) : 0.0f;\n"
OLD_USE = "    if (de != nullptr) acc += f * ((up ? 1.0f : -1.0f) - old);"


def variants(src: str) -> dict:
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"the source no longer has {old.strip()!r}")
        return text.replace(old, new)

    out = {"shipped": src}
    late = sub(src, OLD_FIRST, "")
    out["old spin where used"] = sub(
        late, OLD_USE,
        "    if (de != nullptr) acc += f * ((up ? 1.0f : -1.0f) - Spin<S>::load(slot));")
    for chunk in (32, 64, 128):
        out[f"chunk {chunk}"] = sub(src, "constexpr int kChunk = 256;",
                                    f"constexpr int kChunk = {chunk};")
    out["unroll 4"] = sub(src, LOOP, "#pragma unroll 4\n" + LOOP)
    return out


def main() -> int:
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
    for i, (name, text) in enumerate(variants((CSRC / "span_update.cu").read_text()).items()):
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
