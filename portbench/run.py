"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix, its limits and its per-layer readers are found by name under this
directory (``core.Run``).  The run sets up the program, measures for
``--seconds``, compares what the window produced with the plain reference,
and prints one JSON line last on standard output: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from a profiled stretch of the window.  The numbers compared, each beside
its limit, are the last lines on standard error and the last key of the
line.  Without a CUDA card (or with fewer than the cell asks for) it
prints no result and exits 2; with JAX or the JAX package loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
CACHE = BENCH_DIR / "_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache the program keeps lives at a fixed path inside the checkout
    os.environ["IMGGEN_CACHE_DIR"] = str(CACHE / "graphs")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # the harness's own modules, and the program: a package at the checkout's root
    sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
    from core import ROOT, Run, jax_modules, result_line

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = Run(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
              t_start=T_START)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < run.cell["chips"]:
        print(f"portbench: {run.cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    run.device = "cuda"
    result = run.driver.run(run)
    loaded = jax_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    line, report = result_line(run, result, {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": run.cell["chips"], "memory_peak_bytes": int(result["memory_peak_bytes"])})
    print(_card_line(), file=sys.stderr)
    for text in report:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


def _card_line() -> str:
    """The card's name and power limit, beside which every number stands."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"portbench: card {out}"


if __name__ == "__main__":
    sys.exit(main())
