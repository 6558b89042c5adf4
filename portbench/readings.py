"""Readings from which a cell's limits are set, on the card, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--variants sound,control,<fault>,...] [--out FILE]

runs, for each variant and seed, the cell's set-up, a short window and the
comparison, and prints the compared numbers and the run's notes as one JSON
line (also appended to ``--out``).  ``sound`` runs the program as the
configuration states; ``control`` runs its own sampler one precision below
the configured one (``CONTROL``: bf16 for f32, int8 for bf16); a fault's
name plants that fault of ``faults.FAULTS`` for the cell's driver.  A limit
lies above every sound reading and below the least of the control's and
the faults' (PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
# the sampler's precision one step below each one a configuration can state
CONTROL = {"float32": "bfloat16", "bfloat16": "int8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variants", default="sound")
    p.add_argument("--warm-s", type=float,
                   help="a serving mix's closed loop before the window, in place of its own")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import os

    os.environ["IMGGEN_CACHE_DIR"] = str(BENCH_DIR / "_cache" / "graphs")
    sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
    from core import ROOT, Run
    from faults import FAULTS, Patches

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    runs = [(v, int(s)) for v in args.variants.split(",") for s in args.seeds.split(",")]
    for variant, seed in runs:
        run = Run(manifest, args.workload, seed, args.seconds, False)
        run.device = "cuda"
        if args.warm_s is not None:
            run.traffic = dict(run.traffic, warm_s=args.warm_s)
        patches, overrides = Patches(), None
        if variant == "control":
            stated = run.config["training"]["SAMPLER_MATMUL_DTYPE"]
            overrides = {"SAMPLER_MATMUL_DTYPE": CONTROL[stated]}
        elif variant != "sound":
            FAULTS[run.traffic["driver"]][variant](patches)
        try:
            t0 = time.perf_counter()
            result = run.driver.run(run, overrides)
        finally:
            patches.undo()
        rec = {"workload": args.workload, "variant": variant, "seed": seed,
               "overrides": overrides, "checks": result["checks"],
               "metrics": result["metrics"], "failed": result["failed"],
               "seconds": time.perf_counter() - t0, "notes": result["notes"]}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
