"""The multi-rank dry run (``parallel/dryrun.py``) on the CPU.

``python -m image_generation_tpu_torch.parallel.dryrun --ranks 4 --platform
cpu`` spawns four gloo processes on one (2, 2) mesh, and with ``--hosts 2``
two launchers of two ranks each that join one world (the JAX
``scripts/dryrun_multihost.py`` shape).  Every check holds on every rank,
the summary line says so, the exit code is 0; a failed check makes the
summary say FAILED.  The checks' own tolerances are the module's (MSE
1e-4, loss 1e-3, the sharded layer 5e-4; the sweeps bit for bit).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from image_generation_tpu_torch.parallel import dryrun

ROOT = Path(__file__).resolve().parents[1]
CHECKS = {"chain_sharded_epoch", "pt_step", "chain_sharded_sweep", "graph_sharded_step",
          "k4_philox_row_split", "column_sharded_dense"}


@pytest.mark.parametrize("hosts", [1, 2])
def test_dryrun_on_four_cpu_ranks(tmp_path, hosts):
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "image_generation_tpu_torch.parallel.dryrun", "--ranks", "4",
         "--hosts", str(hosts), "--platform", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("dryrun")]
    assert len(line) == 1 and line[0].startswith("dryrun ok: mesh=(2, 2)"), proc.stdout
    report = json.loads(out.read_text())
    assert report["ok"] and report["hosts"] == hosts and len(report["ranks"]) == 4
    for r, rank in enumerate(report["ranks"]):
        assert rank["rank"] == r and rank["mesh"] == [2, 2] and rank["device"] == "cpu"
        assert set(rank["checks"]) == CHECKS
        assert all(c["ok"] for c in rank["checks"].values()), rank["checks"]
        assert rank["checks"]["column_sharded_dense"]["rows"] == [32, 32]
        assert rank["checks"]["chain_sharded_epoch"] == report["ranks"][0]["checks"][
            "chain_sharded_epoch"]


def test_a_failed_check_fails_the_summary():
    rank = {"mesh": [2, 2], "device": "cpu",
            "checks": {name: {"ok": True} for name in CHECKS}}
    ok, line = dryrun.summary([rank, rank])
    assert ok and line.startswith("dryrun ok")
    bad = dict(rank, checks=dict(rank["checks"], pt_step={"ok": False, "error": "x"}))
    ok, line = dryrun.summary([rank, bad])
    assert not ok and line.startswith("dryrun FAILED (pt_step)")
