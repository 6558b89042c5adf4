"""Whole runs of each traffic driver on the CPU at a tiny size.

Each drives set-up, the window and the comparison with the reference
through the program's plain paths (the harness's look for a card is what
they skip), and checks the result line.  The control (the program's own
sampler one precision below its stated one) and each fault a cell can
have (a step or sampler that leaves its state unchanged, half the batch
left out, an answer altered where it is produced) must come out not
correct.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, make_run
from faults import FAULTS


def _line(run, result):
    from core import result_line

    line, report = result_line(run, result, {"platform": "cpu", "kind": "cpu", "count": 1,
                                             "memory_peak_bytes": 0})
    json.dumps(line)
    return line, report


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-serve", "tiny-gibbs-train"])
def test_rehearsal_is_correct(tiny_root, philox_on_cpu, workload):
    run = make_run(tiny_root, workload)
    line, report = _line(run, run.driver.run(run))
    assert line["correct"], report
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in run.end_to_end()}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-serve"])
def test_control_is_not_correct(tiny_root, philox_on_cpu, workload):
    """The program's sampler one precision below the configured one: int8
    for the training cell's bf16, bf16 for the serving cell's f32."""
    from readings import CONTROL

    run = make_run(tiny_root, workload, seed=12)
    stated = run.config["training"]["SAMPLER_MATMUL_DTYPE"]
    line, report = _line(run, run.driver.run(run, {"SAMPLER_MATMUL_DTYPE": CONTROL[stated]}))
    assert not line["correct"], report


CELLS = {"train_epochs": "tiny-train", "serve_closed_loop": "tiny-serve"}


@pytest.mark.parametrize("driver,fault", [(d, f) for d, fs in FAULTS.items() for f in fs])
def test_fault_is_not_correct(tiny_root, philox_on_cpu, monkeypatch, driver, fault):
    FAULTS[driver][fault](monkeypatch)
    run = make_run(tiny_root, CELLS[driver], seed=13)
    line, report = _line(run, run.driver.run(run))
    assert not line["correct"], report


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and exits non-zero."""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "scaled-pt-train",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()


class _StandInTracer:
    """The profiler's place on the CPU: a stretch whose trace holds one
    gather kernel and a copy, so every reader has something to read."""

    def __init__(self):
        self.summary = None

    def warm(self, work):
        work()

    def start(self):
        pass

    def stop(self):
        self.summary = {"stretch_s": 1.0, "busy_s": 0.25,
                        "kernel_s": {"sparse_sweeps_kernel<float, 8>": 0.01, "gemm": 0.2},
                        "device_ops": [["gemm", 0.2]], "idle_gaps": [["aten::item", 0.5]]}
        return self.summary


@pytest.fixture(autouse=True)
def stand_in_tracer(monkeypatch):
    """Every rehearsal profiles through the stand-in: the serving driver
    profiles its whole window in an untraced run too."""
    import core

    monkeypatch.setattr(core, "Tracer", _StandInTracer)


@pytest.mark.parametrize("workload", ["tiny-train", "tiny-serve"])
def test_traced_rehearsal_reads_every_metric(tiny_root, philox_on_cpu, workload):
    run = make_run(tiny_root, workload, seconds=1.5, trace=True)
    line, report = _line(run, run.driver.run(run))
    assert line["correct"], report
    assert set(line["metrics"]) == {m["name"] for m, _ in run.per_layer()}
    assert line["device"]["busy_s"] == 0.25 and "breakdown" in line
