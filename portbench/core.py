"""What every run of the benchmark shares.

``Run`` holds one run's settings, looked up by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``, whose ``driver`` names the general
generator in ``drivers/``), the limits its comparison holds the program to
(``checks/<workload>.json``) and the per-layer readers (``metrics/<metric>.py``)
that its per-layer metrics name.  A later cell, mix or metric is new files
and new entries: nothing here changes.

``Tracer`` profiles a steady stretch of a window with ``torch.profiler`` and
reduces its trace to the device's busy time, the kernels' time by name and
the longest idle gaps by the host operation that ran through them.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

__all__ = ["ROOT", "BENCH_DIR", "Run", "RunError", "Tracer", "load_module", "jax_modules",
           "result_line"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "image_generation_tpu")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
_ATTRIBUTED_GAPS = 500  # the longest gaps, each named by its host operation
_LONGEST_HOST_OP_US = 5e6


class RunError(RuntimeError):
    """A run that cannot give a result."""


def load_module(kind: str, name: str, root: Path = BENCH_DIR):
    """``<root>/<kind>/<name>.py`` as a module."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclass
class Run:
    """One run: ``workload`` of ``manifest`` at ``seed`` for ``seconds``."""

    manifest: dict
    workload: str
    seed: int
    seconds: float
    trace: bool
    root: Path = BENCH_DIR
    t_start: float = field(default_factory=time.perf_counter)

    def __post_init__(self):
        cells = {c["name"]: c for c in self.manifest["workloads"]}
        if self.workload not in cells:
            raise RunError(f"no workload named {self.workload!r} in BENCHMARK.json")
        self.cell = cells[self.workload]
        self.config = _json("configs", self.cell["config"], self.root)
        self.traffic = _json("traffic", self.cell["traffic"], self.root)
        self.driver = load_module("drivers", self.traffic["driver"], self.root)
        path = self.root / "checks" / f"{self.workload}.json"
        self.limits = json.loads(path.read_text()) if path.is_file() else {}

    def _applies(self, metric: dict, reported=None) -> bool:
        if "workloads" in metric:
            return self.workload in metric["workloads"]
        return reported is None or metric["moves"] in reported

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"] if self._applies(m)]

    def per_layer(self) -> list:
        """(metric, reader module) of every per-layer metric of this cell."""
        reported = {m["name"] for m in self.end_to_end()}
        return [(m, load_module("metrics", m["name"], self.root))
                for m in self.manifest["per_layer"] if self._applies(m, reported)]


def jax_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


class Tracer:
    """``torch.profiler`` over a stretch between ``start`` and ``stop``
    (each after a device synchronise), its events kept in memory and its
    trace written under ``TMPDIR`` only to be read back and deleted."""

    def __init__(self):
        import torch

        self._torch = torch
        self._prof = None
        self.summary: Optional[dict] = None

    def warm(self, work) -> None:
        """One profiled call of ``work`` in set-up, so that the profiler's
        first start (its device tracing's set-up) is not paid in the stretch."""
        self.start()
        work()
        self._torch.cuda.synchronize()
        self._prof.stop()
        self._prof = None

    def start(self) -> None:
        torch = self._torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        torch = self._torch
        torch.cuda.synchronize()
        stretch = time.perf_counter() - self._t0
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = reduce_trace(events, stretch)
        return self.summary


def reduce_trace(events: list, stretch_s: float) -> dict:
    """Busy seconds (the union of kernel and copy intervals), seconds by
    kernel name, and idle gaps between device intervals by the innermost
    host operation running across each gap's middle."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?"))
        if cat in DEVICE_CATEGORIES:
            dev.append(span)
        elif cat in HOST_CATEGORIES:
            host.append(span)
    by_name: dict = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    merged = []
    for s, t, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    holes = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])), reverse=True)
    gaps: dict = {}
    for width, a, b in holes[:_ATTRIBUTED_GAPS]:
        mid, name = 0.5 * (a + b), "no host operation"
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[j][1] >= mid:  # the latest-starting operation across the gap
                name = host[j][2]
                break
            if mid - host[j][0] > _LONGEST_HOST_OP_US:
                break
        gaps[name] = gaps.get(name, 0.0) + width * 1e-6
    if merged:
        edges = stretch_s - (merged[-1][1] - merged[0][0]) * 1e-6
        if edges > 0:
            gaps["stretch edges"] = gaps.get("stretch edges", 0.0) + edges
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"stretch_s": stretch_s, "busy_s": busy, "kernel_s": by_name,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def result_line(run: Run, result: dict, device: dict) -> tuple:
    """(the result's JSON object, the lines for standard error): the
    cell's metrics (per-layer ones read from the traced stretch under
    ``--trace 1``), ``correct`` from every compared number against its
    limit, and those numbers under ``checks``, the last key."""
    work = result.get("work", {})
    report, compared, passed = [], {}, True
    report += [f"portbench: {note}" for note in result.get("notes", [])]
    if run.trace:
        report.append(f"portbench: gather launches counted in the traced stretch: "
                      f"{work.get('gather_launches', 0)}")
    for name, value in result["checks"].items():
        limit = run.limits.get(name, "missing")
        if limit is None:  # named in the cell's limits as not compared (PERF.md)
            report.append(f"check {name}: {value!r} (not compared)")
            continue
        ok = limit != "missing" and value == value and value <= limit
        passed &= ok
        compared[name] = {"value": value, "limit": None if limit == "missing" else limit}
        report.append(f"check {name}: {value!r} (limit {compared[name]['limit']!r})"
                      + ("" if ok else " FAILED"))
    breakdown = None
    if run.trace:
        metrics = {}
        for m, reader in run.per_layer():
            value = reader.read(run, work)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        trace = work.get("trace")
        if trace:
            device = dict(device, busy_s=trace["busy_s"], window_s=trace["stretch_s"])
            breakdown = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(result["metrics"][m["name"]]), "unit": m["unit"]}
                   for m in run.end_to_end()}
    line = {"correct": bool(passed and result["failed"] == 0),
            "attempted": int(result["attempted"]), "failed": int(result["failed"]),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = compared
    return line, report
