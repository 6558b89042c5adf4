"""The per-layer readers of the program's spans (``yardstick/span_reads.py``
and the ten ``metrics/*.py`` that call it): each fed a made-up stretch,
then a traced rehearsal of each traffic generator (``drivers/``) on the CPU
under a real profiler."""

from __future__ import annotations

import json
import time

import pytest

from conftest import BENCH, make_run

SERVE = ["dispatch_ms.serve", "dispatch_gap_ms.serve", "queue_ms_p95.serve", "reply_ms.serve",
         "sample_ms.serve", "decode_ms.serve"]
TRAIN = ["sampler_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train"]
MS = 1_000_000


def _rec(name, start_ms, end_ms, device_ms=None, **ids):
    return {"name": name, "start_ns": int(start_ms * MS), "end_ns": int(end_ms * MS),
            "thread": 1, "span": 0, "parent": None, "ids": ids, "device_ms": device_ms}


def _read(monkeypatch, name, spans, stretch_s=1.0):
    from core import load_module
    from yardstick import span_reads

    monkeypatch.setattr(span_reads, "program_spans", lambda: spans)
    return load_module("metrics", name).read(None, {"trace": {"stretch_s": stretch_s}})


def _serving_stretch():
    spans = [_rec("coalescer.queue", 0, 2), _rec("coalescer.queue", 1, 12)]
    for i, start in enumerate((10, 40, 80)):  # dispatches of 10, 20 and 5 ms
        spans.append(_rec("serve.dispatch", start, start + (10, 20, 5)[i], dispatch=i,
                          requests=[i], k=1))
        spans.append(_rec("serve.sample", start + 1, start + 1 + (4, 6, 2)[i]))
        spans.append(_rec("serve.decode", start + 8, start + 8 + (1, 2, 6)[i]))
    spans += [_rec("serve.reply", 30, 31), _rec("serve.reply", 60, 63)]
    spans += [_rec("coalescer.queue", 20, 20 + q) for q in range(1, 21)]
    return spans


@pytest.mark.parametrize("name,want", [
    ("dispatch_ms.serve", (10 + 20 + 5) / 3),
    ("dispatch_gap_ms.serve", ((40 - 20) + (80 - 60)) / 2),
    ("reply_ms.serve", 2.0),
    ("sample_ms.serve", 4.0),
    ("decode_ms.serve", 3.0),
])
def test_serving_readers(monkeypatch, name, want):
    assert _read(monkeypatch, name, _serving_stretch()) == pytest.approx(want)


def test_queue_p95(monkeypatch):
    import numpy as np

    waits = [2, 11] + list(range(1, 21))
    assert _read(monkeypatch, "queue_ms_p95.serve", _serving_stretch()) \
        == pytest.approx(float(np.percentile(waits, 95)))


def _training_stretch():
    spans = []
    for s in range(3):
        t = 200 * s
        spans.append(_rec("train.step", t, t + 190, 180.0, step=s))
        for name, dev in (("train.sampler", 10.0), ("train.forward", 40.0),
                          ("train.backward", 100.0), ("train.optimizer", 5.0)):
            spans.append(_rec(name, t, t + 1, dev))
        if s == 0:
            spans.append(_rec("train.grbm_update", t + 2, t + 3, 20.0))
            spans.append(_rec("train.sampler", t + 2, t + 3, 3.0))  # not a phase of its own
    return spans


@pytest.mark.parametrize("name,want", [("sampler_ms.train", 10.0 + 3.0 / 3),
                                       ("forward_ms.train", 40.0),
                                       ("backward_ms.train", 100.0),
                                       ("optimizer_ms.train", 5.0)])
def test_training_readers(monkeypatch, name, want):
    assert _read(monkeypatch, name, _training_stretch()) == pytest.approx(want)


def test_stretch_filter_drops_older_records(monkeypatch):
    """A record that starts more than the stretch's seconds before the last
    end is not of the traced stretch."""
    spans = [_rec("serve.dispatch", 0, 1000), _rec("serve.dispatch", 3000, 3010),
             _rec("serve.dispatch", 3100, 3120)]
    assert _read(monkeypatch, "dispatch_ms.serve", spans, stretch_s=1.0) == pytest.approx(15.0)
    assert _read(monkeypatch, "dispatch_ms.serve", spans, stretch_s=5.0) \
        == pytest.approx(1030 / 3)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read_is_none(monkeypatch, name):
    """None where the program keeps no spans (a parent commit), where the
    stretch holds none of the name, and where the run was not traced."""
    from core import load_module
    from yardstick import span_reads

    assert _read(monkeypatch, name, None) is None
    assert _read(monkeypatch, name, [_rec("other", 0, 1, 1.0)]) is None
    monkeypatch.setattr(span_reads, "program_spans", _training_stretch)
    assert load_module("metrics", name).read(None, {"trace": None}) is None


def test_a_program_without_the_table_reads_nothing(monkeypatch):
    """The parent's program has no ``stretch_spans``: the import fails and
    the readers return None, not an error."""
    import builtins

    from yardstick import span_reads

    real = builtins.__import__

    def old_program(name, *args, **kw):
        if name == "image_generation_tpu_torch.training.observability":
            raise ImportError("cannot import name 'stretch_spans'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", old_program)
    assert span_reads.program_spans() is None


def test_entries_are_in_the_manifest():
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in SERVE:
        assert entries[name]["workloads"] == ["flagship-serve-c16"]
        assert entries[name]["moves"] == "serve_card_us_per_image"
    for name in TRAIN:
        assert entries[name]["workloads"] == ["scaled-pt-train"]
        assert entries[name]["moves"] == "train_images_per_s"
    assert all(entries[n]["unit"] == "ms" and entries[n]["better"] == "lower"
               for n in SERVE + TRAIN)


class _CpuProfiler:
    """The harness's tracer on the CPU: ``torch.profiler`` over the stretch
    (so the program's spans record), and a summary that holds a gather
    kernel for the trace's readers."""

    def __init__(self):
        self.summary, self._prof = None, None

    def warm(self, work):
        self.start()
        work()
        self._prof.stop()
        self._prof = None

    def start(self):
        import torch

        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        stretch = time.perf_counter() - self._t0
        self._prof.stop()
        self._prof = None
        self.summary = {"stretch_s": stretch, "busy_s": 0.25 * stretch,
                        "kernel_s": {"sparse_sweeps_kernel<float, 8>": 0.01, "gemm": 0.2},
                        "device_ops": [["gemm", 0.2]], "idle_gaps": [["aten::item", 0.5]]}
        return self.summary


@pytest.mark.parametrize("workload,names", [("tiny-train", TRAIN), ("tiny-serve", SERVE)])
def test_traced_rehearsal_reads_the_spans(tiny_root, philox_on_cpu, monkeypatch, workload,
                                          names):
    """A traced run of each traffic generator under a real profiler: every span
    metric of the cell reads a number, and the run stays correct."""
    import core
    from core import result_line

    monkeypatch.setattr(core, "Tracer", _CpuProfiler)
    run = make_run(tiny_root, workload, seconds=1.5, trace=True)
    result = run.driver.run(run)
    line, report = result_line(run, result, {"platform": "cpu", "kind": "cpu", "count": 1,
                                             "memory_peak_bytes": 0})
    assert line["correct"], report
    got = {n: line["metrics"][n]["value"] for n in names if n in line["metrics"]}
    assert set(got) == set(names) and all(v > 0 for v in got.values()), got
    if workload == "tiny-serve":
        from image_generation_tpu_torch.training.observability import stretch_spans

        dispatches = [s for s in stretch_spans() if s["name"] == "serve.dispatch"]
        assert [s["ids"]["k"] for s in dispatches] == result["work"]["dispatches"]
