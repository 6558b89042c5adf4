"""The port's span table (``training/observability.py``) and the spans at
its layer boundaries: serving (``app/warm.py``) and the training step
(``training/step.py``, ``training/trainer.py``).  CPU only, a few seconds.

A span costs one flag check with no profiler running; under
``torch.profiler`` it records name, clock, thread, parent and ids, and
the table keeps the newest profiled stretch.
"""

from __future__ import annotations

import json
import threading
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from image_generation_tpu_torch.app.warm import WarmGenerator
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.training import observability as obs
from image_generation_tpu_torch.training.observability import (
    profile,
    record,
    span,
    stretch_spans,
    tracing,
)
from image_generation_tpu_torch.training.trainer import Trainer

MODEL = Path(__file__).resolve().parent.parent / "runs" / "models" / "tpu_digits_40_epochs"
SMALL = dict(NUM_READS=16, GIBBS_BURN_IN=4)
TINY = dict(N_LATENTS=32, NUM_READS=8, BATCH_SIZE=8, DATASET_SIZE=16, N_REPLICAS=1,
            GIBBS_SWEEPS=2, GIBBS_BURN_IN=2, COMPUTE_DTYPE="float32",
            QPU="Advantage2_prototype")
PHASES = ["train.sampler", "train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiled():
    """A CPU profiler over a stretch of its own: an unprofiled span first,
    as between two profiled stretches of a run."""
    with span("off"):
        pass
    return torch_profile(activities=[ProfilerActivity.CPU])


def by_name(recs) -> dict:
    out: dict = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_no_profiler_no_record(monkeypatch):
    """Without a profiler a span enters no ``record_function``, takes no
    event and appends no record."""
    with profiled():
        with span("kept"):
            pass
    entered = []
    monkeypatch.setattr(obs, "record_function", lambda name: entered.append(name))

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was taken")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    before = list(obs.SPANS.records)
    for _ in range(3):
        with span("off.a", device=torch.device("cuda"), step=1) as rec:
            assert rec is None
        record("off.b", 1, 2, request=0)
    assert entered == [] and obs.SPANS.records == before
    assert [r["name"] for r in stretch_spans()] == ["kept"]


def test_spans_record_clock_parent_and_ids():
    with profiled():
        with span("outer", step=7) as outer:
            with span("inner", device=torch.device("cpu"), request=3):
                torch.ones(4).sum()
            with span("inner2"):
                pass
        record("queued", 10, 20, request=3, dispatch=0)
    recs = by_name(stretch_spans())
    o, i, i2, q = (recs[n][0] for n in ("outer", "inner", "inner2", "queued"))
    assert o["span"] == outer.span and o["ids"] == {"step": 7} and o["parent"] is None
    assert i["parent"] == o["span"] and i2["parent"] == o["span"]
    assert i["ids"] == {"request": 3} and i["thread"] == threading.get_ident()
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= i2["start_ns"] <= i2["end_ns"]
    assert i2["end_ns"] <= o["end_ns"]
    assert i["device_ms"] == pytest.approx((i["end_ns"] - i["start_ns"]) / 1e6)
    assert o["device_ms"] is None
    assert (q["start_ns"], q["end_ns"], q["parent"]) == (10, 20, None)
    assert q["ids"] == {"request": 3, "dispatch": 0}
    assert obs.SPANS.clock[0] <= o["start_ns"]


def test_table_holds_the_newest_stretch():
    with profiled():
        with span("first"):
            pass
    with span("between"):
        pass
    with torch_profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
        with span("second"):
            pass
    assert [r["name"] for r in stretch_spans()] == ["second", "second"]


def test_span_open_at_the_stop_is_left_out():
    """A span the profiler's stop cuts short (a request in flight) is not
    of the stretch; one closed before the stop is."""
    prof = profiled()
    prof.start()
    with span("whole"):
        pass
    cut = span("cut", device=torch.device("cpu"))
    cut.__enter__()
    prof.stop()
    cut.__exit__(None, None, None)
    assert [r["name"] for r in stretch_spans()] == ["whole"]


def test_table_bound_counts_dropped(monkeypatch):
    monkeypatch.setattr(obs.SPANS, "limit", 3)
    with profiled():
        for i in range(5):
            with span("s", i=i):
                pass
        record("late", 1, 2)
    assert [r["ids"]["i"] for r in stretch_spans()] == [0, 1, 2]
    assert obs.SPANS.dropped == 3


def test_tracing_follows_the_profiler():
    """``tracing()`` is on exactly while a profiler runs, in every thread."""
    seen = []
    assert not tracing()
    with profiled():
        th = threading.Thread(target=lambda: seen.append(tracing()))
        th.start()
        th.join(timeout=60)
        seen.append(tracing())
    assert seen == [True, True] and not tracing()


def test_warm_serve_spans(tmp_path):
    """Four threads through the coalescer: each request has one
    ``coalescer.queue`` and ``serve.reply``; each dispatch lists its
    requests, they add up to the served count, and its sampler call and
    decode are its children, the sampler model's build the sampler call's."""
    w = WarmGenerator(tmp_path, config_overrides=SMALL, device="cpu", serve_window_ms=50)
    w.warm_buckets(MODEL, 1)
    served0, errors = w.stats["served"], []

    def call():
        try:
            for _ in range(2):
                w.serve(MODEL)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(4)]
    with profiled():
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    recs = by_name(stretch_spans())
    per_request = {n: Counter(r["ids"]["request"] for r in recs[n])
                   for n in ("coalescer.queue", "serve.reply")}
    ids = set(per_request["coalescer.queue"])
    assert len(ids) == 8
    for n, count in per_request.items():
        assert set(count) == ids and set(count.values()) == {1}, n
    dispatches = recs["serve.dispatch"]
    assert sum(r["ids"]["k"] for r in dispatches) == w.stats["served"] - served0 == 8
    assert sorted(i for r in dispatches for i in r["ids"]["requests"]) == sorted(ids)
    assert all(len(r["ids"]["requests"]) == r["ids"]["k"] for r in dispatches)
    queue = {r["ids"]["request"]: r for r in recs["coalescer.queue"]}
    for r in dispatches:
        for i in r["ids"]["requests"]:
            assert queue[i]["ids"]["dispatch"] == r["ids"]["dispatch"]
            assert queue[i]["end_ns"] <= r["start_ns"]
    for name in ("serve.sample", "serve.decode"):
        assert sorted(r["parent"] for r in recs[name]) == sorted(r["span"] for r in dispatches)
    assert (sorted(r["parent"] for r in recs["sampler.build"])
            == sorted(r["span"] for r in recs["serve.sample"]))
    assert set(recs) == {"coalescer.queue", "serve.reply", "serve.dispatch", "serve.sample",
                         "sampler.build", "serve.decode"}


def test_train_step_spans():
    """Each step's phases in order, the scheduled GRBM update (every 10th
    step of the first epochs) only on step 0 here, its rebuild inside it."""
    t = Trainer(config=TrainingConfig(**TINY), device="cpu", seed=0)
    t.train_init(1)
    with profiled():
        t.train_epoch(0, n_chunks=2)
    recs = stretch_spans()
    steps = [r for r in recs if r["name"] == "train.step"]
    assert [r["ids"]["step"] for r in steps] == [0, 1]
    for s in steps:
        kids = sorted((r for r in recs if r["parent"] == s["span"]),
                      key=lambda r: r["start_ns"])
        want = PHASES + (["train.grbm_update"] if s["ids"]["step"] % 10 == 0 else [])
        assert [k["name"] for k in kids] == want
        assert all(k["device_ms"] > 0 for k in kids)
    update = [r for r in recs if r["name"] == "train.grbm_update"]
    rebuild = [r for r in recs if r["name"] == "train.sampler_rebuild"]
    assert len(update) == 1 and [r["parent"] for r in rebuild] == [update[0]["span"]]
    assert [r["ids"] for r in recs if r["name"] == "train.epoch_metrics"] == [{"epoch": 0}]


def test_profile_shares_the_trace_clock(tmp_path):
    """Under ``profile()`` a span opened in a second thread is in the
    exported trace, and starts within 1 ms of its record placed on unix
    time by the stretch's clock pair; the spans file holds it too."""
    def second():
        with span("second.thread"):
            torch.ones(8).sum()

    with profile(str(tmp_path)):
        th = threading.Thread(target=second)
        th.start()
        th.join(timeout=60)
    (trace,) = tmp_path.glob("trace_*.json")
    (spans,) = tmp_path.glob("spans_*.jsonl")
    doc = json.loads(trace.read_text())
    (ev,) = [e for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("name") == "second.thread"]
    (rec,) = [r for r in stretch_spans() if r["name"] == "second.thread"]
    perf0, unix0 = obs.SPANS.clock
    rec_unix_ns = unix0 + rec["start_ns"] - perf0
    ev_unix_ns = doc["baseTimeNanoseconds"] + float(ev["ts"]) * 1e3
    assert abs(rec_unix_ns - ev_unix_ns) < 1e6
    assert rec["thread"] != threading.get_ident()
    head, *lines = [json.loads(line) for line in spans.read_text().splitlines()]
    assert head["stretch"]["perf_counter_ns"] == perf0 and head["stretch"]["dropped"] == 0
    assert [r["name"] for r in lines] == ["second.thread"]
