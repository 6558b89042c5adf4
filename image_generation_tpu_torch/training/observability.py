"""Tracing and metrics: the trainer's observability layer.

Port of ``image_generation_tpu/training/observability.py``:

  * ``profile`` — context manager around ``torch.profiler``: writes a
    Chrome / Perfetto trace of the host (every thread, where the installed
    torch can) and, with a card visible, the device timeline into a
    directory (set ``IMGGEN_PROFILE_DIR`` or pass ``profile_dir`` to
    ``Trainer.train``), and beside it the stretch's spans as JSONL; a
    no-op without one;
  * ``MetricsLog`` — append-only JSONL of per-epoch metrics (mse, total
    loss, epoch wall time, images/s, the PT ladder's acceptance), the
    same records as the JAX package's.

And the port's own spans, which the profiler switches on:

  * ``span(name, device=None, **ids)`` — a context manager at a layer
    boundary.  With no profiler running it costs one check of the
    process-wide flag that ``torch.profiler`` sets for every thread.
    While one runs it enters ``torch.profiler.record_function(name)`` (the
    span sits in the trace wherever the profiler sees the thread), and
    appends one record to the span table: name, start and end
    (``time.perf_counter_ns``), thread, span id, the enclosing span of the
    same thread, ``ids`` (``request``, ``dispatch``, ``step``, ...) and,
    for a span given the ``device`` its work runs on, that work's device
    milliseconds: a CUDA event pair on the current stream, read when the
    table is read; on the CPU, whose operations finish before they
    return, the host interval's;
  * ``record(name, start_ns, end_ns, **ids)`` — an interval that one
    thread opens and another closes (a request's wait in a queue);
  * ``stretch_spans()`` — the records of the newest profiled stretch:
    a span that starts under a profiler after any span saw none begins a
    new stretch and clears the last, and a span still open when the
    profiler stops is left out.  ``SPANS.clock`` holds the
    (``perf_counter_ns``, ``time_ns``) pair taken at the stretch's first
    span, which places a record on a trace's clock (chrome-trace ``ts`` +
    ``baseTimeNanoseconds`` is unix time);
  * ``tracing()`` — whether a profiler runs, for a caller whose ids cost
    work to build.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["profile", "MetricsLog", "span", "record", "stretch_spans", "tracing", "SPANS",
           "MAX_SPANS"]

MAX_SPANS = 65_536  # records a stretch keeps; later ones are counted as dropped


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Trace what runs inside the block into ``log_dir`` (or
    ``$IMGGEN_PROFILE_DIR``) as ``trace_<pid>_<n>.json``, every thread's
    host operations where the installed torch can record them, and the
    block's spans as ``spans_<pid>_<n>.jsonl``; no-op when neither is
    set.  Yields the directory (None when not tracing)."""
    log_dir = log_dir or os.environ.get("IMGGEN_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    SPANS.saw_off = True  # the block's spans are a stretch of their own
    with torch_profile(activities=activities,
                       experimental_config=_all_threads_config()) as prof:
        yield str(out)
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))
    # the stretch's spans: a line with its clock pair and dropped count, then a record a line
    recs = stretch_spans()
    clock = SPANS.clock or (None, None)
    with open(out / f"spans_{os.getpid()}_{n}.jsonl", "w") as f:
        f.write(json.dumps({"stretch": {"perf_counter_ns": clock[0], "time_ns": clock[1],
                                        "dropped": SPANS.dropped}}) + "\n")
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _all_threads_config():
    """The profiler's setting that records every thread's host operations
    (by default only the thread that started it), or None where the
    installed torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class _Record:
    __slots__ = ("name", "start_ns", "end_ns", "thread", "span", "parent", "ids", "device",
                 "events", "device_ms")

    def as_dict(self) -> dict:
        return {"name": self.name, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "thread": self.thread, "span": self.span, "parent": self.parent,
                "ids": self.ids, "device_ms": self.device_ms}


class SpanTable:
    """The spans of the newest profiled stretch.  One table a process
    (``SPANS``), as the profiler that switches it is one a process."""

    def __init__(self):
        self.limit = MAX_SPANS
        self.records: list = []
        self.dropped = 0
        self.clock: Optional[tuple] = None  # (perf_counter_ns, time_ns) at the first span
        self.saw_off = True  # a span found no profiler since the stretch began
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._events: list = []  # CUDA events free for reuse

    def open(self, name: str, ids: dict, device, start_ns: int = 0,
             end_ns: Optional[int] = None) -> Optional[_Record]:
        """A new record of this thread (None once the stretch is full),
        beginning a new stretch if a span saw the profiler off."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec = _Record()
        rec.name, rec.ids, rec.device = name, ids, device
        rec.thread, rec.span = threading.get_ident(), next(self._ids)
        rec.parent = stack[-1] if stack and end_ns is None else None
        rec.start_ns, rec.end_ns, rec.events, rec.device_ms = start_ns, end_ns, None, None
        with self._lock:
            if self.saw_off:
                self.saw_off = False
                self._free(self.records)
                self.records, self.dropped = [], 0
                self.clock = (time.perf_counter_ns(), time.time_ns())
            if len(self.records) >= self.limit:
                self.dropped += 1
                return None
            if device is not None and device.type == "cuda":
                rec.events = [self._events.pop() if self._events
                              else torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.records.append(rec)
        if end_ns is None:
            stack.append(rec.span)
        return rec

    def pop(self) -> None:
        """Close this thread's innermost open span."""
        self._local.stack.pop()

    def _free(self, records) -> None:
        for r in records:
            if r.events is not None:
                self._events.extend(r.events)
                r.events = None

    def spans(self) -> list:
        """The newest stretch's closed records as dicts, device times read
        (a wait for the card where a device span's events are pending)."""
        with self._lock:
            recs = [r for r in self.records if r.end_ns is not None]
        pending = [r for r in recs if r.events is not None]
        for r in pending:
            r.events[1].synchronize()
            r.device_ms = r.events[0].elapsed_time(r.events[1])
        with self._lock:
            self._free(pending)
        for r in recs:
            if r.device is not None and r.device.type == "cpu":
                r.device_ms = (r.end_ns - r.start_ns) / 1e6
        return [r.as_dict() for r in recs]


SPANS = SpanTable()


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "ids", "rec", "rf")

    def __init__(self, name: str, device, ids: dict):
        self.name, self.device, self.ids = name, device, ids

    def __enter__(self):
        self.rec = rec = SPANS.open(self.name, self.ids, self.device)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if rec is not None:
            if rec.events is not None:
                rec.events[0].record(torch.cuda.current_stream(self.device))
            rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            end = time.perf_counter_ns()
            SPANS.pop()
            # a span the profiler's stop cut short is not of the stretch: left open
            if _autograd_profiler._is_profiler_enabled:
                if rec.events is not None:
                    rec.events[1].record(torch.cuda.current_stream(self.device))
                rec.end_ns = end
        self.rf.__exit__(*exc)
        return False


def span(name: str, *, device: Optional[torch.device] = None, **ids):
    """A span named ``name`` around the ``with`` block (see the module's
    docstring); ``device``: the device the block's work runs on, whose
    time the record then holds as ``device_ms``."""
    # the flag's read and the note that it was off run with no call
    # between them, so no other thread runs in between (the GIL)
    if not _autograd_profiler._is_profiler_enabled:
        SPANS.saw_off = True
        return _OFF
    return _Span(name, device, ids)


def record(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """A record of the interval [``start_ns``, ``end_ns``]
    (``perf_counter_ns``), taken where it closes; no parent."""
    if not _autograd_profiler._is_profiler_enabled:
        SPANS.saw_off = True
        return
    SPANS.open(name, ids, None, start_ns, end_ns)


def stretch_spans() -> list:
    """The records of the newest profiled stretch (``SpanTable.spans``)."""
    return SPANS.spans()


def tracing() -> bool:
    """Whether a profiler runs, so that spans record."""
    return _autograd_profiler._is_profiler_enabled


class MetricsLog:
    """Append-only JSONL metrics stream (one record per epoch/event)."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.perf_counter()

    def log(self, event: str, **fields) -> dict:
        rec = {"event": event, "t": round(time.perf_counter() - self._t0, 3), **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def read(self) -> list:
        if not self.path.exists():
            return []
        return [json.loads(line) for line in self.path.read_text().splitlines() if line]
