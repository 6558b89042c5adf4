"""Readings of the program's own spans over a traced stretch.

The program keeps the spans of its newest profiled stretch in memory
(``image_generation_tpu_torch.training.observability.stretch_spans``):
one record a span, with its name, ``start_ns`` and ``end_ns``
(``time.perf_counter_ns``), ``ids`` and, for a span around device work,
``device_ms``.  A reader keeps the records that start within the traced
stretch's seconds of its last end, and returns None where they hold no
span of the name it reads, or where the program keeps no spans.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def program_spans() -> Optional[list]:
    """The program's newest stretch, or None where it records no spans."""
    try:
        from image_generation_tpu_torch.training.observability import stretch_spans
    except ImportError:
        return None
    return stretch_spans()


def traced_spans(work: dict) -> list:
    """The spans of the traced stretch (empty where there are none)."""
    trace = work.get("trace")
    spans = program_spans() if trace else None
    if not spans:
        return []
    return within(spans, trace["stretch_s"])


def within(spans: list, stretch_s: float) -> list:
    """The records that start within ``stretch_s`` of the last end."""
    last = max(s["end_ns"] for s in spans)
    return [s for s in spans if s["start_ns"] >= last - stretch_s * 1e9]


def named(spans: list, name: str) -> list:
    return sorted((s for s in spans if s["name"] == name), key=lambda s: s["start_ns"])


def durations_ms(spans: list, name: str) -> list:
    return [(s["end_ns"] - s["start_ns"]) / 1e6 for s in named(spans, name)]


def mean_ms(spans: list, name: str) -> Optional[float]:
    """Mean duration of the spans named ``name``."""
    d = durations_ms(spans, name)
    return float(np.mean(d)) if d else None


def p95_ms(spans: list, name: str) -> Optional[float]:
    """95th percentile of their durations."""
    d = durations_ms(spans, name)
    return float(np.percentile(d, 95)) if d else None


def mean_gap_ms(spans: list, name: str) -> Optional[float]:
    """Mean time from one such span's end to the next one's start."""
    s = named(spans, name)
    gaps = [(b["start_ns"] - a["end_ns"]) / 1e6 for a, b in zip(s, s[1:])]
    return float(np.mean(gaps)) if gaps else None


def device_ms_a_step(spans: list, name: str, step: str = "train.step") -> Optional[float]:
    """The device milliseconds of the spans named ``name`` over the
    stretch's steps (``step`` spans with device times)."""
    steps = [s for s in named(spans, step) if s["device_ms"] is not None]
    times = [s["device_ms"] for s in named(spans, name) if s["device_ms"] is not None]
    if not steps or not times:
        return None
    return float(sum(times)) / len(steps)
