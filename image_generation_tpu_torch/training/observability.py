"""Tracing and metrics: the trainer's observability layer.

Port of ``image_generation_tpu/training/observability.py``:

  * ``profile`` — context manager around ``torch.profiler``: writes a
    Chrome / Perfetto trace of the host and, with a card visible, the
    device timeline into a directory (set ``IMGGEN_PROFILE_DIR`` or pass
    ``profile_dir`` to ``Trainer.train``); a no-op without one;
  * ``MetricsLog`` — append-only JSONL of per-epoch metrics (mse, total
    loss, epoch wall time, images/s, the PT ladder's acceptance), the
    same records as the JAX package's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Optional

__all__ = ["profile", "MetricsLog"]


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Trace what runs inside the block into ``log_dir`` (or
    ``$IMGGEN_PROFILE_DIR``) as ``trace_<pid>_<n>.json``; no-op when
    neither is set.  Yields the directory (None when not tracing)."""
    log_dir = log_dir or os.environ.get("IMGGEN_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        yield str(out)
    n = len(list(out.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{n}.json"))


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
