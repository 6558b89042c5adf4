"""Build and load the port's CUDA kernels.

Every ``.cu`` source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, under ``_build/`` in this
package, and bound with ``ctypes`` by its wrapper module.  The libraries
are keyed on one hash of every source, the headers they include and the
flags.  The first call builds whatever is missing, one ``nvcc`` per
source, all started together, and loads every library; later calls return
the loaded ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

__all__ = ["KernelLibrary", "SOURCES", "load_libraries"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {  # library name -> source
    "gibbs_sweeps": _PKG / "csrc" / "gibbs_sweeps.cu",  # K1
    "gibbs_hbm": _PKG / "csrc" / "gibbs_hbm.cu",  # K2, K3
    "span_update": _PKG / "csrc" / "span_update.cu",  # K4
}
_HEADERS = (_PKG / "csrc" / "gibbs_common.cuh",)  # included by the sources above
_BUILD_DIR = _PKG / "_build"
# no --use_fast_math: expf stays within an ulp of torch.sigmoid's exp
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str  # nvcc/ptxas output of the build ("" when not rebuilt)


_libraries: Optional[Dict[str, KernelLibrary]] = None
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        shutil.which("nvcc"),
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the sweep kernels cannot be built"
    )


def load_libraries() -> Dict[str, KernelLibrary]:
    """Build (once per hash of all sources) and load every kernel library."""
    global _libraries
    with _lock:
        if _libraries is not None:
            return _libraries
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for name in sorted(SOURCES):
            h.update(name.encode() + SOURCES[name].read_bytes())
        for header in sorted(_HEADERS):
            h.update(header.name.encode() + header.read_bytes())
        digest = h.hexdigest()[:16]
        targets = {name: _BUILD_DIR / f"{name}_{digest}.so" for name in SOURCES}
        jobs = {}
        for name, so in targets.items():
            if so.exists():
                continue
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = _BUILD_DIR / f".{name}_{digest}.{os.getpid()}.so"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[name] = (cmd, tmp, proc, time.perf_counter())
        built = {}
        for name, (cmd, tmp, proc, t0) in jobs.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                for _cmd, other, p, _t in jobs.values():  # stop the other builds
                    p.kill()
                    p.wait()
                    other.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, targets[name])  # atomic: a concurrent build never loads half a file
            built[name] = (seconds, log)
        _libraries = {
            name: KernelLibrary(ctypes.CDLL(str(so)), so, *built.get(name, (0.0, "")))
            for name, so in targets.items()
        }
        return _libraries
