"""Kernel K4: the class-span Bernoulli update of the graph-sharded sweep, in
CUDA C++ for Hopper.

Replaces ``image_generation_tpu/ops/gibbs_graph_sharded_pallas.py``
(``_update_hw_kernel``, ``_update_hw_rowseed_kernel``,
``_update_fed_kernel``; factory ``make_pallas_update``).  The source is
``csrc/span_update.cu``; its header note says what bounds the kernel on the
H100.  ``ops/cuda_build.py`` builds it beside K1-K3, and it is bound here
with ``ctypes``.

``span_update`` is the wrapper: fields (rows, width) f32 in real units, β
per row or scalar, and either fed uniforms (a (rows, width) view whose rows
may be strided, as the span's columns of a (n_sweeps, chains, n_pad) array
are) or a 64-bit Philox seed, with the global row / column of element
(0, 0) and the sweep index that key the counter.  It returns the new ±1
spins in f32.  For a tensor on the CPU it runs the plain version,
``span_update_reference``; for a CUDA tensor it launches K4 or raises.
``span_update.launches`` counts launches: ``"K4"`` (Philox) and ``"K4f"``
(fed).

What the TPU kernels needed and this one does not: the row tile
(``_pick_tile``, ``_pick_tile_grouped``) and the 8-row alignment error of
the row-seeded variant are Mosaic VMEM and SMEM rules (ROADMAP.md queue 1
item 8).  The Philox counter (global column, global row, sweep, 0) does not
depend on the mesh, so one kernel gives both the tile-seeded and the
row-seeded variant's guarantees: every rank of a graph axis draws the same
update, and another mesh draws the same chain.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.ops.cuda_build import KernelLibrary, load_libraries

__all__ = [
    "span_update",
    "span_update_reference",
    "philox_span_uniforms",
    "load_library",
]

_THREADS = 256  # kThreads in the source

_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


def load_library() -> KernelLibrary:
    """Build (once per source hash, with the other kernels) and load K4's
    library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        built = load_libraries()["span_update"]
        lib = built.lib
        lib.span_update.argtypes = [
            ctypes.c_void_p,  # fields
            ctypes.c_void_p,  # beta
            ctypes.c_int,  # beta_per_row
            ctypes.c_void_p,  # uniforms (null: Philox)
            ctypes.c_longlong,  # ld_u
            ctypes.c_void_p,  # seed (null: fed)
            ctypes.c_void_p,  # out
            ctypes.c_int,  # rows
            ctypes.c_int,  # width
            ctypes.c_int,  # row0
            ctypes.c_int,  # col0
            ctypes.c_int,  # sweep
            ctypes.c_void_p,  # stream
        ]
        lib.span_update.restype = ctypes.c_int
        lib.span_update_error_string.argtypes = [ctypes.c_int]
        lib.span_update_error_string.restype = ctypes.c_char_p
        lib.span_update_threads.argtypes = []
        lib.span_update_threads.restype = ctypes.c_int
        if lib.span_update_threads() != _THREADS:
            raise RuntimeError("kernel library and wrapper disagree on kThreads")
        _library = built
        return _library


def philox_span_uniforms(seed: int, sweep: int, row0: int, rows: int, col0: int,
                         width: int) -> np.ndarray:
    """The (rows, width) f32 uniforms K4 draws in Philox mode: element
    (r, c) of ``gibbs_cuda.philox_uniforms(seed, sweep + 1, row0 + rows,
    col0 + width)[sweep]`` at (row0 + r, col0 + c)."""
    from image_generation_tpu_torch.ops.gibbs_cuda import _philox4x32_10

    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    row, col = np.meshgrid(np.arange(row0, row0 + rows, dtype=np.uint64),
                           np.arange(col0, col0 + width, dtype=np.uint64), indexing="ij")
    bits = _philox4x32_10(col, row, np.full_like(col, sweep), np.zeros_like(col),
                          seed & 0xFFFFFFFF, seed >> 32)
    return (bits >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)


def _beta_col(beta, rows: int, device) -> torch.Tensor:
    b = torch.as_tensor(beta, dtype=torch.float32, device=device)
    if b.ndim == 0:
        return b
    if b.numel() != rows:
        raise ValueError(f"beta must be a scalar or have {rows} rows, got {tuple(b.shape)}")
    return b.reshape(rows, 1)


def span_update_reference(fields: torch.Tensor, beta=1.0, *,
                          uniforms: Optional[torch.Tensor] = None,
                          seed: Optional[torch.Tensor] = None, row0: int = 0,
                          col0: int = 0, sweep: int = 0) -> torch.Tensor:
    """The plain version of K4: ``where(u < σ(−2β·fields), +1, −1)`` in f32
    with fed ``uniforms`` or, given ``seed``, the uniforms of K4's Philox
    stream (``philox_span_uniforms``)."""
    rows, width = fields.shape
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms (fed) and seed (Philox)")
    if uniforms is None:
        uniforms = torch.from_numpy(philox_span_uniforms(
            int(seed.reshape(-1)[0]), sweep, row0, rows, col0, width)).to(fields.device)
    p_plus = torch.sigmoid(-2.0 * _beta_col(beta, rows, fields.device) * fields)
    return torch.where(uniforms < p_plus, 1.0, -1.0)


def span_update(fields: torch.Tensor, beta=1.0, *,
                uniforms: Optional[torch.Tensor] = None,
                seed: Optional[torch.Tensor] = None, row0: int = 0, col0: int = 0,
                sweep: int = 0) -> torch.Tensor:
    """One class span's Bernoulli update through K4: new (rows, width) f32
    ±1 spins from ``fields`` (rows, width) f32, ``beta`` (scalar or
    (rows,)), and fed ``uniforms`` (rows, width) or a (1,) int64 Philox
    ``seed`` on the fields' device.  ``row0`` / ``col0``: the global chain
    row and padded column of element (0, 0); ``sweep``: the counter's
    sweep index.  A CPU ``fields`` runs the plain version; a CUDA one
    launches the kernel, and anything it does not take raises."""
    if fields.device.type == "cpu":
        return span_update_reference(fields, beta, uniforms=uniforms, seed=seed, row0=row0,
                                     col0=col0, sweep=sweep)
    if fields.device.type != "cuda":
        raise ValueError(f"no span-update kernel for device {fields.device}")
    dev = fields.device
    if fields.ndim != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError(f"fields must be a contiguous 2-D f32 tensor, got {fields.dtype} "
                         f"{tuple(fields.shape)}")
    rows, width = fields.shape
    if rows < 1 or width < 1 or min(row0, col0, sweep) < 0:
        raise ValueError(f"bad span: {rows} rows x {width} columns at ({row0}, {col0}), "
                         f"sweep {sweep}")
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms (fed) and seed (Philox)")
    b = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if b.ndim and b.numel() != rows:
        raise ValueError(f"beta must be a scalar or have {rows} rows, got {tuple(b.shape)}")
    b = b.reshape(-1).contiguous()
    if uniforms is not None:
        if (uniforms.device != dev or uniforms.dtype != torch.float32
                or tuple(uniforms.shape) != (rows, width) or uniforms.stride(1) != 1):
            raise ValueError(f"uniforms must be a ({rows}, {width}) f32 view with unit column "
                             f"stride on {dev}")
        ld_u = uniforms.stride(0) if rows > 1 else width
    else:
        if seed.device != dev or seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError("seed must be one int64 on the fields' device")
        ld_u = 0
    out = torch.empty_like(fields)
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.span_update(
            fields.data_ptr(), b.data_ptr(), int(b.numel() > 1),
            uniforms.data_ptr() if uniforms is not None else None, ld_u,
            seed.data_ptr() if seed is not None else None, out.data_ptr(),
            rows, width, int(row0), int(col0), int(sweep), stream,
        )
    if err != 0:
        msg = lib.span_update_error_string(err).decode()
        raise RuntimeError(f"span_update (K4) launch failed: {msg} ({err})")
    span_update.launches["K4f" if uniforms is not None else "K4"] += 1
    return out


span_update.launches = collections.Counter()
