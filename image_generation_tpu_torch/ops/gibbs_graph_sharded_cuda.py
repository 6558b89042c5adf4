"""Kernel K4: the class-span Bernoulli update of the graph-sharded sweep, in
CUDA C++ for Hopper.

Replaces ``image_generation_tpu/ops/gibbs_graph_sharded_pallas.py``
(``_update_hw_kernel``, ``_update_hw_rowseed_kernel``,
``_update_fed_kernel``; factory ``make_pallas_update``).  The source is
``csrc/span_update.cu``; its header note says what bounds the kernel on the
H100 and why it is shaped as it is.  ``ops/cuda_build.py`` builds it beside
the other kernels, and it is bound here with ``ctypes``.

One kernel, two entries:

* ``span_update_window``: a rank's owned-window update of one class span.
  From the span's all-reduced partial products (f32, or int32 and the
  int8 coupling's scale, or none where no shard couples into the span) and
  ``h`` it forms the fields of the columns the rank owns, draws the new
  ±1 spins (fed uniforms read at global columns, or Philox at the counter
  (global column, global chain row, sweep, 0)), adds fields·(new − old)
  to the per-chain ΔE and writes the spins in place into the rank's
  window in the carry's dtype (f32, bf16 or int8).  Its plain version,
  ``span_update_window_reference``, is the composition it replaces:
  ``span_update_reference`` on the whole span, the slice, the ΔE sum and
  the write.  ``SpanWindowUpdate`` is the same entry made once per sweep
  run: it validates and prepares what does not change from span to span
  (the library, the stream, β, the pointers and leading dimensions of the
  window, the uniforms and ΔE), so that a span costs one ``ctypes`` call.
* ``span_update``: the whole span's update from its fields into a fresh
  (rows, width) f32 buffer, the case of the same kernel where the window
  is the span; its plain version is ``span_update_reference``.

For tensors on the CPU each entry runs its plain version; for CUDA tensors
it launches K4 or raises.  ``span_update.launches`` counts launches of
either entry: ``"K4"`` (Philox) and ``"K4f"`` (fed).

What the TPU kernels needed and this one does not: the row tile
(``_pick_tile``, ``_pick_tile_grouped``) and the 8-row alignment error of
the row-seeded variant are Mosaic VMEM and SMEM rules (ROADMAP.md queue 1
item 8).  The Philox counter does not depend on the mesh, so one kernel
gives both the tile-seeded and the row-seeded variant's guarantees: every
rank of a graph axis draws the same update, and another mesh draws the
same chain.
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
    "SpanWindowUpdate",
    "span_update",
    "span_update_reference",
    "span_update_window",
    "span_update_window_reference",
    "philox_span_uniforms",
    "load_library",
]

_THREADS = 256  # kThreads in the source
_SPIN_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # SpinType
_PARTIAL_KINDS = {torch.float32: 1, torch.int32: 2}  # PartialKind (0: no partial)


class _Args(ctypes.Structure):
    """``SpanWindowArgs`` of the source, field for field."""

    _fields_ = [
        ("h", ctypes.c_void_p),
        ("beta", ctypes.c_void_p),
        ("scale", ctypes.c_void_p),
        ("uniforms", ctypes.c_void_p),
        ("seed", ctypes.c_void_p),
        ("spins", ctypes.c_void_p),
        ("delta_e", ctypes.c_void_p),
        ("ld_u", ctypes.c_longlong),
        ("sweep_u", ctypes.c_longlong),
        ("ld_s", ctypes.c_longlong),
        ("beta_per_row", ctypes.c_int),
        ("spin_type", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("lo", ctypes.c_int),
        ("cols", ctypes.c_int),
        ("u_col0", ctypes.c_int),
        ("row0", ctypes.c_int),
        ("device", ctypes.c_int),
        ("stream", ctypes.c_void_p),
    ]


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
        lib.span_window.argtypes = [
            ctypes.c_void_p,  # const SpanWindowArgs*
            ctypes.c_void_p,  # partial (null: none)
            ctypes.c_int,  # kind
            ctypes.c_longlong,  # ld_p
            ctypes.c_int,  # start
            ctypes.c_int,  # a
            ctypes.c_int,  # b
            ctypes.c_int,  # sweep
        ]
        lib.span_window.restype = ctypes.c_int
        lib.span_update_error_string.argtypes = [ctypes.c_int]
        lib.span_update_error_string.restype = ctypes.c_char_p
        for name in ("span_update_threads", "span_window_args_size"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if lib.span_update_threads() != _THREADS:
            raise RuntimeError("kernel library and wrapper disagree on kThreads")
        if lib.span_window_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("kernel library and wrapper disagree on SpanWindowArgs")
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
    """The plain version of K4's whole-span update: ``where(u <
    σ(−2β·fields), +1, −1)`` in f32 with fed ``uniforms`` or, given
    ``seed``, the uniforms of K4's Philox stream
    (``philox_span_uniforms``)."""
    rows, width = fields.shape
    if (uniforms is None) == (seed is None):
        raise ValueError("give exactly one of uniforms (fed) and seed (Philox)")
    if uniforms is None:
        uniforms = torch.from_numpy(philox_span_uniforms(
            int(seed.reshape(-1)[0]), sweep, row0, rows, col0, width)).to(fields.device)
    p_plus = torch.sigmoid(-2.0 * _beta_col(beta, rows, fields.device) * fields)
    return torch.where(uniforms < p_plus, 1.0, -1.0)


def _owned(lo: int, cols: int, start: int, stop: int):
    """The owned columns [a, b) of span [start, stop) in window [lo, lo +
    cols); raises where they are empty (the sweep makes no call there)."""
    a, b = max(start, lo), min(stop, lo + cols)
    if not 0 <= start < stop or a >= b:
        raise ValueError(f"span [{start}, {stop}) has no column in the window "
                         f"[{lo}, {lo + cols}): nothing to update")
    return a, b


def span_update_window_reference(partial: Optional[torch.Tensor], h: Optional[torch.Tensor],
                                 beta, spins: torch.Tensor, lo: int, start: int, stop: int, *,
                                 scale: Optional[torch.Tensor] = None,
                                 uniforms: Optional[torch.Tensor] = None,
                                 seed: Optional[torch.Tensor] = None, u_col0: int = 0,
                                 row0: int = 0, sweep: int = 0,
                                 delta_e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``span_update_window``: the composition the
    kernel replaces.  The span's fields (``partial`` (rows, stop − start),
    scaled out by ``scale`` when it is int32, plus ``h[start:stop]``; ``h``
    alone without a partial; the partial alone without ``h``), the whole
    span's update by ``span_update_reference`` (``uniforms``: the sweep's
    (rows, n_cols) plane, column 0 at global column ``u_col0``), then the owned columns
    sliced out, ``delta_e += (fields · (new − old)).sum(-1)`` over them and
    the new spins written into ``spins`` (rows, cols), the window whose
    column 0 is global column ``lo``, in its dtype.  Returns ``spins``."""
    rows, cols = spins.shape
    a, b = _owned(lo, cols, start, stop)
    if partial is None:
        if h is None:
            raise ValueError("give the partial products, h or both")
        fields = h[start:stop].expand(rows, stop - start)
    else:
        fields = partial.to(torch.float32) * scale if scale is not None else partial
        if h is not None:
            fields = fields + h[start:stop]
    u = None if uniforms is None else uniforms[:, start - u_col0: stop - u_col0]
    new = span_update_reference(fields, beta, uniforms=u, seed=seed, row0=row0, col0=start,
                                sweep=sweep)
    mine = new[:, a - start: b - start]
    if delta_e is not None:
        old = spins[:, a - lo: b - lo].to(torch.float32)
        delta_e += (fields[:, a - start: b - start] * (mine - old)).sum(-1)
    spins[:, a - lo: b - lo] = mine.to(spins.dtype)
    return spins


class SpanWindowUpdate:
    """``span_update_window`` prepared once for a sweep run over one spin
    window: ``upd(partial, start, stop, sweep)`` then updates the window's
    columns of span [start, stop) in place (and adds to ``delta_e``).

    ``spins`` (rows, cols): the window, global columns [lo, lo + cols), in
    the carry's dtype (f32, bf16 or int8 for the kernel), rows contiguous;
    ``beta`` scalar or (rows,); ``h`` (n_pad,) f32 or None (the partial is
    the fields); ``scale``: the int8 coupling's () f32 scale, given exactly
    when the partials are int32; ``uniforms``: fed, (rows, n_cols) or
    (n_sweeps, rows, n_cols) f32 with unit column stride, column 0 at
    global column ``u_col0`` (the sweep's plane is read); else ``seed``, a
    (1,) int64 Philox seed; ``row0``: the global chain row of row 0;
    ``delta_e``: a (rows,) f32 accumulator or None.  On the CPU each call
    runs the plain version; on a CUDA window one ``ctypes`` call launches
    K4 on the stream that was current when the object was made, and
    anything the kernel does not take raises here or at the call.
    """

    def __init__(self, spins: torch.Tensor, lo: int, beta=1.0, *,
                 h: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
                 uniforms: Optional[torch.Tensor] = None,
                 seed: Optional[torch.Tensor] = None, u_col0: int = 0, row0: int = 0,
                 delta_e: Optional[torch.Tensor] = None):
        if spins.ndim != 2:
            raise ValueError(f"spins must be a (rows, cols) window, got {tuple(spins.shape)}")
        rows, cols = spins.shape
        if rows < 1 or cols < 1 or min(lo, u_col0, row0) < 0:
            raise ValueError(f"bad window: {rows} rows x {cols} columns at column {lo}, "
                             f"row {row0}")
        if (uniforms is None) == (seed is None):
            raise ValueError("give exactly one of uniforms (fed) and seed (Philox)")
        if uniforms is not None and (uniforms.ndim not in (2, 3) or uniforms.shape[-2] != rows):
            raise ValueError(f"uniforms must be ({rows}, n_cols) or (n_sweeps, {rows}, "
                             f"n_cols), got {tuple(uniforms.shape)}")
        if delta_e is not None and tuple(delta_e.shape) != (rows,):
            raise ValueError(f"delta_e must be ({rows},), got {tuple(delta_e.shape)}")
        dev = spins.device
        self.spins, self.lo, self.rows, self.cols = spins, lo, rows, cols
        self.h, self.scale, self.uniforms, self.seed = h, scale, uniforms, seed
        self.u_col0, self.row0, self.delta_e = u_col0, row0, delta_e
        self.beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
        if self.beta.ndim and self.beta.numel() != rows:
            raise ValueError(f"beta must be a scalar or have {rows} rows, got "
                             f"{tuple(self.beta.shape)}")
        self.mode = "K4f" if uniforms is not None else "K4"
        self.on_device = dev.type == "cuda"
        if dev.type == "cpu":
            return
        if not self.on_device:
            raise ValueError(f"no span-update kernel for device {dev}")
        self._prepare(dev)

    def _prepare(self, dev) -> None:
        """Check every tensor the kernel reads and fill ``SpanWindowArgs``."""
        spins, rows, cols = self.spins, self.rows, self.cols

        def on_dev(t, name, dtype):
            if t.device != dev or t.dtype != dtype:
                raise ValueError(f"{name} must be {dtype} on {dev}, got {t.dtype} on {t.device}")

        if spins.dtype not in _SPIN_TYPES or (spins.stride(1) != 1 and cols > 1):
            raise ValueError(f"spins must be f32, bf16 or int8 with unit column stride, got "
                             f"{spins.dtype} strides {spins.stride()}")
        self.beta = self.beta.reshape(-1).contiguous()
        args = _Args(beta=self.beta.data_ptr(), spins=spins.data_ptr(),
                     ld_s=spins.stride(0) if rows > 1 else cols,
                     beta_per_row=int(self.beta.numel() > 1), spin_type=_SPIN_TYPES[spins.dtype],
                     rows=rows, lo=self.lo, cols=cols, u_col0=self.u_col0, row0=self.row0,
                     device=dev.index if dev.index is not None else torch.cuda.current_device())
        if self.h is not None:
            on_dev(self.h, "h", torch.float32)
            if self.h.ndim != 1 or not self.h.is_contiguous():
                raise ValueError("h must be one contiguous (n_pad,) vector")
            args.h = self.h.data_ptr()
        if self.scale is not None:
            on_dev(self.scale, "scale", torch.float32)
            if self.scale.numel() != 1:
                raise ValueError("scale must be one value")
            args.scale = self.scale.data_ptr()
        if self.uniforms is not None:
            u = self.uniforms
            on_dev(u, "uniforms", torch.float32)
            if u.stride(-1) != 1 and u.shape[-1] > 1:
                raise ValueError("uniforms must have unit column stride")
            args.uniforms = u.data_ptr()
            args.ld_u = u.stride(-2) if rows > 1 else u.shape[-1]
            args.sweep_u = u.stride(0) if u.ndim == 3 else 0
        else:
            on_dev(self.seed, "seed", torch.int64)
            if self.seed.numel() != 1:
                raise ValueError("seed must be one int64")
            args.seed = self.seed.data_ptr()
        if self.delta_e is not None:
            on_dev(self.delta_e, "delta_e", torch.float32)
            if not self.delta_e.is_contiguous():
                raise ValueError("delta_e must be contiguous")
            args.delta_e = self.delta_e.data_ptr()
        args.stream = torch.cuda.current_stream(dev).cuda_stream
        self._lib = load_library().lib
        self._args = args
        self._args_ptr = ctypes.addressof(args)
        self._dev = dev

    def __call__(self, partial: Optional[torch.Tensor], start: int, stop: int,
                 sweep: int) -> None:
        """Update the window's columns of span [start, stop) in place from
        its all-reduced ``partial`` (rows, stop − start), or None where no
        shard couples into the span; raises where the window owns none of
        them."""
        a, b = _owned(self.lo, self.cols, start, stop)
        u = self.uniforms
        if u is not None and u.ndim == 3:
            if not 0 <= sweep < u.shape[0]:
                raise ValueError(f"sweep {sweep} outside the {u.shape[0]} fed sweeps")
            u = u[sweep]
        if not self.on_device:
            span_update_window_reference(partial, self.h, self.beta, self.spins, self.lo, start,
                                         stop, scale=self.scale, uniforms=u, seed=self.seed,
                                         u_col0=self.u_col0, row0=self.row0, sweep=sweep,
                                         delta_e=self.delta_e)
            return
        if u is not None and stop - self.u_col0 > u.shape[-1]:
            raise ValueError(f"the uniforms do not reach column {stop}")
        if self.h is not None and stop > self.h.shape[0]:
            raise ValueError(f"h does not reach column {stop}")
        if partial is None:
            kind, ptr, ld_p = 0, None, 0
        else:
            kind = _PARTIAL_KINDS.get(partial.dtype, -1)
            if (kind < 0 or partial.device != self._dev or partial.ndim != 2
                    or tuple(partial.shape) != (self.rows, stop - start)
                    or (partial.stride(1) != 1 and stop - start > 1)):
                raise ValueError(f"partial must be ({self.rows}, {stop - start}) f32 or int32 "
                                 f"with unit column stride on {self._dev}, got {partial.dtype} "
                                 f"{tuple(partial.shape)} on {partial.device}")
            if (kind == 2) != (self.scale is not None):
                raise ValueError("an int32 partial takes the coupling's scale, an f32 one none")
            ptr, ld_p = partial.data_ptr(), partial.stride(0) if self.rows > 1 else stop - start
        err = self._lib.span_window(self._args_ptr, ptr, kind, ld_p, start, a, b, sweep)
        if err != 0:
            msg = self._lib.span_update_error_string(err).decode()
            raise RuntimeError(f"span_window (K4) launch failed: {msg} ({err})")
        span_update.launches[self.mode] += 1


def span_update_window(partial: Optional[torch.Tensor], h: Optional[torch.Tensor], beta,
                       spins: torch.Tensor, lo: int, start: int, stop: int, *,
                       scale: Optional[torch.Tensor] = None,
                       uniforms: Optional[torch.Tensor] = None,
                       seed: Optional[torch.Tensor] = None, row0: int = 0, sweep: int = 0,
                       delta_e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One class span's owned-window update through K4 (the arguments of
    ``span_update_window_reference``; ``uniforms`` the sweep's (rows,
    n_cols) plane, read at global columns).  Updates ``spins`` (and
    ``delta_e``) in place and returns ``spins``.  CPU tensors run the
    plain version; CUDA ones launch the kernel, and anything it does not
    take raises."""
    SpanWindowUpdate(spins, lo, beta, h=h, scale=scale, uniforms=uniforms, seed=seed,
                     row0=row0, delta_e=delta_e)(partial, start, stop, sweep)
    return spins


def span_update(fields: torch.Tensor, beta=1.0, *,
                uniforms: Optional[torch.Tensor] = None,
                seed: Optional[torch.Tensor] = None, row0: int = 0, col0: int = 0,
                sweep: int = 0) -> torch.Tensor:
    """One class span's whole update through K4: new (rows, width) f32 ±1
    spins from ``fields`` (rows, width) f32, ``beta`` (scalar or
    (rows,)), and fed ``uniforms`` (rows, width) or a (1,) int64 Philox
    ``seed`` on the fields' device.  ``row0`` / ``col0``: the global chain
    row and padded column of element (0, 0); ``sweep``: the counter's
    sweep index.  The window kernel with the span as the window and a
    fresh f32 buffer as the spins.  A CPU ``fields`` runs the plain
    version; a CUDA one launches the kernel, and anything it does not take
    raises."""
    if fields.device.type == "cpu":
        return span_update_reference(fields, beta, uniforms=uniforms, seed=seed, row0=row0,
                                     col0=col0, sweep=sweep)
    if fields.device.type != "cuda":
        raise ValueError(f"no span-update kernel for device {fields.device}")
    if fields.ndim != 2 or fields.dtype != torch.float32 or not fields.is_contiguous():
        raise ValueError(f"fields must be a contiguous 2-D f32 tensor, got {fields.dtype} "
                         f"{tuple(fields.shape)}")
    rows, width = fields.shape
    if uniforms is not None and tuple(uniforms.shape) != (rows, width):
        raise ValueError(f"uniforms must be ({rows}, {width}), got {tuple(uniforms.shape)}")
    if min(row0, col0, sweep) < 0:
        raise ValueError(f"bad span: at ({row0}, {col0}), sweep {sweep}")
    out = torch.empty_like(fields)
    SpanWindowUpdate(out, col0, beta, uniforms=uniforms, seed=seed, u_col0=col0,
                     row0=row0)(fields, col0, col0 + width, sweep)
    return out


span_update.launches = collections.Counter()
