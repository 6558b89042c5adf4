"""Kernels K2 and K3: streaming colored block-Gibbs in CUDA C++ for Hopper.

Replaces ``image_generation_tpu/ops/gibbs_pallas_hbm.py``: ``_kernel``
(K2, the dense coupling streamed one color panel at a time) and
``_kernel_bs`` (K3, only the packed occupied chunk panels of
``ops/block_sparse.py``), with their wrapper ``gibbs_sweeps_pallas_hbm``.
The f32 modes are ``csrc/gibbs_hbm.cu``; its header note says what bounds
the kernels on the H100 and how the design meets that.
``ops/cuda_build.py`` builds it beside K1; it is bound here with
``ctypes``.  The int8 and bf16 modes (a ``QuantCoupling`` or dense bf16
matrix for K2, int8 or bf16 panels for K3) are the sparse field gather of
``ops/gibbs_sparse.py``, reached through the same wrapper.

``gibbs_sweeps_hbm_cuda`` is the wrapper.  It takes a dense f32 or bf16
coupling or a ``QuantCoupling`` (K2), or a ``BlockSparseCoupling`` with
f32, bf16 or int8 panels (K3), fed uniforms or the in-kernel Philox
stream (K1's counter and key), and the energy carry.  Like the Pallas
kernels it rounds the sweep count up to even, and an int8 coupling works
in quantized units (h / scale, β · scale), its ΔE rescaled.  For a tensor
on the CPU it runs the plain version (``gibbs_sweeps_hbm_reference``; for
int8 and bf16 the gather kernel's, ``gibbs_sweeps_sparse_reference``);
for a CUDA tensor it launches the kernel or raises.
``gibbs_sweeps_hbm_cuda.launches`` counts launches by kernel and mode,
e.g. ``"K3-bf16-dE"`` or ``"K2-int8"``.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import weakref
from typing import Optional

import torch

from image_generation_tpu_torch.ops.block_sparse import (
    BlockSparseCoupling,
    chunk_starts,
    color_chunk_rows,
    panel_offsets,
)
from image_generation_tpu_torch.ops.cuda_build import KernelLibrary, load_libraries
from image_generation_tpu_torch.ops.gibbs import GibbsPlan, is_quantized, sweeps_in_kernel_units
from image_generation_tpu_torch.ops.gibbs_cuda import _SMEM_LIMIT, _check, _max_width, draw_seed
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse

__all__ = [
    "gibbs_sweeps_hbm_cuda",
    "gibbs_sweeps_hbm_reference",
    "round_sweeps",
    "default_rows",
    "load_library",
]

_STATIC_SMEM = 8 * 8 * 4  # the energy carry's per-warp partial sums (R ≤ 8)
_ROWS = (8, 4, 2, 1)  # chain rows per thread block the source instantiates
_LANES, _GROUPS, _STEP = 128, 2, 8  # kLanes, kGroups, kStep in the source
_META_PER_COLOR = 6
# The default R keeps at least this many thread blocks in flight: 2,048
# chains take R = 8, a 256-chain serving request R = 1.
_MIN_GRID = 256

_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


def load_library() -> KernelLibrary:
    """Build (once per source hash, with the other kernels) and load the
    K2/K3 library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        built = load_libraries()["gibbs_hbm"]
        lib = built.lib
        lib.gibbs_stream.argtypes = [
            ctypes.c_int,  # packed: 0 K2, 1 K3
            ctypes.c_void_p,  # spins_in
            ctypes.c_void_p,  # spins_out
            ctypes.c_void_p,  # coupling (dense or panels)
            ctypes.c_void_p,  # h
            ctypes.c_void_p,  # beta
            ctypes.c_void_p,  # uniforms (null: Philox)
            ctypes.c_void_p,  # seed (null: fed)
            ctypes.c_void_p,  # delta_e (null: no energy carry)
            ctypes.c_void_p,  # device meta
            ctypes.c_int,  # n_meta
            ctypes.c_int,  # n_blocks
            ctypes.c_int,  # n_chains
            ctypes.c_int,  # n_pad
            ctypes.c_int,  # ld
            ctypes.c_int,  # seg_len
            ctypes.c_int,  # max_width
            ctypes.c_int,  # n_sweeps (even)
            ctypes.c_int,  # rows_per_block
            ctypes.c_void_p,  # stream
        ]
        lib.gibbs_stream.restype = ctypes.c_int
        lib.gibbs_stream_error_string.argtypes = [ctypes.c_int]
        lib.gibbs_stream_error_string.restype = ctypes.c_char_p
        lib.gibbs_stream_meta_per_color.argtypes = []
        lib.gibbs_stream_meta_per_color.restype = ctypes.c_int
        lib.gibbs_stream_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.gibbs_stream_smem_bytes.restype = ctypes.c_longlong
        if lib.gibbs_stream_meta_per_color() != _META_PER_COLOR:
            raise RuntimeError("kernel library and wrapper disagree on the meta layout")
        for r in _ROWS:
            if lib.gibbs_stream_smem_bytes(r, 289, 6016, 128) != _smem_bytes(r, 289, 6016, 128):
                raise RuntimeError("kernel library and wrapper disagree on shared memory")
        _library = built
        return _library


def round_sweeps(n_sweeps: int) -> int:
    """The sweeps K2 and K3 run: ``n_sweeps`` rounded up to even."""
    return 2 * (-(-int(n_sweeps) // 2))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(rows: int, n_meta: int, n_pad: int, max_width: int) -> int:
    """Dynamic shared memory of one thread block (``smem_bytes`` in the
    source): the groups' partial fields, the meta, the f32 spins, the
    stage."""
    return (_align16(4 * (_GROUPS - 1) * rows * _LANES) + _align16(4 * n_meta)
            + _align16(4 * rows * n_pad) + 4 * rows * max_width)


def _meta_list(plan: GibbsPlan, chunk: Optional[int]) -> list:
    """Per color (c0, c1, first panel row, column base, chunk-list begin,
    end), then the chunk list (the spin column each chunk starts at).
    Dense (``chunk`` None): the whole column panel as one chunk."""
    if chunk is None:
        meta = [x for c0, _v, c1 in plan.blocks for x in (c0, c1, 0, c0, 0, 1)]
        return meta + [0]
    rows = color_chunk_rows(plan, chunk)
    offs, _ = panel_offsets(plan, chunk)
    starts = chunk_starts(plan.n_pad, chunk)
    meta, chunks = [], []
    for (c0, _v, c1), rlist, off in zip(plan.blocks, rows, offs):
        meta += [c0, c1, off * chunk, 0, len(chunks), len(chunks) + len(rlist)]
        chunks += [starts[r] for r in rlist]
    return meta + chunks


_meta_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _device_meta(plan: GibbsPlan, chunk: Optional[int], device) -> torch.Tensor:
    per_plan = _meta_cache.setdefault(plan, {})
    key = (chunk, str(device))
    if key not in per_plan:
        per_plan[key] = torch.tensor(_meta_list(plan, chunk), dtype=torch.int32, device=device)
    return per_plan[key]


def default_rows(plan: GibbsPlan, n_chains: int, chunk: Optional[int] = None) -> int:
    """Chain rows per thread block of the f32 kernels: the largest R whose
    grid still holds ``_MIN_GRID`` blocks and whose spins fit shared
    memory (the smallest R that fits otherwise; 0 when none does)."""
    n_meta = len(_meta_list(plan, chunk))
    fits = [r for r in _ROWS if _smem_bytes(r, n_meta, plan.n_pad, _max_width(plan))
            + _STATIC_SMEM <= _SMEM_LIMIT]
    for r in fits:
        if -(-n_chains // r) >= _MIN_GRID:
            return r
    return fits[-1] if fits else 0


def _gathered_type(coupling_p) -> Optional[str]:
    """"int8" or "bf16" for a coupling the gather kernel takes, else None."""
    if is_quantized(coupling_p):
        return "int8"
    stored = coupling_p.panels if isinstance(coupling_p, BlockSparseCoupling) else coupling_p
    return "bf16" if stored.dtype == torch.bfloat16 else None


def _check_fed(uniforms: Optional[torch.Tensor], n_run: int, chains: int, n_pad: int) -> None:
    if uniforms is not None and (uniforms.shape[0] < n_run
                                 or tuple(uniforms.shape[1:]) != (chains, n_pad)):
        raise ValueError(f"uniforms must be (>= {n_run}, {chains}, {n_pad}), "
                         f"got {tuple(uniforms.shape)}")


def gibbs_sweeps_hbm_reference(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
):
    """The dense plain PyTorch version of K2 and K3, with the Pallas
    kernels' semantics: per block of ``plan.blocks`` in order,
    ``round_sweeps`` sweeps, and for an int8 coupling the quantized units
    (fields = exact integer products + h / scale, β · scale, ΔE × scale at
    the end).  It is the f32 kernels' twin; the int8 and bf16 modes' is
    the gather's (``gibbs_sparse.gibbs_sweeps_sparse_reference``), which
    sums the fields in another order than this one for bf16.

    Same arguments as ``ops.gibbs.gibbs_sweeps_reference``; ``uniforms``
    needs at least ``round_sweeps(n_sweeps)`` rows of (chains, n_pad) and
    ΔE covers the sweeps run."""
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    n_run = round_sweeps(n_sweeps)
    _check_fed(uniforms, n_run, chains, n_pad)
    return sweeps_in_kernel_units(hp, coupling_p, plan, spins_p, n_run, beta, generator,
                                  uniforms, track_delta_e)


def gibbs_sweeps_hbm_cuda(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
    _rows_per_block: Optional[int] = None,
):
    """``round_sweeps(n_sweeps)`` colored block-Gibbs sweeps through K2 (a
    dense f32 / bf16 coupling or a ``QuantCoupling``) or K3 (a
    ``BlockSparseCoupling``).

    ``hp`` (n_pad,) f32, ``spins_p`` (chains, n_pad) f32, ``beta`` scalar
    or (chains,); optional fed ``uniforms`` (>= round_sweeps(n_sweeps),
    chains, n_pad) f32, else the kernel draws from its Philox stream keyed
    by a seed drawn from ``generator``.  Returns new f32 spins, or (spins,
    delta_e) with ``track_delta_e``.  An int8 or bf16 coupling goes to the
    gather kernel (``gibbs_sparse.gibbs_sweeps_sparse``), which reads it
    only at the plan's edges: it must be zero everywhere else, as every
    coupling ``permuted_model`` builds (and ``pack_coupling`` packs) is.
    A CPU ``spins_p`` runs the plain version; a CUDA one launches the
    kernel, and anything it does not take raises.  ``_rows_per_block``
    overrides the chain rows per thread block (``default_rows``) of the
    f32 kernels for measuring them at each R.
    """
    gathered = _gathered_type(coupling_p)
    if gathered is not None:
        n_run = round_sweeps(n_sweeps)
        _check_fed(uniforms, n_run, *spins_p.shape)
        kernel = "K3" if isinstance(coupling_p, BlockSparseCoupling) else "K2"
        return gibbs_sweeps_sparse(
            hp, coupling_p, plan, spins_p, n_run, beta, generator=generator,
            uniforms=uniforms, track_delta_e=track_delta_e,
            count=(gibbs_sweeps_hbm_cuda.launches,
                   f"{kernel}-{gathered}" + ("-dE" if track_delta_e else "")))
    if spins_p.device.type == "cpu":
        return gibbs_sweeps_hbm_reference(
            hp, coupling_p, plan, spins_p, n_sweeps, beta,
            generator=generator, uniforms=uniforms, track_delta_e=track_delta_e,
        )
    if spins_p.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {spins_p.device}")
    dev = spins_p.device
    n_chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    max_w = _max_width(plan)
    if isinstance(coupling_p, BlockSparseCoupling):
        if coupling_p.plan is not plan:
            raise ValueError("the packed coupling was cut for another plan")
        chunk, mat = coupling_p.chunk, coupling_p.panels
        _, total = panel_offsets(plan, chunk)
        shape, ld, seg_len, kernel = (total * chunk, max_w), max_w, chunk, "K3"
    else:
        chunk, mat = None, coupling_p
        shape, ld, seg_len, kernel = (n_pad, n_pad), n_pad, n_pad, "K2"
    if mat.dtype != torch.float32:
        raise TypeError(f"no streaming kernel for a {mat.dtype} coupling "
                        f"(f32, bf16, or int8 with its scale)")
    if n_pad % _STEP or seg_len % _STEP:
        raise ValueError(f"n_pad ({n_pad}) and the chunk ({seg_len}) must be "
                         f"multiples of {_STEP}")
    _check("spins_p", spins_p, (n_chains, n_pad), dev)
    _check("coupling", mat, shape, dev, mat.dtype)
    _check("hp", hp, (n_pad,), dev)
    n_run = round_sweeps(n_sweeps)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if beta_t.ndim == 0:
        beta_t = beta_t.expand(n_chains)
    beta_t = beta_t.contiguous()
    _check("beta", beta_t, (n_chains,), dev)
    if uniforms is not None:
        if uniforms.shape[0] < n_run:
            raise ValueError(f"uniforms need {n_run} sweeps (the even count), "
                             f"got {uniforms.shape[0]}")
        _check("uniforms", uniforms, (uniforms.shape[0], n_chains, n_pad), dev)
        seed = None
    else:
        seed = draw_seed(generator, dev)
    meta = _device_meta(plan, chunk, dev)
    rows = _rows_per_block or default_rows(plan, n_chains, chunk)
    if rows not in _ROWS or (_smem_bytes(rows, meta.numel(), n_pad, max_w)
                             + _STATIC_SMEM > _SMEM_LIMIT):
        raise ValueError(f"{rows} chain rows of n_pad={n_pad} do not fit one thread "
                         f"block's shared memory")
    out = torch.empty_like(spins_p)
    delta_e = torch.empty(n_chains, dtype=torch.float32, device=dev) if track_delta_e else None
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gibbs_stream(
            int(chunk is not None), spins_p.data_ptr(), out.data_ptr(),
            mat.data_ptr(), hp.data_ptr(), beta_t.data_ptr(),
            uniforms.data_ptr() if uniforms is not None else None,
            seed.data_ptr() if seed is not None else None,
            delta_e.data_ptr() if delta_e is not None else None,
            meta.data_ptr(), meta.numel(), len(plan.blocks), n_chains, n_pad, ld,
            seg_len, max_w, n_run, rows, stream,
        )
    if err != 0:
        msg = lib.gibbs_stream_error_string(err).decode()
        raise RuntimeError(f"gibbs_stream ({kernel}, f32) launch failed: {msg} ({err})")
    gibbs_sweeps_hbm_cuda.launches[f"{kernel}-f32" + ("-dE" if track_delta_e else "")] += 1
    if track_delta_e:
        return out, delta_e
    return out


gibbs_sweeps_hbm_cuda.launches = collections.Counter()
