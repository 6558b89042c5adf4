"""Kernel K1: fused multi-sweep colored block-Gibbs in CUDA C++ for Hopper.

Replaces ``image_generation_tpu/ops/gibbs_pallas.py`` (``_kernel``,
``_kernel_fed``, ``_color_update``; wrapper ``gibbs_sweeps_pallas``, gate
``supported_by_pallas``) with an f32 or bf16 coupling.  The kernel source
is ``csrc/gibbs_sweeps.cu``; its header note says what bounds it on the
H100 and how the design meets that.  ``ops/cuda_build.py`` compiles it
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, and it is bound here with ``ctypes``.  K1's int8
mode (a ``QuantCoupling``) is the sparse field gather of
``ops/gibbs_sparse.py``, reached through the same wrapper.

``selects_k1`` keeps the JAX package's VMEM gate as the dispatch rule
between K1 and the streaming kernels (``ops/gibbs_hbm_cuda.py``).

The kernel also carries the energy change of the run (``track_delta_e``,
the Pallas kernels' ``de_ref``), which parallel tempering uses to carry its
ladder energies across rounds.

``gibbs_sweeps_cuda`` is the wrapper.  It takes a dense f32 or bf16
coupling or a ``QuantCoupling``; an int8 coupling works in the Pallas
wrapper's quantized units (h / scale and β · scale go in, computed on the
device, and ΔE comes back × scale).  For a tensor on the CPU it runs the
plain PyTorch version (``ops.gibbs.gibbs_sweeps_kernel_reference``; for
int8 the gather kernel's, ``gibbs_sweeps_sparse_reference``); for a
CUDA tensor it launches the kernel or raises.
``gibbs_sweeps_cuda.launches`` counts its launches by mode: ``"K1-f32"``,
``"K1-bf16-dE"``, ``"K1-int8"``, ...

``philox_uniforms`` is the numpy twin of the kernels' in-kernel generator:
fed to the plain version, it reproduces the kernel's Philox mode.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.ops.cuda_build import KernelLibrary, load_libraries
from image_generation_tpu_torch.ops.gibbs import (
    GibbsPlan,
    _check_uniforms,
    gibbs_sweeps_kernel_reference,
)
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse, supported
from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "gibbs_sweeps_cuda",
    "supported_by_kernel",
    "selects_k1",
    "default_rows",
    "load_library",
    "draw_seed",
    "philox_uniforms",
]

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_STATIC_SMEM = 8 * 4 * 4  # the energy carry's per-warp partial sums (R ≤ 8)
_MAX_BLOCKS = 128  # color blocks a launch takes (kMaxBlocks in the source)
_STEP = 8  # coupling rows per step (kStep in csrc/gibbs_common.cuh)
_ROWS = (8, 4, 2, 1)  # chain rows per thread block the source instantiates
# coupling dtype -> (code of the C entry, mode name, itemsize of the held spins)
_DTYPES = {torch.float32: (0, "f32", 4), torch.bfloat16: (1, "bf16", 2)}
# The default R keeps at least this many thread blocks in flight.  On an
# H100 SXM (700 W), 80 sweeps of the 640-spin checkpoint plan ran fastest
# at R=1 for 256 chains (256 blocks) and at R=8 for 4096 chains (512
# blocks); fewer, fatter blocks leave SMs idle, more re-read the coupling
# from L2 (PERF.md).  Serving (256·k chains, k <= 16) selects every R.
_MIN_GRID = 512
# The JAX package's VMEM budget, kept only as the dispatch rule (selects_k1)
_VMEM_BUDGET = 12 * 1024 * 1024

_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


def load_library() -> KernelLibrary:
    """Build (once per source hash, with the other kernels) and load K1's
    library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        built = load_libraries()["gibbs_sweeps"]
        lib = built.lib
        lib.gibbs_sweeps.argtypes = [
            ctypes.c_int,  # dtype: 0 f32, 1 bf16
            ctypes.c_void_p,  # spins_in
            ctypes.c_void_p,  # spins_out
            ctypes.c_void_p,  # coupling
            ctypes.c_void_p,  # h
            ctypes.c_void_p,  # beta
            ctypes.c_void_p,  # uniforms (null: Philox)
            ctypes.c_void_p,  # seed (null: fed)
            ctypes.c_void_p,  # delta_e (null: no energy carry)
            ctypes.c_void_p,  # host block bounds
            ctypes.c_int,  # n_blocks
            ctypes.c_int,  # n_chains
            ctypes.c_int,  # n_pad
            ctypes.c_int,  # max_width
            ctypes.c_int,  # n_sweeps
            ctypes.c_int,  # rows_per_block
            ctypes.c_void_p,  # stream
        ]
        lib.gibbs_sweeps.restype = ctypes.c_int
        lib.gibbs_sweeps_error_string.argtypes = [ctypes.c_int]
        lib.gibbs_sweeps_error_string.restype = ctypes.c_char_p
        lib.gibbs_sweeps_max_blocks.argtypes = []
        lib.gibbs_sweeps_max_blocks.restype = ctypes.c_int
        lib.gibbs_sweeps_step.argtypes = []
        lib.gibbs_sweeps_step.restype = ctypes.c_int
        lib.gibbs_sweeps_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.gibbs_sweeps_smem_bytes.restype = ctypes.c_longlong
        if lib.gibbs_sweeps_max_blocks() != _MAX_BLOCKS or lib.gibbs_sweeps_step() != _STEP:
            raise RuntimeError("kernel library and wrapper disagree on kMaxBlocks or kStep")
        for code, _name, size in _DTYPES.values():
            for r in _ROWS:
                if lib.gibbs_sweeps_smem_bytes(code, r, 2432, 512) != _dynamic_smem(
                        size, r, 2432, 512):
                    raise RuntimeError("kernel library and wrapper disagree on shared memory")
        _library = built
        return _library


def selects_k1(plan: GibbsPlan, n_chains: int, coupling_itemsize: int = 4) -> bool:
    """Whether the JAX package sends this problem to its on-chip kernel
    (``gibbs_pallas.py`` ``supported_by_pallas``), whose counterpart is K1:
    the coupling in its resident dtype plus a chain block's spins and
    fields within the TPU's 12 MB VMEM budget.  Kept as the dispatch rule
    only: K2 and K3 round the sweep count up to even and K1 does not, so
    a call has to reach the counterpart of the kernel the JAX package
    picks.  ``n_chains`` is the effective chain count of one call."""
    if plan.n_pad % 128 != 0:
        return False
    block = min(n_chains, 256)  # the Pallas wrapper's default chain block
    while n_chains % block:
        block -= 1
    coupling_bytes = plan.n_pad * plan.n_pad * coupling_itemsize
    spins_bytes = 2 * block * plan.n_pad * 4
    fields_bytes = block * _max_width(plan) * 4
    return coupling_bytes + spins_bytes + 3 * fields_bytes < _VMEM_BUDGET


def _max_width(plan: GibbsPlan) -> int:
    return max(c1 - c0 for c0, _v, c1 in plan.blocks)


def _dynamic_smem(itemsize: int, rows: int, n_pad: int, max_width: int) -> int:
    """``smem_bytes`` in the source: R rows of spins plus R rows of one
    color's staged spins, in the coupling's type."""
    return rows * (n_pad + max_width) * itemsize


def _smem_bytes(plan: GibbsPlan, rows: int, dtype=torch.float32) -> int:
    return _dynamic_smem(_DTYPES[dtype][2], rows, plan.n_pad, _max_width(plan)) + _STATIC_SMEM


def default_rows(plan: GibbsPlan, n_chains: int, dtype=torch.float32) -> int:
    """Chain rows per thread block: the largest R whose grid still holds
    ``_MIN_GRID`` blocks and whose spins, held in the coupling's
    ``dtype``, fit shared memory (1 otherwise)."""
    for r in _ROWS:
        if -(-n_chains // r) >= _MIN_GRID and _smem_bytes(plan, r, dtype) <= _SMEM_LIMIT:
            return r
    return 1


def supported_by_kernel(plan: GibbsPlan, n_chains: int, dtype=torch.float32) -> bool:
    """Whether K1 takes this problem.  f32 / bf16: the chain rows of one
    thread block plus one color block of staging, in the coupling's
    ``dtype``, fit Hopper's 227 KB of shared memory, the padded width is a
    multiple of 8 (the kernel's step), and the plan has at most
    ``_MAX_BLOCKS`` color blocks.  int8: the gather kernel's rule
    (``gibbs_sparse.supported``)."""
    if dtype == torch.int8:
        return supported(plan, n_chains)
    return _fits(plan, n_chains, default_rows(plan, n_chains, dtype), dtype)


def _fits(plan: GibbsPlan, n_chains: int, rows: int, dtype=torch.float32) -> bool:
    return (
        n_chains >= 1
        and rows in _ROWS
        and plan.n_pad % _STEP == 0
        and 1 <= len(plan.blocks) <= _MAX_BLOCKS
        and _smem_bytes(plan, rows, dtype) <= _SMEM_LIMIT
    )


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The kernel's 64-bit Philox key as a (1,) int64 tensor on ``device``,
    drawn from ``generator`` (torch's default generator when None)."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    seed = torch.randint(
        0, 2**62, (1,), generator=generator, device=gdev, dtype=torch.int64
    )
    return seed.to(device)


def _check(name: str, t: torch.Tensor, shape: tuple, device, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel's pointer arguments need)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the spins on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gibbs_sweeps_cuda(
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
    """``n_sweeps`` colored block-Gibbs sweeps through K1.

    Same contract as ``gibbs_sweeps_kernel_reference``: ``hp`` (n_pad,)
    and ``spins_p`` (chains, n_pad) f32; ``coupling_p`` (n_pad, n_pad) f32
    or bf16, or a ``QuantCoupling``; ``beta`` scalar or (chains,);
    optional fed ``uniforms`` (n_sweeps, chains, n_pad).  Without them the
    kernel draws from its Philox stream, keyed by a seed drawn from
    ``generator``.  Returns new f32 spins, or (spins, delta_e) with
    ``track_delta_e``: the (chains,) f32 energy change of the run.

    A ``QuantCoupling`` goes to the int8 gather kernel
    (``gibbs_sparse.gibbs_sweeps_sparse``), which reads the
    coupling only at the plan's edges: it must be zero everywhere else, as
    every coupling ``permuted_model`` builds is.

    A CPU ``spins_p`` runs the plain version.  A CUDA one launches the
    kernel; anything it does not take raises.  ``_rows_per_block``
    overrides the chain rows per thread block (``default_rows``) of the
    f32 / bf16 kernel for measuring it at each R.
    """
    if isinstance(coupling_p, QuantCoupling):
        _check_uniforms(uniforms, n_sweeps, *spins_p.shape)
        return gibbs_sweeps_sparse(
            hp, coupling_p, plan, spins_p, n_sweeps, beta, generator=generator,
            uniforms=uniforms, track_delta_e=track_delta_e,
            count=(gibbs_sweeps_cuda.launches, "K1-int8" + ("-dE" if track_delta_e else "")))
    if spins_p.device.type == "cpu":
        return gibbs_sweeps_kernel_reference(
            hp, coupling_p, plan, spins_p, n_sweeps, beta,
            generator=generator, uniforms=uniforms, track_delta_e=track_delta_e,
        )
    if spins_p.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {spins_p.device}")
    dev = spins_p.device
    n_chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    if coupling_p.dtype not in _DTYPES:
        raise TypeError(f"K1 takes an f32 or bf16 coupling or a QuantCoupling, "
                        f"got a {coupling_p.dtype} {type(coupling_p).__name__}")
    code, dname, _size = _DTYPES[coupling_p.dtype]
    _check("spins_p", spins_p, (n_chains, n_pad), dev)
    _check("coupling_p", coupling_p, (n_pad, n_pad), dev, coupling_p.dtype)
    _check("hp", hp, (n_pad,), dev)
    rows = _rows_per_block or default_rows(plan, n_chains, coupling_p.dtype)
    if not _fits(plan, n_chains, rows, coupling_p.dtype):
        raise ValueError(
            f"plan (n_pad={n_pad}, {len(plan.blocks)} blocks) at {n_chains} "
            f"chains does not fit K1's shared memory; the streaming kernels "
            f"(ops/gibbs_hbm_cuda.py) take it"
        )
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if beta_t.ndim == 0:
        beta_t = beta_t.expand(n_chains)
    beta_t = beta_t.contiguous()
    _check("beta", beta_t, (n_chains,), dev)
    if uniforms is not None:
        _check("uniforms", uniforms, (n_sweeps, n_chains, n_pad), dev)
        seed = None
    else:
        seed = draw_seed(generator, dev)
    out = torch.empty_like(spins_p)
    delta_e = torch.empty(n_chains, dtype=torch.float32, device=dev) if track_delta_e else None
    flat = [c for c0, _v, c1 in plan.blocks for c in (c0, c1)]
    bounds = (ctypes.c_int * len(flat))(*flat)
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gibbs_sweeps(
            code, spins_p.data_ptr(), out.data_ptr(), coupling_p.data_ptr(),
            hp.data_ptr(), beta_t.data_ptr(),
            uniforms.data_ptr() if uniforms is not None else None,
            seed.data_ptr() if seed is not None else None,
            delta_e.data_ptr() if delta_e is not None else None,
            ctypes.cast(bounds, ctypes.c_void_p), len(plan.blocks), n_chains,
            n_pad, _max_width(plan), int(n_sweeps), rows, stream,
        )
    if err != 0:
        msg = lib.gibbs_sweeps_error_string(err).decode()
        raise RuntimeError(f"gibbs_sweeps (K1, {dname}) launch failed: {msg} ({err})")
    gibbs_sweeps_cuda.launches[f"K1-{dname}" + ("-dE" if track_delta_e else "")] += 1
    return (out, delta_e) if track_delta_e else out


gibbs_sweeps_cuda.launches = collections.Counter()


# ---------------------------------------------------------------------------
# numpy twin of the in-kernel generator
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """First word of Philox4x32-10 over uint64 arrays holding 32-bit
    values (a 32×32-bit product never overflows uint64)."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in (c0, c1, c2, c3))
    k0, k1 = np.uint64(k0), np.uint64(k1)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & _M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & _M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + np.uint64(0x9E3779B9)) & _M32
        k1 = (k1 + np.uint64(0xBB67AE85)) & _M32
    return c0


def philox_uniforms(seed: int, n_sweeps: int, n_chains: int, n_pad: int) -> np.ndarray:
    """The (n_sweeps, n_chains, n_pad) f32 uniforms K1 draws in Philox mode
    for ``seed``: counter (column, chain row, sweep, 0), key (low, high
    32 bits of the seed), u = (bits >> 8)·2⁻²⁴."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    sweep, row, col = np.meshgrid(
        np.arange(n_sweeps, dtype=np.uint64),
        np.arange(n_chains, dtype=np.uint64),
        np.arange(n_pad, dtype=np.uint64),
        indexing="ij",
    )
    bits = _philox4x32_10(col, row, sweep, np.zeros_like(col),
                          seed & 0xFFFFFFFF, seed >> 32)
    return (bits >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24)
