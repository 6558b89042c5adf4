"""Kernel K1: fused multi-sweep colored block-Gibbs in CUDA C++ for Hopper.

Replaces ``image_generation_tpu/ops/gibbs_pallas.py`` (``_kernel``,
``_kernel_fed``, ``_color_update``; wrapper ``gibbs_sweeps_pallas``, gate
``supported_by_pallas``).  The kernel source is ``csrc/gibbs_sweeps.cu``;
its header note says what bounds it on the H100 and how the design meets
that.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, keyed on a hash of the source and
the flags, under ``_build/`` in this package, and bound with ``ctypes``.

``gibbs_sweeps_cuda`` is the wrapper.  For a tensor on the CPU it runs the
plain PyTorch version, ``ops.gibbs.gibbs_sweeps_reference``; for a CUDA
tensor it launches the kernel or raises.  ``gibbs_sweeps_cuda.launches``
counts kernel launches.

``philox_uniforms`` is the numpy twin of the kernel's in-kernel generator:
fed to the plain version, it reproduces the kernel's Philox mode.
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
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.ops.gibbs import GibbsPlan, gibbs_sweeps_reference

__all__ = [
    "gibbs_sweeps_cuda",
    "supported_by_kernel",
    "load_library",
    "draw_seed",
    "philox_uniforms",
]

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "gibbs_sweeps.cu"
_BUILD_DIR = _PKG / "_build"
# no --use_fast_math: expf stays within an ulp of torch.sigmoid's exp
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_MAX_BLOCKS = 128  # color blocks a launch takes (kMaxBlocks in the source)
_ROWS = (8, 4, 2, 1)  # chain rows per thread block the source instantiates
# The default R keeps at least this many thread blocks in flight.  On an
# H100 SXM (700 W), 80 sweeps of the 640-spin checkpoint plan ran fastest
# at R=1 for 256 chains (256 blocks) and at R=8 for 4096 chains (512
# blocks); fewer, fatter blocks leave SMs idle, more re-read the coupling
# from L2 (PERF.md).  Serving (256·k chains, k <= 16) selects every R.
_MIN_GRID = 512


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str  # nvcc/ptxas output of the build ("" when not rebuilt)


_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


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
        "/usr/local/cuda/bin): the Gibbs sweep kernel cannot be built"
    )


def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        digest = hashlib.sha256(
            _SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = _BUILD_DIR / f"gibbs_sweeps_{digest}.so"
        seconds, log = 0.0, ""
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = _BUILD_DIR / f".gibbs_sweeps_{digest}.{os.getpid()}.so"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
        lib = ctypes.CDLL(str(so))
        lib.gibbs_sweeps_f32.argtypes = [
            ctypes.c_void_p,  # spins_in
            ctypes.c_void_p,  # spins_out
            ctypes.c_void_p,  # coupling
            ctypes.c_void_p,  # h
            ctypes.c_void_p,  # beta
            ctypes.c_void_p,  # uniforms (null: Philox)
            ctypes.c_void_p,  # seed (null: fed)
            ctypes.c_void_p,  # host block bounds
            ctypes.c_int,  # n_blocks
            ctypes.c_int,  # n_chains
            ctypes.c_int,  # n_pad
            ctypes.c_int,  # max_width
            ctypes.c_int,  # n_sweeps
            ctypes.c_int,  # rows_per_block
            ctypes.c_void_p,  # stream
        ]
        lib.gibbs_sweeps_f32.restype = ctypes.c_int
        lib.gibbs_sweeps_error_string.argtypes = [ctypes.c_int]
        lib.gibbs_sweeps_error_string.restype = ctypes.c_char_p
        lib.gibbs_sweeps_max_blocks.argtypes = []
        lib.gibbs_sweeps_max_blocks.restype = ctypes.c_int
        if lib.gibbs_sweeps_max_blocks() != _MAX_BLOCKS:
            raise RuntimeError("kernel library and wrapper disagree on kMaxBlocks")
        _library = KernelLibrary(lib, so, seconds, log)
        return _library


def _max_width(plan: GibbsPlan) -> int:
    return max(c1 - c0 for c0, _v, c1 in plan.blocks)


def _smem_bytes(plan: GibbsPlan, rows: int) -> int:
    return rows * (plan.n_pad + _max_width(plan)) * 4


def default_rows(plan: GibbsPlan, n_chains: int) -> int:
    """Chain rows per thread block: the largest R whose grid still holds
    ``_MIN_GRID`` blocks and whose spins fit shared memory (1 otherwise)."""
    for r in _ROWS:
        if -(-n_chains // r) >= _MIN_GRID and _smem_bytes(plan, r) <= _SMEM_LIMIT:
            return r
    return 1


def supported_by_kernel(plan: GibbsPlan, n_chains: int) -> bool:
    """Whether K1 takes this problem: the chain rows of one thread block
    plus one color block of staging fit Hopper's 227 KB of shared memory,
    the padded width is a multiple of 4 (float4 spin reads), and the plan
    has at most ``_MAX_BLOCKS`` color blocks.  Larger graphs need the
    streaming kernel (K2), which is not ported."""
    return _fits(plan, n_chains, default_rows(plan, n_chains))


def _fits(plan: GibbsPlan, n_chains: int, rows: int) -> bool:
    return (
        n_chains >= 1
        and rows in _ROWS
        and plan.n_pad % 4 == 0
        and 1 <= len(plan.blocks) <= _MAX_BLOCKS
        and _smem_bytes(plan, rows) <= _SMEM_LIMIT
    )


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The kernel's 64-bit Philox key as a (1,) int64 tensor on ``device``,
    drawn from ``generator`` (torch's default generator when None)."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    seed = torch.randint(
        0, 2**62, (1,), generator=generator, device=gdev, dtype=torch.int64
    )
    return seed.to(device)


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the spins on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 (bf16/int8 coupling modes "
                        f"are not ported), got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gibbs_sweeps_cuda(
    hp: torch.Tensor,
    coupling_p: torch.Tensor,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
    _rows_per_block: Optional[int] = None,
) -> torch.Tensor:
    """``n_sweeps`` colored block-Gibbs sweeps through K1.

    Same contract as ``gibbs_sweeps_reference``: ``hp`` (n_pad,),
    ``coupling_p`` (n_pad, n_pad), ``spins_p`` (chains, n_pad), all f32;
    ``beta`` scalar or (chains,); optional fed ``uniforms`` (n_sweeps,
    chains, n_pad).  Without them the kernel draws from its Philox stream,
    keyed by a seed drawn from ``generator``.  Returns new spins.

    A CPU ``spins_p`` runs the plain version.  A CUDA one launches the
    kernel; anything it does not take raises.  ``_rows_per_block``
    overrides the chain rows per thread block (``default_rows``) for
    measuring the kernel at each R.
    """
    if track_delta_e:
        raise NotImplementedError(
            "track_delta_e (the parallel-tempering energy carry) is not "
            "ported to the sweep kernel"
        )
    if spins_p.device.type == "cpu":
        return gibbs_sweeps_reference(
            hp, coupling_p, plan, spins_p, n_sweeps, beta,
            generator=generator, uniforms=uniforms,
        )
    if spins_p.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {spins_p.device}")
    dev = spins_p.device
    n_chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    _check("spins_p", spins_p, (n_chains, n_pad), dev)
    _check("coupling_p", coupling_p, (n_pad, n_pad), dev)
    _check("hp", hp, (n_pad,), dev)
    rows = _rows_per_block or default_rows(plan, n_chains)
    if not _fits(plan, n_chains, rows):
        raise NotImplementedError(
            f"plan (n_pad={n_pad}, {len(plan.blocks)} blocks) at {n_chains} "
            f"chains does not fit the on-chip sweep kernel; the streaming "
            f"kernel (K2, gibbs_pallas_hbm) is not ported"
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
    flat = [c for c0, _v, c1 in plan.blocks for c in (c0, c1)]
    bounds = (ctypes.c_int * len(flat))(*flat)
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gibbs_sweeps_f32(
            spins_p.data_ptr(), out.data_ptr(), coupling_p.data_ptr(),
            hp.data_ptr(), beta_t.data_ptr(),
            uniforms.data_ptr() if uniforms is not None else None,
            seed.data_ptr() if seed is not None else None,
            ctypes.cast(bounds, ctypes.c_void_p), len(plan.blocks), n_chains,
            n_pad, _max_width(plan), int(n_sweeps), rows, stream,
        )
    if err != 0:
        msg = lib.gibbs_sweeps_error_string(err).decode()
        raise RuntimeError(f"gibbs_sweeps_f32 launch failed: {msg} ({err})")
    gibbs_sweeps_cuda.launches += 1
    return out


gibbs_sweeps_cuda.launches = 0


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
