"""Kernel K1: fused multi-sweep colored block-Gibbs on Hopper, in every
coupling type.

Replaces ``image_generation_tpu/ops/gibbs_pallas.py`` (``_kernel``,
``_kernel_fed``, ``_color_update``; wrapper ``gibbs_sweeps_pallas``, gate
``supported_by_pallas``) with an f32 or bf16 coupling or a
``QuantCoupling``.  Every mode is the sparse field gather of
``ops/gibbs_sparse.py`` (CUDA C++ in ``csrc/gibbs_sparse.cu``, whose
header note says what bounds it on the H100 and how the design meets
that), fed the dense coupling with dense offsets: it reads the coupling
only at the plan's edges, so the coupling must be zero everywhere else,
as every coupling ``permuted_model`` builds is.

``selects_k1`` keeps the JAX package's VMEM gate as the dispatch rule
between K1 and the streaming route (``ops/gibbs_hbm_cuda.py``), so each
call reaches the counterpart of the kernel the JAX package picks.

``gibbs_sweeps_cuda`` is the wrapper.  It takes a dense f32 or bf16
coupling or a ``QuantCoupling``; an int8 coupling works in the Pallas
wrapper's quantized units (h / scale and β · scale go in, computed on the
device, and ΔE comes back × scale).  With ``track_delta_e`` it also
returns each chain's energy change of the run (the Pallas kernels'
``de_ref``), which parallel tempering uses to carry its ladder energies
across rounds.  For a tensor on the CPU it runs the gather's plain
version (``gibbs_sparse.gibbs_sweeps_sparse_reference``: fields summed in
the table's slot order, in f32 for f32 and bf16, in int32 for int8); for
a CUDA tensor it launches the kernel or raises.
``gibbs_sweeps_cuda.launches`` counts its launches by mode: ``"K1-f32"``,
``"K1-f32-dE"``, ``"K1-bf16"``, ``"K1-bf16-dE"``, ``"K1-int8"``,
``"K1-int8-dE"``.

``philox_uniforms`` is the numpy twin of the kernels' in-kernel generator:
fed to the plain version, it reproduces the kernel's Philox mode.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.ops.gibbs import GibbsPlan, _check_uniforms
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse, supported
from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "gibbs_sweeps_cuda",
    "supported_by_kernel",
    "selects_k1",
    "draw_seed",
    "philox_uniforms",
]

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# The JAX package's VMEM budget, kept only as the dispatch rule (selects_k1)
_VMEM_BUDGET = 12 * 1024 * 1024
# the coupling's stored type -> K1's mode name
_MODES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def supported_by_kernel(plan: GibbsPlan, n_chains: int, dtype=torch.float32) -> bool:
    """Whether K1 takes this problem with a coupling stored as ``dtype``
    (f32, bf16 or int8): the gather kernel's rule, ``gibbs_sparse.supported``
    (one chain's spins fit shared memory, a table word holds a spin
    position)."""
    return supported(plan, n_chains, dtype)


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
    _shape: Optional[tuple] = None,
):
    """``n_sweeps`` colored block-Gibbs sweeps through K1.

    Same contract as ``gibbs_sweeps_kernel_reference``: ``hp`` (n_pad,)
    and ``spins_p`` (chains, n_pad) f32; ``coupling_p`` (n_pad, n_pad) f32
    or bf16, or a ``QuantCoupling``, zero off the plan's edges; ``beta``
    scalar or (chains,); optional fed ``uniforms`` (n_sweeps, chains,
    n_pad).  Without them the kernel draws from its Philox stream, keyed
    by a seed drawn from ``generator``.  Returns new f32 spins, or (spins,
    delta_e) with ``track_delta_e``: the (chains,) f32 energy change of
    the run.

    A CPU ``spins_p`` runs the gather's plain version.  A CUDA one
    launches the gather kernel; anything it does not take raises.
    ``_shape`` overrides its launch shape (chains per block, threads) for
    measuring it at each shape.
    """
    _check_uniforms(uniforms, n_sweeps, *spins_p.shape)
    if isinstance(coupling_p, QuantCoupling):
        mode = "int8"
    elif isinstance(coupling_p, torch.Tensor) and coupling_p.dtype in _MODES:
        mode = _MODES[coupling_p.dtype]
    else:
        what = (f"a {coupling_p.dtype} tensor" if isinstance(coupling_p, torch.Tensor)
                else type(coupling_p).__name__)
        raise TypeError(f"K1 takes an f32 or bf16 coupling or a QuantCoupling, got {what}")
    return gibbs_sweeps_sparse(
        hp, coupling_p, plan, spins_p, n_sweeps, beta, generator=generator,
        uniforms=uniforms, track_delta_e=track_delta_e, _shape=_shape,
        count=(gibbs_sweeps_cuda.launches, f"K1-{mode}" + ("-dE" if track_delta_e else "")))


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
