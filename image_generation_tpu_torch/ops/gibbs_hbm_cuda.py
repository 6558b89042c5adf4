"""Kernels K2 and K3: streaming colored block-Gibbs on the sparse field gather.

Replaces ``image_generation_tpu/ops/gibbs_pallas_hbm.py``: ``_kernel``
(K2, the dense coupling streamed one color panel at a time) and
``_kernel_bs`` (K3, only the packed occupied chunk panels of
``ops/block_sparse.py``), with their wrapper ``gibbs_sweeps_pallas_hbm``.
Every mode, f32, bf16 and int8, is the sparse field gather of
``ops/gibbs_sparse.py`` (``csrc/gibbs_sparse.cu``), which reads the
coupling only at the plan's edges through a neighbour table whose offsets
point into the coupling as it is stored: the dense (n_pad, n_pad) matrix
for K2, the packed panels for K3.

``gibbs_sweeps_hbm_cuda`` is the wrapper.  It takes a dense f32 or bf16
coupling or a ``QuantCoupling`` (K2), or a ``BlockSparseCoupling`` with
f32, bf16 or int8 panels (K3), fed uniforms or the in-kernel Philox
stream (K1's counter and key), and the energy carry.  Like the Pallas
kernels it rounds the sweep count up to even, and an int8 coupling works
in quantized units (h / scale, β · scale), its ΔE rescaled.  For a tensor
on the CPU it runs the gather's plain version
(``gibbs_sparse.gibbs_sweeps_sparse_reference``); for a CUDA tensor it
launches the kernel or raises.  ``gibbs_sweeps_hbm_cuda.launches`` counts
launches by kernel and mode, e.g. ``"K3-bf16-dE"``, ``"K2-f32"`` or
``"K2-int8"``.  ``gibbs_sweeps_hbm_reference`` is the dense plain version
with the Pallas kernels' semantics, the yardstick the gather is held to
under the chain rule.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
from image_generation_tpu_torch.ops.gibbs import GibbsPlan, is_quantized, sweeps_in_kernel_units
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse

__all__ = [
    "gibbs_sweeps_hbm_cuda",
    "gibbs_sweeps_hbm_reference",
    "round_sweeps",
]

_VALUE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the mode name's value type


def round_sweeps(n_sweeps: int) -> int:
    """The sweeps K2 and K3 run: ``n_sweeps`` rounded up to even."""
    return 2 * (-(-int(n_sweeps) // 2))


def _value_type(coupling_p) -> str:
    """"int8", "bf16" or "f32": the value type of a coupling's mode name
    (another type's name for a coupling the gather refuses)."""
    if is_quantized(coupling_p):
        return "int8"
    stored = coupling_p.panels if isinstance(coupling_p, BlockSparseCoupling) else coupling_p
    dtype = getattr(stored, "dtype", None)
    return _VALUE_NAMES.get(dtype, str(dtype))


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
    the end).  It sums the fields as a dense product, in another order
    than the gather kernel (whose own twin is
    ``gibbs_sparse.gibbs_sweeps_sparse_reference``), so the kernel is held
    to it under the chain rule, and bit for bit on integer couplings.

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
):
    """``round_sweeps(n_sweeps)`` colored block-Gibbs sweeps through K2 (a
    dense f32 / bf16 coupling or a ``QuantCoupling``) or K3 (a
    ``BlockSparseCoupling``), both the gather kernel
    (``gibbs_sparse.gibbs_sweeps_sparse``).

    ``hp`` (n_pad,) f32, ``spins_p`` (chains, n_pad) f32, ``beta`` scalar
    or (chains,); optional fed ``uniforms`` (>= round_sweeps(n_sweeps),
    chains, n_pad) f32, else the kernel draws from its Philox stream keyed
    by a seed drawn from ``generator``.  Returns new f32 spins, or (spins,
    delta_e) with ``track_delta_e``.  The gather reads the coupling only
    at the plan's edges: it must be zero everywhere else, as every
    coupling ``permuted_model`` builds (and ``pack_coupling`` packs) is.
    A CPU ``spins_p`` runs the gather's plain version; a CUDA one launches
    the kernel, and anything it does not take raises (there is no other
    kernel to fall back to).
    """
    n_run = round_sweeps(n_sweeps)
    _check_fed(uniforms, n_run, *spins_p.shape)
    kernel = "K3" if isinstance(coupling_p, BlockSparseCoupling) else "K2"
    return gibbs_sweeps_sparse(
        hp, coupling_p, plan, spins_p, n_run, beta, generator=generator,
        uniforms=uniforms, track_delta_e=track_delta_e,
        count=(gibbs_sweeps_hbm_cuda.launches,
               f"{kernel}-{_value_type(coupling_p)}" + ("-dE" if track_delta_e else "")))


gibbs_sweeps_hbm_cuda.launches = collections.Counter()
