"""Block-sparse packing of the permuted coupling matrix.

Port of ``image_generation_tpu/ops/block_sparse.py``.  ``build_plan``
orders each color class by BFS rank, so a color block's neighbours fall in
few aligned row chunks of the permuted matrix (on the 5,640-spin Pegasus
latent, 32 % of the 256-row chunks).  The occupied chunks of each color's
column panel are packed into one contiguous array,

    panels[offset_c·chunk : (offset_c + n_c)·chunk, :width_c]
        = A[occupied row chunks of color c, c0:c1]        (zero rows dropped)

each panel padded to the widest block.  The streaming sweep kernel's
packed form (K3, ``ops/gibbs_hbm_cuda.py``) reads only these rows, and
``ising_energies_block_sparse`` computes ladder energies from them.

The host half (chunk grid, per-color chunk lists, occupancy, offsets) is
the same numpy code as the JAX package's, so both pack the same panels.
Packing composes with int8 quantization: the panels then hold the
``QuantCoupling``'s int8 rows and carry its scale.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "BlockSparseCoupling",
    "chunk_starts",
    "owner_chunk",
    "color_chunk_rows",
    "chunk_occupancy",
    "panel_offsets",
    "panel_offset",
    "pack_coupling",
    "color_fields",
    "ising_energies_block_sparse",
]


@dataclass(frozen=True, eq=False)
class BlockSparseCoupling:
    """Packed occupied coupling chunks with the plan they were cut for."""

    panels: torch.Tensor  # (total_chunks·chunk, max_width) packed rows
    scale: Optional[torch.Tensor]  # () f32 when int8-quantized, else None
    plan: object  # GibbsPlan (compared by identity)
    chunk: int = 256

    @property
    def quantized(self) -> bool:
        return self.scale is not None


def chunk_starts(n_pad: int, chunk: int) -> Tuple[int, ...]:
    """Chunk start offsets covering [0, n_pad); when ``chunk`` does not
    divide ``n_pad`` the final chunk starts at ``n_pad - chunk`` (it
    overlaps the previous one, whose rows ``pack_coupling`` keeps)."""
    if n_pad <= chunk:
        return (0,)
    n_full = n_pad // chunk
    starts = [k * chunk for k in range(n_full)]
    if n_full * chunk < n_pad:
        starts.append(n_pad - chunk)
    return tuple(starts)


def owner_chunk(rows, n_pad: int, chunk: int) -> np.ndarray:
    """The chunk of ``chunk_starts(n_pad, chunk)`` that holds each row in
    the packed panels: ``row // chunk``, except that the clamped final
    chunk holds only the rows past the chunk before it (the rows they
    share stay with the earlier chunk)."""
    starts = chunk_starts(n_pad, chunk)
    n_chunks = len(starts)
    last_owned = starts[-1] if n_chunks == 1 else starts[-2] + chunk
    rows = np.asarray(rows)
    return np.where(rows >= last_owned, n_chunks - 1, rows // chunk)


_chunk_rows_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def color_chunk_rows(plan, chunk: int) -> Tuple[Tuple[int, ...], ...]:
    """For each color block: the sorted indices of the row chunks that
    couple into its columns (the nonzero row chunks of A[:, c0:c1])."""
    per_plan = _chunk_rows_cache.setdefault(plan, {})
    hit = per_plan.get(chunk)
    if hit is not None:
        return hit
    n_chunks = len(chunk_starts(plan.n_pad, chunk))
    block_of = np.zeros(plan.n_pad, np.int32)
    for bi, (s, _v, e) in enumerate(plan.blocks):
        block_of[s:e] = bi
    occ = np.zeros((len(plan.blocks), n_chunks), bool)
    pi = np.asarray(plan.perm_edge_i)
    pj = np.asarray(plan.perm_edge_j)
    occ[block_of[pj], owner_chunk(pi, plan.n_pad, chunk)] = True
    occ[block_of[pi], owner_chunk(pj, plan.n_pad, chunk)] = True
    result = tuple(tuple(np.nonzero(occ[c])[0].tolist()) for c in range(len(plan.blocks)))
    per_plan[chunk] = result
    return result


def chunk_occupancy(plan, chunk: int = 256) -> float:
    """Fraction of (color, chunk) coupling tiles that are nonzero."""
    rows = color_chunk_rows(plan, chunk)
    denom = len(plan.blocks) * len(chunk_starts(plan.n_pad, chunk))
    return sum(map(len, rows)) / max(denom, 1)


def panel_offsets(plan, chunk: int) -> Tuple[Tuple[int, ...], int]:
    """(per-color first-chunk offset into the packed panels, total chunks)."""
    rows = color_chunk_rows(plan, chunk)
    offs, pos = [], 0
    for r in rows:
        offs.append(pos)
        pos += len(r)
    return tuple(offs), pos


def _max_width(plan) -> int:
    return max(e - s for s, _v, e in plan.blocks)


def panel_offset(plan, chunk: int, rows, cols) -> np.ndarray:
    """The flat offsets of A[rows, cols] in ``pack_coupling(plan, ·,
    chunk).panels`` (row-major, ``_max_width(plan)`` wide): the panel row
    of the row's owning chunk (``owner_chunk``) in its column's color
    panel, times the width, plus the column's place in its block.  Raises
    for an entry whose chunk is not packed for its color (A is zero
    there)."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    starts = np.asarray(chunk_starts(plan.n_pad, chunk), np.int64)
    block_of = np.zeros(plan.n_pad, np.int64)
    c0_of = np.zeros(plan.n_pad, np.int64)
    for b, (s, _v, e) in enumerate(plan.blocks):
        block_of[s:e], c0_of[s:e] = b, s
    first = np.full((len(plan.blocks), len(starts)), -1, np.int64)  # panel of (color, chunk)
    offs, _ = panel_offsets(plan, chunk)
    for b, (rlist, o) in enumerate(zip(color_chunk_rows(plan, chunk), offs)):
        first[b, list(rlist)] = o + np.arange(len(rlist))
    owner = owner_chunk(rows, plan.n_pad, chunk)
    panel = first[block_of[cols], owner]
    if np.any(panel < 0):
        raise ValueError("an entry's chunk is not packed for its color")
    return (panel * chunk + rows - starts[owner]) * _max_width(plan) + cols - c0_of[cols]


def pack_coupling(plan, coupling_p, chunk: int = 256) -> BlockSparseCoupling:
    """Pack a dense permuted coupling (f32, bf16, or a ``QuantCoupling``)
    into its occupied chunk panels, in the coupling's dtype.  The rows of
    the clamped final chunk that the previous chunk already covers are
    zeroed, so nothing counts twice."""
    quant = isinstance(coupling_p, QuantCoupling)
    mat = coupling_p.q if quant else coupling_p
    starts = chunk_starts(plan.n_pad, chunk)
    rows = color_chunk_rows(plan, chunk)
    max_w = _max_width(plan)
    # rows of a chunk that another chunk owns (the clamped final chunk's head)
    skip_of = [int(np.sum(owner_chunk(np.arange(s, s + chunk), plan.n_pad, chunk) != r))
               for r, s in enumerate(starts)]
    parts = []
    for (c0, _v, c1), rlist in zip(plan.blocks, rows):
        for r in rlist:
            skip = skip_of[r]
            p = mat[starts[r] + skip : starts[r] + chunk, c0:c1]
            if skip or c1 - c0 < max_w:
                p = F.pad(p, (0, max_w - (c1 - c0), skip, 0))
            parts.append(p)
    panels = torch.cat(parts, 0) if parts else mat.new_zeros((0, max_w))
    return BlockSparseCoupling(
        panels=panels.contiguous(), scale=coupling_p.scale if quant else None,
        plan=plan, chunk=chunk,
    )


def _gather_chunks(spins: torch.Tensor, starts, rlist, chunk: int) -> torch.Tensor:
    """(chains, len(rlist)·chunk) spin columns of the listed chunks."""
    parts = [spins[:, starts[r] : starts[r] + chunk] for r in rlist]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def color_fields(bsc: BlockSparseCoupling, spins: torch.Tensor, c: int, offs=None,
                 scaled: bool = True) -> Optional[torch.Tensor]:
    """(chains, width) products spins @ A[:, c0:c1] of color block ``c``
    read from the packed panels, in f32; None for an unoccupied color.

    Int8 panels give the exact integer products (±1 × int8 sums stay below
    2²⁴, so f32 holds them exactly), multiplied by the scale unless
    ``scaled`` is False (the kernel's quantized units)."""
    plan, chunk = bsc.plan, bsc.chunk
    rlist = color_chunk_rows(plan, chunk)[c]
    if not rlist:
        return None
    if offs is None:
        offs, _ = panel_offsets(plan, chunk)
    c0, _v, c1 = plan.blocks[c]
    pan = bsc.panels[offs[c] * chunk : (offs[c] + len(rlist)) * chunk, : c1 - c0]
    lhs = _gather_chunks(spins, chunk_starts(plan.n_pad, chunk), rlist, chunk)
    f = lhs.to(torch.float32) @ pan.to(torch.float32)
    if bsc.quantized and scaled:
        f = f * bsc.scale
    return f


def ising_energies_block_sparse(hp: torch.Tensor, bsc: BlockSparseCoupling,
                                spins_p: torch.Tensor) -> torch.Tensor:
    """E(s) = h·s + ½ sᵀ A s from the packed panels (the contract of
    ``ops.gibbs.ising_energies``; padding contributes 0)."""
    plan = bsc.plan
    offs, _ = panel_offsets(plan, bsc.chunk)
    lead = spins_p.shape[:-1]
    flat = spins_p.reshape(-1, plan.n_pad).to(torch.float32)
    acc = torch.zeros(flat.shape[0], dtype=torch.float32, device=flat.device)
    for c, (c0, _v, c1) in enumerate(plan.blocks):
        f = color_fields(bsc, flat, c, offs)
        if f is not None:
            acc = acc + (flat[:, c0:c1] * f).sum(-1)
    return (flat @ hp + 0.5 * acc).reshape(lead)
