"""Block-sparse packing of the graph-sharded coupling.

Port of ``image_generation_tpu/ops/block_sparse_sharded.py``.  Under graph
sharding (``ops/gibbs_graph_sharded.py``) each rank holds a row block of
the dense permuted coupling; this module packs the occupied chunks of that
row block on a shard-local chunk grid, so per-rank coupling memory and
per-span products drop by the packed occupancy on top of the mesh factor
(and another 4× for int8 panels).

The layout is the JAX package's, panel for panel: each color's panel count
pads to the maximum over the shards (``kmax``; the JAX ``shard_map`` traced
one program for every shard), unused slots hold zero panels, and the
clamped final chunk's rows that the previous chunk covers are zeroed.  The
host half (``sharded_chunk_meta``) is the same numpy code, so a rank's
panels equal the JAX shard's bit for bit.  The chunk offsets differ per
shard but are known on the host for each rank, so the spin chunks are read
with plain slices where the JAX package used ``dynamic_slice`` at traced
offsets.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_generation_tpu_torch.ops.block_sparse import _max_width, chunk_starts, owner_chunk
from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "ShardedBlockSparseCoupling",
    "ShardedChunkMeta",
    "sharded_chunk_meta",
    "supports_sharded_block_sparse",
    "pack_coupling_graph_sharded",
    "color_partial_fields",
]


@dataclass(frozen=True, eq=False)
class ShardedBlockSparseCoupling:
    """One rank's packed occupied coupling chunks with their layout.

    ``panels`` (total_slots·chunk, max_width): this rank's panels in the
    resident dtype (int8 with ``scale`` when quantized); ``offs``: its
    local row offset of each panel slot (host integers); ``kmax``: the
    per-color panel count, padded to the maximum over the ``n_shards``
    shards; ``shard``: this rank's graph index."""

    panels: torch.Tensor
    offs: Tuple[int, ...]
    scale: Optional[torch.Tensor]
    plan: object
    chunk: int
    kmax: Tuple[int, ...]
    n_shards: int
    shard: int

    @property
    def quantized(self) -> bool:
        return self.scale is not None

    @property
    def slot_base(self) -> Tuple[int, ...]:
        base, pos = [], 0
        for k in self.kmax:
            base.append(pos)
            pos += k
        return tuple(base)


class ShardedChunkMeta(NamedTuple):
    kmax: Tuple[int, ...]  # per-color padded panel count (max over shards)
    offs: np.ndarray  # (n_shards, total_slots) int32 local chunk offsets
    zero_head: np.ndarray  # (n_shards, total_slots) int32 rows to zero
    occupancy: float  # padded chunks / dense chunks (per shard)


_sharded_meta_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def sharded_chunk_meta(plan, n_shards: int, chunk: int) -> ShardedChunkMeta:
    """The packing layout of ``plan`` row-sharded ``n_shards`` ways (the
    JAX function's numpy, weak-cached per plan).  Requires
    ``supports_sharded_block_sparse``."""
    per_plan = _sharded_meta_cache.setdefault(plan, {})
    hit = per_plan.get((n_shards, chunk))
    if hit is not None:
        return hit
    l_loc = plan.n_pad // n_shards
    starts = chunk_starts(l_loc, chunk)
    n_local = len(starts)
    overlap = 0
    if n_local > 1:
        overlap = (starts[-2] + chunk) - starts[-1]

    block_of = np.zeros(plan.n_pad, np.int32)
    for bi, (s, _v, e) in enumerate(plan.blocks):
        block_of[s:e] = bi
    n_colors = len(plan.blocks)

    pi = np.asarray(plan.perm_edge_i)
    pj = np.asarray(plan.perm_edge_j)
    occ = np.zeros((n_colors, n_shards, n_local), bool)
    for rows, cols in ((pi, pj), (pj, pi)):
        sh = rows // l_loc
        loc = rows % l_loc
        occ[block_of[cols], sh, owner_chunk(loc, l_loc, chunk)] = True

    per_cs = occ.sum(axis=2)  # (colors, shards) occupied chunk counts
    kmax = tuple(int(k) for k in per_cs.max(axis=1))
    total = sum(kmax)
    offs = np.zeros((n_shards, total), np.int32)
    zero_head = np.full((n_shards, total), chunk, np.int32)  # unused → all-zero
    base = 0
    for c in range(n_colors):
        for d in range(n_shards):
            for k, r in enumerate(np.nonzero(occ[c, d])[0]):
                offs[d, base + k] = starts[r]
                zero_head[d, base + k] = (
                    overlap if (r == n_local - 1 and overlap) else 0
                )
        base += kmax[c]
    occupancy = total / max(n_colors * n_local, 1)
    meta = ShardedChunkMeta(kmax, offs, zero_head, occupancy)
    per_plan[(n_shards, chunk)] = meta
    return meta


def supports_sharded_block_sparse(plan, n_shards: int, chunk: int) -> bool:
    """The shard-local grid needs whole chunks inside each row shard."""
    return plan.n_pad % n_shards == 0 and plan.n_pad // n_shards >= chunk


def pack_coupling_graph_sharded(plan, coupling_rows, mesh, chunk: int = 128
                                ) -> ShardedBlockSparseCoupling:
    """Pack this rank's dense row block ((n_pad / graph, n_pad), f32 or
    bf16, or a ``QuantCoupling`` of it) into its occupied chunk panels, in
    the block's dtype.  ``mesh`` (``parallel/mesh.py``) says which shard
    this is."""
    n_shards, shard = mesh.graph, mesh.graph_index
    if not supports_sharded_block_sparse(plan, n_shards, chunk):
        raise ValueError(
            f"chunk={chunk} does not fit the {n_shards}-way row shard of n_pad={plan.n_pad}"
        )
    quant = isinstance(coupling_rows, QuantCoupling)
    mat = coupling_rows.q if quant else coupling_rows
    l_loc = plan.n_pad // n_shards
    if tuple(mat.shape) != (l_loc, plan.n_pad):
        raise ValueError(f"this rank's rows must be ({l_loc}, {plan.n_pad}), "
                         f"got {tuple(mat.shape)}")
    meta = sharded_chunk_meta(plan, n_shards, chunk)
    offs = tuple(int(o) for o in meta.offs[shard])
    zhead = meta.zero_head[shard]
    max_w = _max_width(plan)
    parts = []
    slot = 0
    for (c0, _v, c1), k_c in zip(plan.blocks, meta.kmax):
        for _ in range(k_c):
            skip = int(zhead[slot])
            p = mat[offs[slot] + skip: offs[slot] + chunk, c0:c1]
            parts.append(F.pad(p, (0, max_w - (c1 - c0), skip, 0)))
            slot += 1
    panels = torch.cat(parts, 0) if parts else mat.new_zeros((0, max_w))
    return ShardedBlockSparseCoupling(
        panels=panels.contiguous(), offs=offs,
        scale=coupling_rows.scale if quant else None, plan=plan, chunk=chunk,
        kmax=meta.kmax, n_shards=n_shards, shard=shard,
    )


def color_partial_fields(bsc: ShardedBlockSparseCoupling, s_own: torch.Tensor, c: int,
                         matmul_dtype=None) -> Optional[torch.Tensor]:
    """This rank's partial products of color block ``c`` from its own spin
    columns ``s_own`` (rows, n_pad / graph): Σ over its occupied chunks of
    s_own[:, chunk rows] @ panel, as (rows, width) f32 (exact integers for
    int8 panels, unscaled: the caller all-reduces them and scales out
    once).  None when no shard couples into ``c`` (every rank agrees:
    ``kmax`` is the maximum over the shards).  ``matmul_dtype`` rounds
    f32 panels to it first, as the dense path casts."""
    k_c = bsc.kmax[c]
    if k_c == 0:
        return None
    base, chunk = bsc.slot_base[c], bsc.chunk
    c0, _v, c1 = bsc.plan.blocks[c]
    parts = [s_own[:, o: o + chunk] for o in bsc.offs[base: base + k_c]]
    lhs = parts[0] if k_c == 1 else torch.cat(parts, 1)
    pan = bsc.panels[base * chunk: (base + k_c) * chunk, : c1 - c0]
    if matmul_dtype is not None and not bsc.quantized:
        pan = pan.to(matmul_dtype)
    return lhs.to(torch.float32) @ pan.to(torch.float32)
