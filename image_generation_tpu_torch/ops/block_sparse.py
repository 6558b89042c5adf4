"""Host helpers of the block-sparse coupling layout.

Port of the numpy part of ``image_generation_tpu/ops/block_sparse.py``:
the chunk grid over the padded spins and its occupancy, which decides
whether ``SWEEP_BLOCK_SPARSE="auto"`` packs the coupling
(``TrainingConfig.resolved_block_sparse``).  The packed sweep itself
(kernel K3) is not ported.
"""

from __future__ import annotations

import weakref
from typing import Tuple

import numpy as np

__all__ = ["chunk_starts", "color_chunk_rows", "chunk_occupancy"]


def chunk_starts(n_pad: int, chunk: int) -> Tuple[int, ...]:
    """Chunk start offsets covering [0, n_pad); when ``chunk`` does not
    divide ``n_pad`` the final chunk starts at ``n_pad - chunk``."""
    if n_pad <= chunk:
        return (0,)
    n_full = n_pad // chunk
    starts = [k * chunk for k in range(n_full)]
    if n_full * chunk < n_pad:
        starts.append(n_pad - chunk)
    return tuple(starts)


_chunk_rows_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def color_chunk_rows(plan, chunk: int) -> Tuple[Tuple[int, ...], ...]:
    """For each color block: the sorted indices of the row chunks that
    couple into its columns (the nonzero row chunks of A[:, c0:c1])."""
    per_plan = _chunk_rows_cache.setdefault(plan, {})
    hit = per_plan.get(chunk)
    if hit is not None:
        return hit
    starts = chunk_starts(plan.n_pad, chunk)
    n_chunks = len(starts)
    last_owned = starts[-1] if n_chunks == 1 else starts[-2] + chunk

    def owner(rows):
        return np.where(rows >= last_owned, n_chunks - 1, rows // chunk)

    block_of = np.zeros(plan.n_pad, np.int32)
    for bi, (s, _v, e) in enumerate(plan.blocks):
        block_of[s:e] = bi
    occ = np.zeros((len(plan.blocks), n_chunks), bool)
    pi = np.asarray(plan.perm_edge_i)
    pj = np.asarray(plan.perm_edge_j)
    occ[block_of[pj], owner(pi)] = True
    occ[block_of[pi], owner(pj)] = True
    result = tuple(tuple(np.nonzero(occ[c])[0].tolist()) for c in range(len(plan.blocks)))
    per_plan[chunk] = result
    return result


def chunk_occupancy(plan, chunk: int = 256) -> float:
    """Fraction of (color, chunk) coupling tiles that are nonzero."""
    rows = color_chunk_rows(plan, chunk)
    denom = len(plan.blocks) * len(chunk_starts(plan.n_pad, chunk))
    return sum(map(len, rows)) / max(denom, 1)
