"""Graph coloring for parallel block-Gibbs updates.

Port of ``image_generation_tpu/utils/coloring.py`` ``greedy_coloring``
over plain edge lists instead of a networkx graph: the same order (largest
degree first, ties broken by node index) and so the same coloring.  All
spins of one color are mutually non-adjacent, so a color block updates at
once and a pass over the colors is a valid Gibbs sweep.
"""

from __future__ import annotations

import numpy as np

__all__ = ["greedy_coloring"]


def greedy_coloring(n: int, edge_i, edge_j) -> np.ndarray:
    """Proper vertex coloring, greedy largest-degree-first.

    ``edge_i``/``edge_j``: (E,) endpoints of unique, non-self edges over
    nodes 0..n-1.  Returns an (n,) int32 color per node.
    """
    edge_i = np.asarray(edge_i, np.int64)
    edge_j = np.asarray(edge_j, np.int64)
    src = np.concatenate([edge_i, edge_j])
    dst = np.concatenate([edge_j, edge_i])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n + 1))
    degree = np.diff(starts)
    colors = np.full(n, -1, dtype=np.int32)
    # stable sort on −degree keeps ascending index among equal degrees
    for v in np.argsort(-degree, kind="stable"):
        nbr = colors[dst[starts[v] : starts[v + 1]]]
        used = set(nbr[nbr >= 0].tolist())
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    assert not (colors[edge_i] == colors[edge_j]).any(), "coloring is not proper"
    return colors
