"""The colour-permuted coordinates the sampler's random numbers are keyed by.

The in-kernel generator of the sampler under test draws the uniform of a
spin from a counter that holds the spin's padded column.  To draw the same
numbers the reference has to put every spin at the same column, so this
module is a frozen copy of that layout's published algorithm (the one the
JAX package and its port share): a greedy largest-degree-first colouring,
members of a colour in breadth-first order, colours cut into blocks of at
most ``max_class`` spins, each block padded to a multiple of 128.  It
reads nothing of the program.

``Plan.spans`` are the runs of blocks of one colour: no two spins of a
span are coupled, so a span updates at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Plan", "build_plan"]


@dataclass(frozen=True)
class Plan:
    n: int
    n_pad: int
    orig_to_perm: np.ndarray  # (n,) padded column of each spin
    spans: tuple               # ((c0, c1), ...) column ranges, one per colour run


def _adjacency(n: int, ei: np.ndarray, ej: np.ndarray, lexsorted: bool):
    src = np.concatenate([ei, ej])
    dst = np.concatenate([ej, ei])
    order = np.lexsort((dst, src)) if lexsorted else np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    return dst, np.searchsorted(src, np.arange(n + 1))


def _colouring(n: int, ei: np.ndarray, ej: np.ndarray) -> np.ndarray:
    dst, starts = _adjacency(n, ei, ej, lexsorted=False)
    colours = np.full(n, -1, dtype=np.int64)
    for v in np.argsort(-np.diff(starts), kind="stable"):
        nbr = colours[dst[starts[v]:starts[v + 1]]]
        used = set(nbr[nbr >= 0].tolist())
        c = 0
        while c in used:
            c += 1
        colours[v] = c
    if (colours[ei] == colours[ej]).any():
        raise AssertionError("colouring is not proper")
    return colours


def _bfs_rank(n: int, ei: np.ndarray, ej: np.ndarray) -> np.ndarray:
    dst, starts = _adjacency(n, ei, ej, lexsorted=True)
    rank = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for root in range(n):
        if rank[root] >= 0:
            continue
        rank[root] = nxt
        nxt += 1
        queue, head = [root], 0
        while head < len(queue):
            v = queue[head]
            head += 1
            for u in dst[starts[v]:starts[v + 1]]:
                if rank[u] < 0:
                    rank[u] = nxt
                    nxt += 1
                    queue.append(int(u))
    return rank


def build_plan(n: int, edge_i, edge_j, pad_to: int = 128) -> Plan:
    """The padded colour-permuted layout of an ``n``-spin graph."""
    ei = np.asarray(edge_i, np.int64)
    ej = np.asarray(edge_j, np.int64)
    max_class = 512 if n <= 2048 else (256 if n <= 4096 else 128)
    colours = _colouring(n, ei, ej)
    members = [[] for _ in range(int(colours.max()) + 1 if n else 0)]
    for v in np.argsort(_bfs_rank(n, ei, ej), kind="stable"):
        members[colours[int(v)]].append(int(v))
    orig_to_perm = np.zeros(n, dtype=np.int64)
    spans, pos = [], 0
    for group in members:
        start = pos
        for i in range(0, len(group), max_class):
            for v in group[i:i + max_class]:
                orig_to_perm[v] = pos
                pos += 1
            pos = -(-pos // pad_to) * pad_to
        spans.append((start, pos))
    return Plan(n=n, n_pad=pos, orig_to_perm=orig_to_perm, spans=tuple(spans))
