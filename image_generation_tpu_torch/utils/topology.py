"""QPU topology generators: Chimera, Pegasus and Zephyr coupling graphs.

Port of ``image_generation_tpu/utils/topology.py`` without networkx.  A
graph is a :class:`Graph`: an adjacency dict of dicts in insertion order,
built by the same sequence of ``add_edge`` calls as the JAX package's
networkx graphs, so nodes, each node's neighbours and ``edges()`` come out
in the same order (the latent-graph selection, ``utils/subgraph.py``,
depends on that order).  Graph-level metadata (``family``, ``rows``,
``columns``, ``tile``) is kept, and each generator stores every node's 2-D
plotting position in ``Graph.pos`` with the JAX package's arithmetic (its
networkx ``pos`` node attributes); ``graph_layout`` normalises them to the
unit square.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

__all__ = [
    "Graph",
    "chimera_graph",
    "pegasus_graph",
    "zephyr_graph",
    "graph_for_qpu",
    "graph_layout",
    "QPU_TOPOLOGIES",
]

# Known QPU product names → (family, size), as in the JAX package.
QPU_TOPOLOGIES = {
    "Advantage_system4": ("pegasus", 16),
    "Advantage_system6": ("pegasus", 16),
    "Advantage2_system1": ("zephyr", 15),
    "Advantage2_prototype": ("zephyr", 6),
    "DW_2000Q": ("chimera", 16),
}


class Graph:
    """Undirected simple graph as an insertion-ordered adjacency dict, with
    the iteration order of ``networkx.Graph`` for the operations used here.
    ``pos`` maps a node to its plotting position (networkx's ``pos`` node
    attribute), set by the generators; the copies below carry none (no
    selected latent graph is laid out)."""

    def __init__(self, **attrs):
        self.adj: Dict[int, Dict[int, None]] = {}
        self.graph = dict(attrs)
        self.pos: Dict[int, Tuple[float, float]] = {}

    def add_node(self, n: int) -> None:
        if n not in self.adj:
            self.adj[n] = {}

    def add_edge(self, u: int, v: int) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = None  # re-setting a key keeps its position
        self.adj[v][u] = None

    def remove_nodes_from(self, nodes) -> None:
        for n in nodes:
            for nbr in self.adj.pop(n):
                if nbr != n:
                    del self.adj[nbr][n]

    def nodes(self) -> list:
        return list(self.adj)

    def neighbors(self, n: int):
        return iter(self.adj[n])

    def degree(self, n: int) -> int:
        return len(self.adj[n])

    def number_of_nodes(self) -> int:
        return len(self.adj)

    def edges(self) -> Iterator[Tuple[int, int]]:
        """Each edge once, as networkx's ``EdgeView`` yields it."""
        seen = set()
        for n, nbrs in self.adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    yield (n, nbr)
            seen.add(n)

    def copy(self) -> "Graph":
        """As ``networkx.Graph.copy``: nodes in order, then the edges of the
        adjacency walk."""
        g = Graph(**self.graph)
        for n in self.adj:
            g.add_node(n)
        for u, nbrs in self.adj.items():
            for v in nbrs:
                g.add_edge(u, v)
        return g

    def subgraph_copy(self, nodes) -> "Graph":
        """``networkx.Graph.subgraph(nodes).copy()``, iteration order
        included: the view keeps ``set(nodes)`` and, while that set holds
        fewer than half of the graph's nodes, iterates the set itself,
        else the graph's own node order filtered; each node's neighbours
        stay in the graph's order."""
        keep = set(n for n in nodes if n in self.adj)
        if 2 * len(keep) < len(self.adj):
            order = list(keep)
        else:
            order = [n for n in self.adj if n in keep]
        g = Graph(**self.graph)
        for n in order:
            g.add_node(n)
        for u in order:
            for v in self.adj[u]:
                if v in keep:
                    g.add_edge(u, v)
        return g

    def relabel(self, mapping: dict) -> "Graph":
        """``networkx.relabel_nodes(self, mapping)`` (a copy): nodes in
        order, then the edges in ``edges()`` order."""
        g = Graph(**self.graph)
        for n in self.adj:
            g.add_node(mapping.get(n, n))
        for u, v in self.edges():
            g.add_edge(mapping.get(u, u), mapping.get(v, v))
        return g


# ---------------------------------------------------------------------------
# Chimera
# ---------------------------------------------------------------------------

def chimera_graph(m: int, n: Optional[int] = None, t: int = 4) -> Graph:
    """Ideal Chimera graph C(m, n, t): an m×n grid of K_{t,t} cells.
    Linear index of (i, j, u, k) = ((i·n + j)·2 + u)·t + k."""
    if n is None:
        n = m
    g = Graph(family="chimera", rows=m, columns=n, tile=t)

    def idx(i: int, j: int, u: int, k: int) -> int:
        return ((i * n + j) * 2 + u) * t + k

    for i in range(m):
        for j in range(n):
            for k0 in range(t):
                for k1 in range(t):
                    g.add_edge(idx(i, j, 0, k0), idx(i, j, 1, k1))
            for k in range(t):
                if i + 1 < m:
                    g.add_edge(idx(i, j, 0, k), idx(i + 1, j, 0, k))
                if j + 1 < n:
                    g.add_edge(idx(i, j, 1, k), idx(i, j + 1, 1, k))
    # plotting coordinates: the t qubits of each orientation spread inside
    # the cell, vertical qubits as columns and horizontal ones as rows
    for i in range(m):
        for j in range(n):
            for k in range(t):
                g.pos[idx(i, j, 0, k)] = (j + 0.15 + 0.7 * k / max(t - 1, 1), -(i + 0.5))
                g.pos[idx(i, j, 1, k)] = (j + 0.5, -(i + 0.15 + 0.7 * k / max(t - 1, 1)))
    return g


# ---------------------------------------------------------------------------
# Pegasus
# ---------------------------------------------------------------------------

_PEGASUS_SHIFTS_V = (2, 2, 2, 6, 6, 6, 10, 10, 10, 2, 2, 2)
_PEGASUS_SHIFTS_H = (6, 6, 6, 10, 10, 10, 2, 2, 2, 6, 6, 6)


def pegasus_graph(
    m: int,
    fabric_only: bool = True,
    shifts_v: Sequence[int] = _PEGASUS_SHIFTS_V,
    shifts_h: Sequence[int] = _PEGASUS_SHIFTS_H,
) -> Graph:
    """Ideal Pegasus graph P(m) (the JAX docstring states the geometric
    construction).  Linear index of (u, w, k, z) = ((u·m + w)·12 + k)·(m−1)
    + z.  ``fabric_only`` drops the qubits with no internal coupler."""
    g = Graph(family="pegasus", rows=m, columns=m, tile=12)
    zmax = m - 1

    def idx(u: int, w: int, k: int, z: int) -> int:
        return ((u * m + w) * 12 + k) * zmax + z

    for u in range(2):  # external couplers
        for w in range(m):
            for k in range(12):
                for z in range(zmax - 1):
                    g.add_edge(idx(u, w, k, z), idx(u, w, k, z + 1))
    for u in range(2):  # odd couplers
        for w in range(m):
            for j in range(6):
                for z in range(zmax):
                    g.add_edge(idx(u, w, 2 * j, z), idx(u, w, 2 * j + 1, z))
    for wv in range(m):  # internal couplers: mutual crossings
        for kv in range(12):
            x = 12 * wv + kv
            for zv in range(zmax):
                lo = 12 * zv + shifts_v[kv]
                for y in range(lo, lo + 12):
                    wh, kh = divmod(y, 12)
                    if not (0 <= wh < m):
                        continue
                    zh, _r = divmod(x - shifts_h[kh], 12)
                    if 0 <= zh < zmax:
                        g.add_edge(idx(0, wv, kv, zv), idx(1, wh, kh, zh))

    if fabric_only:
        per_u = (m - 1) * 12 * m
        dead = [
            node for node in g.nodes()
            if not any(nbr // per_u != node // per_u for nbr in g.neighbors(node))
        ]
        g.remove_nodes_from(dead)
    for node in g.nodes():  # plotting coordinates: the segment midpoint
        node_, z = divmod(node, zmax)
        node_, k = divmod(node_, 12)
        u, w = divmod(node_, m)
        axis = 12 * w + k
        center = 12 * z + (shifts_v[k] if u == 0 else shifts_h[k]) + 5.5
        g.pos[node] = (axis, -center) if u == 0 else (center, -axis)
    return g


# ---------------------------------------------------------------------------
# Zephyr
# ---------------------------------------------------------------------------

def zephyr_graph(m: int, t: int = 4) -> Graph:
    """Ideal Zephyr graph Z(m, t) (the JAX docstring states the rules and
    counts: Z(15, 4) has 7,440 qubits and 71,736 couplers).  Linear index
    of (u, w, k, j, z) = (((u·(2m+1) + w)·t + k)·2 + j)·m + z."""
    g = Graph(family="zephyr", rows=m, columns=m, tile=t)
    W = 2 * m + 1

    def idx(u: int, w: int, k: int, j: int, z: int) -> int:
        return (((u * W + w) * t + k) * 2 + j) * m + z

    for u in range(2):
        for w in range(W):
            for k in range(t):
                for j in range(2):  # external couplers
                    for z in range(m - 1):
                        g.add_edge(idx(u, w, k, j, z), idx(u, w, k, j, z + 1))
                for z in range(m):  # odd couplers
                    g.add_edge(idx(u, w, k, 0, z), idx(u, w, k, 1, z))
                    if z + 1 < m:
                        g.add_edge(idx(u, w, k, 1, z), idx(u, w, k, 0, z + 1))

    for wv in range(W):  # internal couplers
        for jv in range(2):
            zh = (wv - 1) // 2 if wv % 2 else wv // 2 - jv
            if not (0 <= zh < m):
                continue
            for zv in range(m):
                for jh in range(2):
                    for wh in (2 * zv + 1, 2 * zv + 2 * jh):
                        for kv in range(t):
                            for kh in range(t):
                                g.add_edge(idx(0, wv, kv, jv, zv), idx(1, wh, kh, jh, zh))
    for node in g.nodes():  # plotting coordinates: segment midpoint, wires fanned
        node_, z = divmod(node, m)
        node_, j = divmod(node_, 2)
        node_, k = divmod(node_, t)
        u, w = divmod(node_, W)
        axis = w + 0.08 * (k - (t - 1) / 2)
        center = 2 * z + j + 1
        g.pos[node] = (axis, -center) if u == 0 else (center, -axis)
    return g


def graph_for_qpu(qpu: str, **overrides) -> Graph:
    """The ideal coupling graph of a named QPU product; unknown names give
    Zephyr Z(15), as in the JAX package."""
    family, size = QPU_TOPOLOGIES.get(qpu, ("zephyr", 15))
    family = overrides.pop("family", family)
    size = overrides.pop("size", size)
    if family == "pegasus":
        return pegasus_graph(size, **overrides)
    if family == "zephyr":
        return zephyr_graph(size, **overrides)
    if family == "chimera":
        return chimera_graph(size, **overrides)
    raise ValueError(f"unknown topology family: {family}")


def graph_layout(graph: Graph) -> dict:
    """2-D plotting positions normalised to the unit square: the
    generators' ``pos`` when every node has one, else the spring layout
    (``utils/layout.py``), in node order (the JAX function's)."""
    pos = {n: graph.pos[n] for n in graph.adj if n in graph.pos}
    if len(pos) != graph.number_of_nodes():
        from image_generation_tpu_torch.utils.layout import spring_layout

        pos = spring_layout(graph, seed=0)
    xs = [p[0] for p in pos.values()]
    ys = [p[1] for p in pos.values()]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    sx = (x1 - x0) or 1.0
    sy = (y1 - y0) or 1.0
    return {n: ((x - x0) / sx, (y - y0) / sy) for n, (x, y) in pos.items()}
