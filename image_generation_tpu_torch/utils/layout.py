"""Force-directed graph layout in numpy.

The JAX package draws a checkpoint without physical qubit coordinates with
``networkx.spring_layout(g, seed=0)``.  ``spring_layout`` is that call for
graphs under 500 nodes, step for step (networkx 3.6's ``method="force"``,
``_fruchterman_reingold``, then ``rescale_layout``), so the positions agree
with networkx's to rounding.  From 500 nodes networkx switches to a scipy
"energy" minimisation, which is not ported (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import numpy as np

__all__ = ["spring_layout"]

FORCE_MAX_NODES = 499  # networkx's "auto" method is "force" below 500 nodes
_ENERGY_TODO = "ROADMAP.md queue 1 item 9"


def spring_layout(graph, seed: int = 0, iterations: int = 50,
                  threshold: float = 1e-4) -> dict:
    """Fruchterman-Reingold positions of ``graph``'s nodes, centred and
    scaled so the largest coordinate magnitude is 1: {node: (x, y)}, in
    node order.  ``graph`` has networkx's ``nodes()`` / ``edges()``."""
    nodes = list(graph.nodes())
    n = len(nodes)
    if n == 0:
        return {}
    if n == 1:
        return {nodes[0]: np.zeros(2)}
    if n > FORCE_MAX_NODES:
        raise NotImplementedError(
            f"spring_layout of {n} nodes: networkx lays out graphs of 500 nodes and more "
            f"with its scipy 'energy' method, which is not ported ({_ENERGY_TODO})"
        )
    index = {v: i for i, v in enumerate(nodes)}
    adj = np.zeros((n, n))  # networkx's to_numpy_array: unit weights
    for u, v in graph.edges():
        adj[index[u], index[v]] = adj[index[v], index[u]] = 1.0
    pos = np.asarray(np.random.RandomState(seed).rand(n, 2), dtype=adj.dtype)

    k = np.sqrt(1.0 / n)  # the optimal distance between nodes
    # the initial temperature, about a tenth of the domain's width, cooled
    # linearly so that the last step is dt
    t = max(max(pos.T[0]) - min(pos.T[0]), max(pos.T[1]) - min(pos.T[1])) * 0.1
    dt = t / (iterations + 1)
    for _ in range(iterations):
        delta = pos[:, np.newaxis, :] - pos[np.newaxis, :, :]
        distance = np.linalg.norm(delta, axis=-1)
        np.clip(distance, 0.01, None, out=distance)
        displacement = np.einsum("ijk,ij->ik", delta, (k * k / distance**2 - adj * distance / k))
        length = np.linalg.norm(displacement, axis=-1)
        length = np.clip(length, a_min=0.01, a_max=None)
        delta_pos = np.einsum("ij,i->ij", displacement, t / length)
        pos += delta_pos
        t -= dt
        if (np.linalg.norm(delta_pos) / n) < threshold:
            break

    pos -= pos.mean(axis=0)  # rescale_layout to scale 1, centred at 0
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= 1 / lim
    return dict(zip(nodes, pos))
