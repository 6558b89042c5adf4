"""Force-directed graph layout in numpy and scipy.

The JAX package draws a checkpoint without physical qubit coordinates with
``networkx.spring_layout(g, seed=0)``.  ``spring_layout`` is that call,
step for step, with networkx 3.6's own seeding, initial positions and
``rescale_layout``: under 500 nodes its ``method="force"``
(``_fruchterman_reingold``), so the positions agree with networkx's to
rounding; from 500 nodes its ``method="energy"``
(``_sparse_fruchterman_reingold`` → ``_energy_fruchterman_reingold``): the
Fruchterman-Reingold energy of the float32 sparse adjacency, with a
gravity term pulling each connected component's centroid to (0.5, 0.5),
minimised by scipy's L-BFGS-B for ``iterations`` iterations, so the
positions agree with networkx's to the optimiser's rounding.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spring_layout"]

FORCE_MAX_NODES = 499  # networkx's "auto" method is "force" below 500 nodes
_BATCH = 500  # the energy method's rows of the pairwise terms at a time


def spring_layout(graph, seed: int = 0, iterations: int = 50,
                  threshold: float = 1e-4) -> dict:
    """Fruchterman-Reingold positions of ``graph``'s nodes, centred and
    scaled so the largest coordinate magnitude is 1: {node: (x, y)}, in
    node order.  ``graph`` has networkx's ``nodes()`` / ``edges()``.  From
    500 nodes the energy method (the module docstring)."""
    nodes = list(graph.nodes())
    n = len(nodes)
    if n == 0:
        return {}
    if n == 1:
        return {nodes[0]: np.zeros(2)}
    index = {v: i for i, v in enumerate(nodes)}
    if n > FORCE_MAX_NODES:
        return _rescaled(nodes, _energy_layout(graph, index, seed, iterations, threshold))
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

    return _rescaled(nodes, pos)


def _rescaled(nodes, pos: np.ndarray) -> dict:
    """networkx's ``rescale_layout`` to scale 1, centred at 0."""
    pos -= pos.mean(axis=0)
    lim = np.abs(pos).max()
    if lim > 0:
        pos *= 1 / lim
    return dict(zip(nodes, pos))


def _energy_layout(graph, index: dict, seed: int, iterations: int, threshold: float,
                   gravity: float = 1.0) -> np.ndarray:
    """networkx's ``_energy_fruchterman_reingold`` from its
    ``_sparse_fruchterman_reingold`` start: (n, 2) positions."""
    from scipy import optimize, sparse
    from scipy.sparse import csgraph

    n = len(index)
    # to_scipy_sparse_array(G, dtype="f"): unit weights, both directions
    row = [index[u] for u, _v in graph.edges()]
    col = [index[v] for _u, v in graph.edges()]
    a = sparse.coo_array(([1] * (2 * len(row)), (row + col, col + row)), shape=(n, n),
                         dtype="f").asformat("csr")
    pos = np.asarray(np.random.RandomState(seed).rand(n, 2), dtype=a.dtype)
    k = np.sqrt(1.0 / n)  # the optimal distance between nodes
    a = np.abs(a.tocsr())
    a = (a + a.T) / 2
    n_components, labels = csgraph.connected_components(a, directed=False)
    bincount = np.bincount(labels)

    def cost(x):
        p = x.reshape((n, 2))
        grad = np.zeros((n, 2))
        total = 0.0
        for lo in range(0, n, _BATCH):
            hi = min(lo + _BATCH, n)
            delta = p[lo:hi, np.newaxis, :] - p[np.newaxis, :, :]
            distance2 = np.maximum(np.sum(delta * delta, axis=2), 1e-10)
            distance = np.sqrt(distance2)
            ad = a[lo:hi] * distance
            # attractive and repulsive forces, then their integrals
            grad[lo:hi] = 2 * np.einsum("ij,ijk->ik", ad / k - k**2 / distance2, delta)
            total += np.sum(ad * distance2) / (3 * k)
            total -= k**2 * np.sum(np.log(distance))
        # gravity from each component's centroid to (0.5, 0.5)
        centers = np.zeros((n_components, 2))
        np.add.at(centers, labels, p)
        delta0 = centers / bincount[:, np.newaxis] - 0.5
        grad += gravity * delta0[labels]
        total += gravity * 0.5 * np.sum(bincount * np.linalg.norm(delta0, axis=1) ** 2)
        return total, grad.ravel()

    options = {"maxiter": iterations, "gtol": threshold}
    return optimize.minimize(cost, pos.ravel(), method="L-BFGS-B", jac=True,
                             options=options).x.reshape((n, 2))
