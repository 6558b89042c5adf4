"""Greedy QPU-subgraph selection and logical relabelling.

Port of ``image_generation_tpu/utils/subgraph.py`` on the port's own
:class:`~image_generation_tpu_torch.utils.topology.Graph`.  The selection
is seeded with ``random.Random(seed)`` and consumes the same draws in the
same order as the JAX package; it depends on the graph's node and
neighbour iteration order and on the order ``subgraph(...).copy()`` and
the relabelling give, all of which ``Graph`` reproduces.  So one
(QPU, n_latents, seed) selects the same latent graph in both packages.
"""

from __future__ import annotations

import random
from typing import Optional

from image_generation_tpu_torch.utils.topology import Graph

__all__ = ["greedy_get_subgraph", "get_graph_mapping", "select_latent_graph"]


def greedy_get_subgraph(n_nodes: int, random_seed: Optional[int], graph: Graph) -> Graph:
    """Grow an ``n_nodes`` subgraph from a random seed node, adding at each
    step a random frontier node among those with the most edges into the
    selected set (capped at ``min(max_degree, |selected|)``)."""
    if n_nodes > graph.number_of_nodes():
        raise ValueError(
            f"requested {n_nodes} nodes from a graph with "
            f"{graph.number_of_nodes()} nodes"
        )
    if n_nodes == graph.number_of_nodes():
        return graph.copy()
    rng = random.Random(random_seed)
    nodes = graph.nodes()
    max_degree = max(graph.degree(n) for n in nodes)

    start = rng.choice(nodes)
    selected = {start}
    order = [start]
    connectivity: dict = {}  # frontier node → |neighbours ∩ selected|
    for nbr in graph.neighbors(start):
        connectivity[nbr] = 1

    while len(selected) < n_nodes:
        if not connectivity:
            rest = [n for n in nodes if n not in selected]
            nxt = rng.choice(rest)
        else:
            target = min(max_degree, len(selected))
            cap = min(max(connectivity.values()), target)
            candidates = [v for v, c in connectivity.items() if c >= cap]
            nxt = candidates[rng.randrange(len(candidates))]
        selected.add(nxt)
        order.append(nxt)
        connectivity.pop(nxt, None)
        for nbr in graph.neighbors(nxt):
            if nbr not in selected:
                connectivity[nbr] = connectivity.get(nbr, 0) + 1

    return graph.subgraph_copy(order)


def get_graph_mapping(graph: Graph):
    """Relabel physical ids to logical 0..n-1 in node order; returns the
    relabelled graph and the {physical: logical} mapping."""
    mapping = {physical: logical for logical, physical in enumerate(graph.nodes())}
    return graph.relabel(mapping), mapping


def select_latent_graph(full_graph: Graph, n_latents: int, random_seed: Optional[int]):
    """Greedy selection and relabelling: (logical graph, mapping)."""
    return get_graph_mapping(greedy_get_subgraph(n_latents, random_seed, full_graph))
