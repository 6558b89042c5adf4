"""On-disk cache of selected latent graphs.

Port of ``image_generation_tpu/utils/graph_cache.py``: the same npz layout
(``n``, ``edge_i``, ``edge_j``, ``physical``) and key, and the same
switches (``IMGGEN_CACHE_DIR`` names the directory, ``IMGGEN_NO_GRAPH_CACHE=1``
turns the cache off).  Without ``IMGGEN_CACHE_DIR`` the cache lives in this
package's own ``_cache/`` directory, beside ``_build/``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from image_generation_tpu_torch.models.grbm import GRBMGraph

__all__ = ["cached_latent_graph", "graph_from_topology"]


def _cache_dir() -> Path:
    d = os.environ.get("IMGGEN_CACHE_DIR")
    return Path(d) if d else Path(__file__).resolve().parent.parent / "_cache"


def graph_from_topology(graph) -> GRBMGraph:
    """A logical (0..n-1) topology graph → GRBMGraph, edges in ``edges()``
    order, each stored as (min, max)."""
    ei, ej = [], []
    for u, v in graph.edges():
        ei.append(min(u, v))
        ej.append(max(u, v))
    return GRBMGraph(n=graph.number_of_nodes(), edge_i=np.asarray(ei, np.int32),
                     edge_j=np.asarray(ej, np.int32))


def cached_latent_graph(qpu: str, n_latents: int,
                        random_seed: Optional[int]) -> Tuple[GRBMGraph, list]:
    """(GRBMGraph, physical_nodes) for a QPU / latent size / seed, from the
    cache or built and stored on a miss."""
    from image_generation_tpu_torch.utils.subgraph import select_latent_graph
    from image_generation_tpu_torch.utils.topology import graph_for_qpu

    path = _cache_dir() / f"{qpu}_{n_latents}_{random_seed}_v2.npz"
    use_cache = not os.environ.get("IMGGEN_NO_GRAPH_CACHE")
    if use_cache and path.exists():
        try:
            with np.load(path) as z:
                graph = GRBMGraph(n=int(z["n"]), edge_i=z["edge_i"], edge_j=z["edge_j"])
                return graph, z["physical"].tolist()
        except Exception:
            pass  # a corrupt entry is rebuilt

    latent, mapping = select_latent_graph(graph_for_qpu(qpu), n_latents, random_seed)
    graph = graph_from_topology(latent)
    physical = [None] * len(mapping)
    for phys, logical in mapping.items():
        physical[logical] = phys
    if use_cache:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(path, n=graph.n, edge_i=graph.edge_i, edge_j=graph.edge_j,
                                physical=np.asarray(physical, np.int64))
        except OSError:
            pass
    return graph, physical
