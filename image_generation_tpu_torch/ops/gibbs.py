"""Colored block-Gibbs sampling for Ising models.

Port of ``image_generation_tpu/ops/gibbs.py``.  The host half (the plan)
is the same numpy code, so both packages put every spin at the same padded
position.  The tensor half builds the permuted model and holds
``gibbs_sweeps_reference``, the plain PyTorch version of the sweep kernel
(``ops/gibbs_cuda.py``).

Spins live in a color-permuted, padded coordinate system: each color block
of the plan is one contiguous column range, padded to ``pad_to``.  A color
update is

    fields = S @ A[:, c0:c1] + h[c0:c1]
    S[:, c0:c1] = where(u < σ(−2β·fields), +1, −1)

Padding slots have zero couplings and fields: they flip coins without
influencing anything and ``to_original`` drops them.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.utils.coloring import greedy_coloring

__all__ = [
    "GibbsPlan",
    "build_plan",
    "class_spans",
    "permuted_model",
    "random_spins",
    "to_original",
    "gibbs_sweeps_reference",
]


@dataclass(frozen=True, eq=False)
class GibbsPlan:
    """Static sampling plan: the color-permuted coordinate system.

    Attributes:
      n: number of real spins.
      n_pad: padded length (Σ per-block padded sizes).
      blocks: tuple of (start, valid_stop, padded_stop) per block.
      orig_to_perm: (n,) padded position of each original spin.
      perm_edge_i/j: (E,) edge endpoints in padded coordinates.
      valid_mask: (n_pad,) True at real-spin positions.
      block_class: per-block color-class id (None for hand-built plans).

    Compared and hashed by identity, like the JAX class.
    """

    n: int
    n_pad: int
    blocks: tuple
    orig_to_perm: np.ndarray
    perm_edge_i: np.ndarray
    perm_edge_j: np.ndarray
    valid_mask: np.ndarray
    block_class: Optional[tuple] = None

    @property
    def n_colors(self) -> int:
        return len(self.blocks)


# weak-keyed so that a server swapping models does not pin old plans
_class_spans_cache: "weakref.WeakKeyDictionary[GibbsPlan, tuple]" = (
    weakref.WeakKeyDictionary()
)


def class_spans(plan: GibbsPlan) -> tuple:
    """Maximal runs of consecutive blocks of the same color class, as
    (start, padded_stop, first_block, stop_block) tuples.  Plans without
    ``block_class`` give one span per block."""
    cached = _class_spans_cache.get(plan)
    if cached is not None:
        return cached
    bc = plan.block_class
    if bc is None:
        spans = tuple(
            (s, e, i, i + 1) for i, (s, _v, e) in enumerate(plan.blocks)
        )
    else:
        spans = []
        i, nb = 0, len(plan.blocks)
        while i < nb:
            j = i
            while j + 1 < nb and bc[j + 1] == bc[i]:
                j += 1
            spans.append((plan.blocks[i][0], plan.blocks[j][2], i, j + 1))
            i = j + 1
        spans = tuple(spans)
    _class_spans_cache[plan] = spans
    return spans


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bfs_order(graph: GRBMGraph) -> np.ndarray:
    """Deterministic BFS rank of every node (component by component from
    the lowest-index unvisited node, neighbors in ascending index order),
    so that graph-adjacent nodes sit at nearby padded positions."""
    n = graph.n
    src = np.concatenate([graph.edge_i, graph.edge_j])
    dst = np.concatenate([graph.edge_j, graph.edge_i])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n + 1))
    rank = np.full(n, -1, dtype=np.int32)
    nxt = 0
    queue: list[int] = []
    for root in range(n):
        if rank[root] >= 0:
            continue
        rank[root] = nxt
        nxt += 1
        queue.append(root)
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            for u in dst[starts[v] : starts[v + 1]]:
                if rank[u] < 0:
                    rank[u] = nxt
                    nxt += 1
                    queue.append(int(u))
        queue.clear()
    return rank


def build_plan(
    graph: GRBMGraph, pad_to: int = 128, max_class: Optional[int] = None
) -> GibbsPlan:
    """Color-permuted sampling plan, identical to the JAX ``build_plan``.

    ``pad_to`` rounds every block up to a multiple (128 is the TPU lane
    width the JAX package pads to, kept as the default so both packages
    build the same plan).  ``max_class`` caps the block width by splitting
    oversized color classes (default 512 up to 2048 spins, then 256, then
    128).
    """
    if max_class is None:
        n_ = graph.n
        max_class = 512 if n_ <= 2048 else (256 if n_ <= 4096 else 128)
    n = graph.n
    cc = greedy_coloring(n, graph.edge_i, graph.edge_j)
    n_colors = int(cc.max()) + 1 if n else 0
    raw_classes = [[] for _ in range(n_colors)]
    # members ordered by BFS rank, as in the JAX plan
    rank = _bfs_order(graph)
    for v in np.argsort(rank, kind="stable"):
        raw_classes[cc[int(v)]].append(int(v))
    classes = []
    block_class = []
    for ci, members in enumerate(raw_classes):
        for i in range(0, len(members), max_class):
            classes.append(members[i : i + max_class])
            block_class.append(ci)

    orig_to_perm = np.zeros(n, dtype=np.int32)
    blocks = []
    pos = 0
    for members in classes:
        start = pos
        for v in members:
            orig_to_perm[v] = pos
            pos += 1
        valid_stop = pos
        pos = _round_up(pos, pad_to) if pad_to > 1 else pos
        blocks.append((start, valid_stop, pos))
    n_pad = pos

    valid_mask = np.zeros(n_pad, dtype=bool)
    valid_mask[orig_to_perm] = True
    return GibbsPlan(
        n=n,
        n_pad=n_pad,
        blocks=tuple(blocks),
        orig_to_perm=orig_to_perm,
        perm_edge_i=orig_to_perm[graph.edge_i],
        perm_edge_j=orig_to_perm[graph.edge_j],
        valid_mask=valid_mask,
        block_class=tuple(block_class),
    )


def permuted_model(
    plan: GibbsPlan, h: torch.Tensor, quadratic: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h_p, A_p) in padded-permuted coordinates on ``h``'s device:
    (n_pad,) fields and the dense symmetric (n_pad, n_pad) coupling, zero
    at padding rows and columns."""
    dev = h.device
    ei = torch.as_tensor(plan.perm_edge_i, dtype=torch.long, device=dev)
    ej = torch.as_tensor(plan.perm_edge_j, dtype=torch.long, device=dev)
    q = quadratic.to(torch.float32)
    a = torch.zeros((plan.n_pad, plan.n_pad), dtype=torch.float32, device=dev)
    a.index_put_((ei, ej), q, accumulate=True)
    a.index_put_((ej, ei), q, accumulate=True)
    hp = torch.zeros(plan.n_pad, dtype=torch.float32, device=dev)
    hp[torch.as_tensor(plan.orig_to_perm, dtype=torch.long, device=dev)] = h.to(
        torch.float32
    )
    return hp, a


def random_spins(
    generator: Optional[torch.Generator], plan: GibbsPlan, n_chains: int,
    device=None,
) -> torch.Tensor:
    """Fresh ±1 chain state in padded coordinates: (n_chains, n_pad) f32,
    drawn on ``device`` (the generator's device by default)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    bits = torch.randint(
        0, 2, (n_chains, plan.n_pad), generator=generator, device=device,
        dtype=torch.float32,
    )
    return 2.0 * bits - 1.0


def to_original(plan: GibbsPlan, spins_p: torch.Tensor) -> torch.Tensor:
    """(…, n_pad) padded spins → (…, n) original spin order."""
    idx = torch.as_tensor(plan.orig_to_perm, dtype=torch.long, device=spins_p.device)
    return spins_p[..., idx]


def gibbs_sweeps_reference(
    hp: torch.Tensor,
    coupling_p: torch.Tensor,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``n_sweeps`` colored block-Gibbs sweeps in plain PyTorch.

    The twin of the sweep kernel, with the Pallas kernel's semantics
    (``gibbs_pallas.py`` ``_color_update``): one update per block of
    ``plan.blocks``, in order, padding columns included.

    ``beta``: scalar or (chains,) per-chain inverse temperature.
    ``uniforms``: optional (n_sweeps, chains, n_pad) f32, read at
    ``[sweep, :, c0:c1]`` as the fed kernel reads them.  Without it the
    uniforms are drawn from ``generator`` (on the generator's device).
    Returns new (chains, n_pad) f32 spins; the input is not modified.
    """
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    if uniforms is not None and tuple(uniforms.shape) != (n_sweeps, chains, n_pad):
        raise ValueError(
            f"uniforms must be {(n_sweeps, chains, n_pad)}, got {tuple(uniforms.shape)}"
        )
    dev = spins_p.device
    beta_col = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    beta_col = beta_col.reshape(-1, 1) if beta_col.ndim else beta_col
    s = spins_p.to(torch.float32).clone()
    for sweep in range(n_sweeps):
        for c0, _valid, c1 in plan.blocks:
            fields = s @ coupling_p[:, c0:c1] + hp[c0:c1]
            p_plus = torch.sigmoid(-2.0 * beta_col * fields)
            if uniforms is not None:
                u = uniforms[sweep, :, c0:c1]
            else:
                u = torch.rand(
                    (chains, c1 - c0), generator=generator,
                    device=generator.device if generator is not None else dev,
                ).to(dev)
            s[:, c0:c1] = torch.where(u < p_plus, 1.0, -1.0)
    return s
