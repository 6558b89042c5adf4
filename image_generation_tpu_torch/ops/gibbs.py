"""Colored block-Gibbs sampling for Ising models.

Port of ``image_generation_tpu/ops/gibbs.py``.  The host half (the plan)
is the same numpy code, so both packages put every spin at the same padded
position.  The tensor half builds the permuted model and holds the plain
sweeps (``gibbs_sweeps_reference`` with the XLA semantics,
``gibbs_sweeps_kernel_reference`` with the Pallas kernels', the twin of
the sweep kernel K1 in ``ops/gibbs_cuda.py``), ``ising_energies`` and
parallel tempering (``pt_round``, ``pt_sample``), which carries its ladder
energies across rounds through the sweep's ``track_delta_e`` mode.  The
sweep, the energies and parallel tempering take every form the cached
coupling is stored in: dense f32 or bf16, int8 (``ops/quant.py``) and
packed block-sparse panels (``ops/block_sparse.py``).

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
from image_generation_tpu_torch.ops.block_sparse import (
    BlockSparseCoupling,
    color_fields,
    ising_energies_block_sparse,
    panel_offsets,
)
from image_generation_tpu_torch.ops.quant import QuantCoupling
from image_generation_tpu_torch.utils.coloring import greedy_coloring

__all__ = [
    "GibbsPlan",
    "build_plan",
    "class_spans",
    "permuted_model",
    "permuted_model_rows",
    "random_spins",
    "to_original",
    "block_products",
    "sweep_blocks",
    "gibbs_sweeps_reference",
    "gibbs_sweeps_kernel_reference",
    "sweeps_in_kernel_units",
    "is_quantized",
    "ising_energies",
    "pt_round",
    "pt_sample",
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


def permuted_model_rows(
    plan: GibbsPlan, h: torch.Tensor, quadratic: torch.Tensor, lo: int, hi: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h_p, A_p[lo:hi]): ``permuted_model``'s fields and rows [lo, hi) of
    its coupling, built from the plan's edge list (``perm_edge_i/j``)
    without the whole matrix: a graph-sharded rank's row block.  Equal to
    the slice of ``permuted_model``'s coupling bit for bit."""
    dev = h.device
    ei = torch.as_tensor(plan.perm_edge_i, dtype=torch.long, device=dev)
    ej = torch.as_tensor(plan.perm_edge_j, dtype=torch.long, device=dev)
    q = quadratic.to(torch.float32)
    a = torch.zeros((hi - lo, plan.n_pad), dtype=torch.float32, device=dev)
    for rows, cols in ((ei, ej), (ej, ei)):
        own = (rows >= lo) & (rows < hi)
        a.index_put_((rows[own] - lo, cols[own]), q[own], accumulate=True)
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


def block_products(coupling_p, plan: GibbsPlan, scaled: bool = True):
    """``fn(s, b)``: the (chains, width) f32 products ``s @ A[:, c0:c1]``
    of color block ``b`` for every stored form of the coupling, or None
    for a block nothing couples into.

    f32 is the plain product.  bf16 is read as f32 (f32 accumulation of
    exact ±1 × bf16 products).  A ``QuantCoupling`` or int8 panels give
    the exact integer products (f32 holds them exactly below 2²⁴),
    multiplied by the scale unless ``scaled`` is False, which leaves them
    in the streaming kernel's quantized units.  A ``BlockSparseCoupling``
    reads only its packed chunk panels."""
    if isinstance(coupling_p, BlockSparseCoupling):
        if coupling_p.plan is not plan:
            raise ValueError("the packed coupling was cut for another plan")
        offs, _ = panel_offsets(plan, coupling_p.chunk)
        return lambda s, b: color_fields(coupling_p, s, b, offs, scaled)
    if isinstance(coupling_p, QuantCoupling):
        q, scale = coupling_p

        def quant(s, b):
            c0, _v, c1 = plan.blocks[b]
            f = s @ q[:, c0:c1].to(torch.float32)
            return f * scale if scaled else f

        return quant
    if coupling_p.dtype == torch.float32:
        return lambda s, b: s @ coupling_p[:, plan.blocks[b][0] : plan.blocks[b][2]]
    return lambda s, b: s @ coupling_p[:, plan.blocks[b][0] : plan.blocks[b][2]].to(
        torch.float32)


def sweep_blocks(hp: torch.Tensor, products, plan: GibbsPlan, spins_p: torch.Tensor,
                 n_sweeps: int, beta, generator: Optional[torch.Generator],
                 uniforms: Optional[torch.Tensor], track_delta_e: bool):
    """The colored sweep loop both plain versions share: per sweep, per
    block of ``plan.blocks`` in order, ``fields = products(s, b) + h``,
    then the Bernoulli update (and ΔE); see ``gibbs_sweeps_reference``."""
    chains, n_pad = spins_p.shape
    dev = spins_p.device
    beta_col = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    beta_col = beta_col.reshape(-1, 1) if beta_col.ndim else beta_col
    s = spins_p.to(torch.float32).clone()
    de = torch.zeros(chains, dtype=torch.float32, device=dev)
    for sweep in range(n_sweeps):
        for b, (c0, _valid, c1) in enumerate(plan.blocks):
            f = products(s, b)
            fields = hp[c0:c1].expand(chains, c1 - c0) if f is None else f + hp[c0:c1]
            p_plus = torch.sigmoid(-2.0 * beta_col * fields)
            if uniforms is not None:
                u = uniforms[sweep, :, c0:c1]
            else:
                u = torch.rand(
                    (chains, c1 - c0), generator=generator,
                    device=generator.device if generator is not None else dev,
                ).to(dev)
            new = torch.where(u < p_plus, 1.0, -1.0)
            if track_delta_e:
                de = de + (fields * (new - s[:, c0:c1])).sum(-1)
            s[:, c0:c1] = new
    return (s, de) if track_delta_e else s


def _check_uniforms(uniforms, n_sweeps: int, chains: int, n_pad: int) -> None:
    if uniforms is not None and tuple(uniforms.shape) != (n_sweeps, chains, n_pad):
        raise ValueError(
            f"uniforms must be {(n_sweeps, chains, n_pad)}, got {tuple(uniforms.shape)}"
        )


def is_quantized(coupling_p) -> bool:
    """Whether the stored coupling is int8: a ``QuantCoupling`` or int8
    block-sparse panels."""
    return isinstance(coupling_p, QuantCoupling) or (
        isinstance(coupling_p, BlockSparseCoupling) and coupling_p.quantized)


def sweeps_in_kernel_units(hp: torch.Tensor, coupling_p, plan: GibbsPlan,
                           spins_p: torch.Tensor, n_sweeps: int, beta,
                           generator: Optional[torch.Generator],
                           uniforms: Optional[torch.Tensor], track_delta_e: bool):
    """The sweep loop in the Pallas kernels' units: for an int8 coupling
    fields = exact integer products + h / scale, β · scale, and ΔE × scale
    at the end (``gibbs_sweeps_pallas`` L234-246, L290-297); every other
    form as ``gibbs_sweeps_reference``.  Shared by the plain versions of
    K1 (``gibbs_sweeps_kernel_reference``) and of K2 / K3."""
    quant = is_quantized(coupling_p)
    if quant:
        scale = coupling_p.scale
        hp = hp / scale
        beta = torch.as_tensor(beta, dtype=torch.float32, device=spins_p.device) * scale
    out = sweep_blocks(hp, block_products(coupling_p, plan, scaled=False), plan, spins_p,
                       n_sweeps, beta, generator, uniforms, track_delta_e)
    if track_delta_e and quant:
        return out[0], out[1] * scale
    return out


def gibbs_sweeps_kernel_reference(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
):
    """The dense plain version of the sweep kernel K1 in every mode, with
    the Pallas kernel's semantics (``gibbs_pallas.py`` ``_color_update``):
    the dense product the JAX package computes, which the tests and
    ``chip_smoke.py`` hold K1's kernel (the sparse field gather,
    ``ops/gibbs_cuda.py``) against.  Per block of ``plan.blocks`` in
    order, padding columns included; f32 and bf16 couplings as
    ``gibbs_sweeps_reference`` (a bf16 coupling read as f32: f32
    accumulation of exact ±1 × bf16 products), and a ``QuantCoupling`` in
    quantized units (``sweeps_in_kernel_units``).  Same arguments and
    returns as ``gibbs_sweeps_reference``."""
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    _check_uniforms(uniforms, n_sweeps, chains, n_pad)
    return sweeps_in_kernel_units(hp, coupling_p, plan, spins_p, n_sweeps, beta, generator,
                                  uniforms, track_delta_e)


def gibbs_sweeps_reference(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
):
    """``n_sweeps`` colored block-Gibbs sweeps in plain PyTorch, with the
    JAX package's XLA sweep semantics for every stored form of the
    coupling (bf16, a ``QuantCoupling``, a ``BlockSparseCoupling``):
    fields = products (× scale for int8) + h.  This is the sweep of
    ``USE_PALLAS="off"``, one update per block of ``plan.blocks``, in
    order, padding columns included (the Pallas kernel's order).  For an
    f32 or bf16 coupling it is also the twin of the sweep kernel K1; the
    twin of K1-int8, which works in quantized units, is
    ``gibbs_sweeps_kernel_reference``, and K2 / K3's is
    ``gibbs_hbm_cuda.gibbs_sweeps_hbm_reference``.

    ``beta``: scalar or (chains,) per-chain inverse temperature.
    ``uniforms``: optional (n_sweeps, chains, n_pad) f32, read at
    ``[sweep, :, c0:c1]`` as the fed kernel reads them.  Without it the
    uniforms are drawn from ``generator`` (on the generator's device).
    ``track_delta_e``: also return the (chains,) f32 energy change of the
    run, accumulated as the Pallas kernel's ``de_ref`` is: per block,
    ``Σ fields·(new − old)`` (fields include h, exclude β).
    Returns new (chains, n_pad) f32 spins, or (spins, delta_e); the input
    is not modified.
    """
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    _check_uniforms(uniforms, n_sweeps, chains, n_pad)
    return sweep_blocks(hp, block_products(coupling_p, plan), plan, spins_p, n_sweeps,
                        beta, generator, uniforms, track_delta_e)


def ising_energies(hp: torch.Tensor, coupling_p, spins_p: torch.Tensor) -> torch.Tensor:
    """E(s) = h·s + ½ sᵀ A s in padded coordinates for (..., n_pad) spins
    (padding contributes 0), for every stored form of the coupling: f32;
    bf16 with f32 accumulation; a ``QuantCoupling`` exactly in integers,
    scaled out once; a ``BlockSparseCoupling`` from its panels."""
    if isinstance(coupling_p, BlockSparseCoupling):
        return ising_energies_block_sparse(hp, coupling_p, spins_p)
    if isinstance(coupling_p, QuantCoupling):
        sa = (spins_p @ coupling_p.q.to(torch.float32)) * coupling_p.scale
    else:
        sa = spins_p @ coupling_p.to(torch.float32)
    return spins_p @ hp + 0.5 * (spins_p * sa).sum(-1)


def pt_round(
    generator: Optional[torch.Generator],
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    betas: torch.Tensor,
    sweeps_per_round: int,
    sweeps_fn=None,
    energies: Optional[torch.Tensor] = None,
    return_energies: bool = False,
    return_accept: bool = False,
    *,
    energies_fn=None,
    uniforms: Optional[torch.Tensor] = None,
    swap_uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    aux: Optional[dict] = None,
    ladder=None,
):
    """One parallel-tempering round: ``sweeps_per_round`` Gibbs sweeps at
    every temperature, then replica exchange between adjacent rungs (even
    pairs, then odd pairs), each chain column independently.

    ``spins_p`` (T, C, n_pad); ``betas`` (T,) ascending (``betas[-1]`` is
    the target).  ``sweeps_fn(generator, hp, coupling_p, chains, n_sweeps,
    beta, uniforms=, track_delta_e=)`` runs the sweeps on ``plan`` (the
    plain ``gibbs_sweeps_reference`` by default).  With carried ``energies``
    (T, C) the sweeps track ΔE and the swap energies are ``energies + ΔE``,
    so no energy product runs; without them the energies are computed once
    after the sweeps, by ``energies_fn(hp, coupling_p, spins)`` (default
    ``ising_energies``; graph-sharded training passes
    ``ising_energies_graph_sharded``, and ``spins_p`` is then a rank's
    column window).  Swaps permute the energies with the configurations.

    ``uniforms`` (sweeps, T·C, n_pad) and ``swap_uniforms`` (two (T−1, C)
    arrays, even pass then odd) replace the draws from ``generator``.

    ``aux``: optional dict of per-replica (T, C) payloads, permuted by the
    same accepted swaps (``pt_tune.round_trip_count``'s replica labels).

    ``ladder`` (``parallel.mesh.LadderShard``): the ladder is split over
    ranks, and ``spins_p``, ``energies``, ``aux`` and the returned spins and
    energies are this rank's rungs [t0, t1) (``uniforms`` its rows); the
    swap decisions come from the gathered energies, the same on every
    rank, and the rungs at the slice's edges are exchanged with the
    neighbouring ranks.

    Returns spins; ``(spins, energies)`` with ``return_energies``;
    ``(spins, energies, accept)`` with ``return_accept``, where ``accept``
    is the (T−1,) per-pair mean analytic acceptance E[min(1, e^{Δβ·ΔE})];
    with ``aux``, ``(spins, energies, aux[, accept])``.
    """
    t_dim, c_dim, n_pad = spins_p.shape
    dev = spins_p.device
    if sweeps_fn is None:
        def sweeps_fn(g, h_, c_, s_, n_, beta_, uniforms=None, track_delta_e=False):
            return gibbs_sweeps_reference(h_, c_, plan, s_, n_, beta_, generator=g,
                                          uniforms=uniforms, track_delta_e=track_delta_e)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=dev)
    t0, t1 = (0, t_dim) if ladder is None else (ladder.t0, ladder.t1)
    flat = spins_p.reshape(t_dim * c_dim, n_pad)
    beta_per_chain = betas[t0:t1].repeat_interleave(c_dim)
    if energies is not None:
        flat, de = sweeps_fn(generator, hp, coupling_p, flat, sweeps_per_round,
                             beta_per_chain, uniforms=uniforms, track_delta_e=True)
        e = energies + de.reshape(t_dim, c_dim)
    else:
        flat = sweeps_fn(generator, hp, coupling_p, flat, sweeps_per_round,
                         beta_per_chain, uniforms=uniforms)
    s = flat.reshape(t_dim, c_dim, n_pad)
    if energies is None:
        e = (energies_fn or ising_energies)(hp, coupling_p, s)
    if ladder is not None:
        e = ladder.gather(e)
        t_dim = ladder.t_dim

    d_beta = (betas[:-1] - betas[1:])[:, None]
    pairs = torch.arange(t_dim - 1, device=dev) % 2
    pad = torch.zeros((1, c_dim), dtype=torch.bool, device=dev)
    acc = torch.zeros(t_dim - 1, dtype=torch.float32, device=dev)
    for parity in (0, 1):
        delta = d_beta * (e[:-1] - e[1:])  # (T−1, C)
        if swap_uniforms is not None:
            u = swap_uniforms[parity]
        else:
            u = torch.rand(delta.shape, generator=generator, device=dev)
        pair_mask = (pairs == parity)[:, None]
        accept = (torch.log(u) < delta) & pair_mask
        acc = acc + (torch.clamp(torch.exp(delta), max=1.0) * pair_mask).mean(1)
        swap_next = torch.cat([accept, pad], 0)  # row t ↔ t+1
        swap_prev = torch.cat([pad, accept], 0)  # row t ↔ t−1

        def permute(x, rungs, up=None, down=None):
            """The rows of x (rungs [a, b) of the ladder) after the swaps;
            ``up`` / ``down`` are rungs b and a − 1 where they lie on other
            ranks (on one device ``torch.roll`` brings them in)."""
            a, b = rungs
            m_next = swap_next[a:b].reshape((b - a, c_dim) + (1,) * (x.ndim - 2))
            m_prev = swap_prev[a:b].reshape(m_next.shape)
            nxt = torch.cat([x[1:], x[:1] if up is None else up[None]], 0)
            prv = torch.cat([x[-1:] if down is None else down[None], x[:-1]], 0)
            return torch.where(m_next, nxt, torch.where(m_prev, prv, x))

        e = permute(e, (0, t_dim))
        if ladder is None:
            s = permute(s, (0, t_dim))
            if aux is not None:
                aux = {k: permute(v, (0, t_dim)) for k, v in aux.items()}
        else:
            s = permute(s, (t0, t1), *ladder.neighbours(s, parity))
            if aux is not None:
                aux = {k: permute(v, (t0, t1), *ladder.neighbours(v, parity))
                       for k, v in aux.items()}
    e = e[t0:t1]
    if aux is not None:
        return (s, e, aux, acc) if return_accept else (s, e, aux)
    if return_accept:
        return s, e, acc
    return (s, e) if return_energies else s


def pt_sample(
    generator: Optional[torch.Generator],
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    n_chains: int,
    betas: torch.Tensor,
    n_rounds: int,
    sweeps_per_round: int,
    init_spins: Optional[torch.Tensor] = None,
    sweeps_fn=None,
    energies_fn=None,
    feed=None,
    ladder=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A full parallel-tempering run from optional ``init_spins``
    (T, C, n_pad): the ladder energies are computed once (by
    ``energies_fn``, as in ``pt_round``) and carried through every round.
    ``feed``: one (sweep uniforms, (even, odd) swap uniforms) pair per
    round, replacing that round's draws (``pt_round``'s ``uniforms`` and
    ``swap_uniforms``).  ``ladder``: the ladder is split over ranks
    (``pt_round``), ``init_spins`` is this rank's rungs and so is the
    returned ladder.  Returns ((C, n_pad) samples at ``betas[-1]``, the
    (T, C, n_pad) ladder)."""
    t_dim = int(torch.as_tensor(betas).shape[0])
    if init_spins is None:
        init_spins = random_spins(generator, plan, t_dim * n_chains, hp.device).reshape(
            t_dim, n_chains, plan.n_pad
        )
    s, e = init_spins, (energies_fn or ising_energies)(hp, coupling_p, init_spins)
    for i in range(n_rounds):
        u, w = (None, None) if feed is None else feed[i]
        s, e = pt_round(generator, hp, coupling_p, plan, s, betas, sweeps_per_round,
                        sweeps_fn=sweeps_fn, energies=e, return_energies=True,
                        energies_fn=energies_fn, uniforms=u, swap_uniforms=w, ladder=ladder)
    return (s[-1] if ladder is None else ladder.target(s)), s
