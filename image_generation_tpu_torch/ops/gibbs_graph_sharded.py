"""Graph-partitioned colored block-Gibbs: the coupling split over ranks.

Port of ``image_generation_tpu/ops/gibbs_graph_sharded.py``, for couplings
too large for one card.  The JAX body ran under ``shard_map``; here every
rank of the mesh's graph axis (``parallel/mesh.py``) calls these functions
on its own part:

  * spins    (C, L)        this rank's column window [g·L, (g+1)·L) of the
                           (C, n_pad) chains, L = n_pad / graph;
  * coupling (L, n_pad)    its row block: dense f32 or bf16, the int8 rows
                           of a ``QuantCoupling`` (with the whole matrix's
                           scale), or its packed panels
                           (``ops/block_sparse_sharded.py``);
  * fields   h (n_pad,)    replicated.

A color-class span [c0, c1) (``gibbs.class_spans``: a whole color class,
possibly several blocks wide) is updated at once:

    partial = S[:, own rows] @ A[own rows, c0:c1]      # torch.matmul
    total   = all_reduce(partial)                       # one collective
    K4: S[:, own columns ∩ [c0, c1)] = update(total (· scale) + h, β, u)

Every rank of the graph axis all-reduces the same span's products, and
K4 (``SpanWindowUpdate``, made once per call) forms the fields of the
columns the rank owns, draws their spins, adds their ΔE and writes them
into the rank's window in the carry's dtype, in one launch per (sweep,
span) where the rank owns columns and none where it owns none.  The
uniforms are fed (n_sweeps, C, n_pad) and read at global columns, or
drawn from K4's Philox stream keyed by one seed per call (drawn from a
generator seeded alike on every rank) with the counter (global column,
global row, sweep, 0): either way an owned window draws what the whole
span's update would draw for its columns.  The plain update
(``USE_PALLAS="off"``) forms the whole span's fields, draws every span's
uniforms from the generator (owned or not, as the JAX body does), and
writes its columns with plain slices.  The contraction
is split over the ranks, so each span's products divide evenly.  An int8
coupling's partial products are exact integers (±1 × int8 summed in f32
stays below 2²⁴), rounded to int32 and all-reduced in int32 as the JAX
package psums them, with one scale-out after the collective; the result
samples the quantized model bit for bit whatever the split.  Spins are
carried in the matmul dtype (int8 for an int8 coupling); a float matmul
reads them and the coupling as f32, so bf16 products accumulate in f32 and
come out f32.

With ``track_delta_e`` each rank sums fields·(new − old) over the columns
it owns (inside K4, or with plain ops) and one all-reduce at the end gives
every rank the run's energy change per chain, which parallel tempering
carries.

``ising_energies_graph_sharded`` computes E = h·s + ½ sᵀAs for (C, L) or
(T, C, L) spins: this rank's partial S@A over all n_pad columns,
all-reduced (where the JAX package used a reduce_scatter; gloo does not
take one on CUDA tensors, and the numbers are the same), its own columns
kept, and one all-reduce of the per-chain sums.  No rank ever holds an
(n_pad, n_pad) tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from image_generation_tpu_torch.ops.block_sparse_sharded import (
    ShardedBlockSparseCoupling,
    color_partial_fields,
)
from image_generation_tpu_torch.ops.gibbs import GibbsPlan, class_spans
from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "supports_graph_sharding",
    "gibbs_sweeps_graph_sharded",
    "ising_energies_graph_sharded",
    "plain_update",
]


def supports_graph_sharding(plan: GibbsPlan, mesh) -> bool:
    """The padded graph dimension must tile the mesh's graph axis."""
    return mesh is not None and plan.n_pad % mesh.graph == 0


def _is_quant(coupling) -> bool:
    return isinstance(coupling, QuantCoupling) or (
        isinstance(coupling, ShardedBlockSparseCoupling) and coupling.quantized)


def _check_layout(coupling, plan: Optional[GibbsPlan], mesh, l_loc: int) -> None:
    """Refuse a row block or packed layout cut for another mesh or plan."""
    if isinstance(coupling, ShardedBlockSparseCoupling):
        if coupling.n_shards != mesh.graph or coupling.shard != mesh.graph_index:
            raise ValueError(
                f"packed coupling was built for shard {coupling.shard} of "
                f"{coupling.n_shards}, this rank is {mesh.graph_index} of {mesh.graph}: "
                "rebuild the sampler cache for this mesh"
            )
        if plan is not None and coupling.plan is not plan:
            raise ValueError("plan/packed-coupling mismatch")
        return
    mat = coupling.q if isinstance(coupling, QuantCoupling) else coupling
    if mat.shape[0] != l_loc:
        raise ValueError(f"this rank's coupling rows must be {l_loc}, got {mat.shape[0]}")


def _dense_products(coupling, s_own: torch.Tensor, c0: int, c1: int,
                    matmul_dtype) -> torch.Tensor:
    """s_own (rows, L) @ this rank's A[:, c0:c1] in f32 (exact integers for
    int8)."""
    if isinstance(coupling, QuantCoupling):
        a = coupling.q[:, c0:c1]
    else:
        a = coupling[:, c0:c1]
        if matmul_dtype is not None:
            a = a.to(matmul_dtype)
    return s_own.to(torch.float32) @ a.to(torch.float32)


def _span_products(coupling, s_own, plan: GibbsPlan, span, matmul_dtype):
    """This rank's partial products of a whole class span, or None when no
    shard couples into any of its blocks (the same on every rank)."""
    start, stop, b0, b1 = span
    if not isinstance(coupling, ShardedBlockSparseCoupling):
        return _dense_products(coupling, s_own, start, stop, matmul_dtype)
    parts, any_occupied = [], False
    for c in range(b0, b1):
        f = color_partial_fields(coupling, s_own, c, matmul_dtype)
        if f is None:
            c0, _v, c1 = plan.blocks[c]
            f = s_own.new_zeros((s_own.shape[0], c1 - c0), dtype=torch.float32)
        else:
            any_occupied = True
        parts.append(f)
    if not any_occupied:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts, 1)


def _all_reduce_products(partial: torch.Tensor, coupling, mesh) -> torch.Tensor:
    """The all-reduced products: int8 partials (exact integers) go over
    the wire, and come back, as int32; K4 scales them out."""
    if _is_quant(coupling):
        return mesh.all_reduce(torch.round(partial).to(torch.int32))
    return mesh.all_reduce(partial)


def _scale_out(total: torch.Tensor, coupling) -> torch.Tensor:
    """All-reduced products in real units: int8 totals times the scale."""
    return total.to(torch.float32) * coupling.scale if _is_quant(coupling) else total


def _reduce_products(partial: torch.Tensor, coupling, mesh) -> torch.Tensor:
    """The all-reduced products in real units (scaled out after the
    collective)."""
    return _scale_out(_all_reduce_products(partial, coupling, mesh), coupling)


def plain_update(fields: torch.Tensor, beta_col, generator=None,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA update (``_xla_update``): ±1 in f32 with
    p(+1) = σ(−2β·fields), the uniforms fed or drawn from ``generator``."""
    p_plus = torch.sigmoid(-2.0 * beta_col * fields)
    if uniforms is None:
        gdev = generator.device if generator is not None else fields.device
        uniforms = torch.rand(fields.shape, generator=generator, device=gdev).to(fields.device)
    return torch.where(uniforms < p_plus, 1.0, -1.0)


def gibbs_sweeps_graph_sharded(
    hp: torch.Tensor,
    coupling_loc,
    plan: GibbsPlan,
    spins_loc: torch.Tensor,
    n_sweeps: int,
    mesh,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
    matmul_dtype=None,
    use_kernel: bool = True,
    row0: int = 0,
):
    """``n_sweeps`` colored block-Gibbs sweeps, one class span at a time,
    with the graph split over ``mesh``'s graph axis; every rank of it calls
    this with its own parts (module docstring).

    ``hp`` (n_pad,) f32; ``coupling_loc`` this rank's row block (dense,
    ``QuantCoupling`` or ``ShardedBlockSparseCoupling``); ``spins_loc``
    (C, n_pad / graph) its column window; ``beta`` scalar or (C,).
    ``uniforms``: optional (n_sweeps, C, n_pad) f32, the same on every
    rank, read at each span's global columns.  Without them, ``use_kernel``
    (``USE_PALLAS`` not "off") runs K4 on its Philox stream with one seed
    drawn from ``generator`` (seeded alike on every rank; without one,
    graph rank 0's seed is broadcast); otherwise the plain update draws
    each span's uniforms from ``generator``.  ``matmul_dtype`` rounds an f32 coupling
    to that dtype in the products and sets the spin carry's dtype.
    ``row0``: the global chain row of this rank's first row (its data
    row's slice of the chains), which keys K4's Philox counter.
    Returns this rank's new (C, L) f32 spins, or (spins, ΔE) with
    ``track_delta_e``, ΔE (C,) the same on every rank."""
    from image_generation_tpu_torch.ops.gibbs_cuda import draw_seed
    from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import SpanWindowUpdate

    if not supports_graph_sharding(plan, mesh):
        raise ValueError(
            f"n_pad={plan.n_pad} does not tile mesh axis 'graph'={getattr(mesh, 'graph', None)}"
        )
    lo, hi = mesh.window(plan.n_pad)
    c_loc, l_loc = spins_loc.shape
    if l_loc != hi - lo:
        raise ValueError(f"this rank's spins must have {hi - lo} columns, got {l_loc}")
    _check_layout(coupling_loc, plan, mesh, l_loc)
    if uniforms is not None and tuple(uniforms.shape) != (n_sweeps, c_loc, plan.n_pad):
        raise ValueError(f"uniforms must be {(n_sweeps, c_loc, plan.n_pad)}, "
                         f"got {tuple(uniforms.shape)}")
    dev = spins_loc.device
    quant = _is_quant(coupling_loc)
    carry = torch.int8 if quant else (matmul_dtype or spins_loc.dtype)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    beta_col = beta_t.reshape(-1, 1) if beta_t.ndim else beta_t
    seed = None
    if uniforms is None and generator is None:
        if not use_kernel:
            raise ValueError("the plain update draws from a generator seeded alike on every "
                             "rank: pass one (or fed uniforms)")
        # torch's default generator need not agree across ranks: rank 0's seed
        seed = mesh.broadcast(draw_seed(None, dev), src=0)
    elif use_kernel and uniforms is None:
        seed = draw_seed(generator, dev)
    s = spins_loc.to(carry).clone()
    de = torch.zeros(c_loc, dtype=torch.float32, device=dev)
    update = None
    if use_kernel:  # K4 over this rank's window, prepared once for the run
        update = SpanWindowUpdate(s, lo, beta_t, h=hp, scale=coupling_loc.scale if quant else None,
                                  uniforms=uniforms, seed=None if uniforms is not None else seed,
                                  row0=row0, delta_e=de if track_delta_e else None)
    spans = class_spans(plan)
    for sweep in range(n_sweeps):
        for span in spans:
            start, stop = span[0], span[1]
            partial = _span_products(coupling_loc, s, plan, span, matmul_dtype)
            if partial is not None:
                partial = _all_reduce_products(partial, coupling_loc, mesh)
            a, b = max(start, lo), min(stop, hi)  # this rank's columns of the span
            if update is not None:
                if a < b:
                    update(partial, start, stop, sweep)
                continue
            if partial is None:
                fields = hp[start:stop].expand(c_loc, stop - start).contiguous()
            else:
                fields = _scale_out(partial, coupling_loc) + hp[start:stop]
            u = None if uniforms is None else uniforms[sweep, :, start:stop]
            new = plain_update(fields, beta_col, generator, u)
            if a >= b:
                continue
            mine = new[:, a - start: b - start]
            if track_delta_e:
                old = s[:, a - lo: b - lo].to(torch.float32)
                de = de + (fields[:, a - start: b - start] * (mine - old)).sum(-1)
            s[:, a - lo: b - lo] = mine.to(carry)
    s = s.to(torch.float32)
    if track_delta_e:
        return s, mesh.all_reduce(de)
    return s


def ising_energies_graph_sharded(hp: torch.Tensor, coupling_loc, spins_loc: torch.Tensor,
                                 mesh, matmul_dtype=None) -> torch.Tensor:
    """E(s) = h·s + ½ sᵀAs for this rank's (..., n_pad / graph) spin
    columns, any number of leading dims ((C, L) chains or the (T, C, L)
    ladder); every rank gets the whole energies.  One all-reduce of the
    partial S@A and one of the per-chain sums."""
    l_loc = spins_loc.shape[-1]
    n_pad = l_loc * mesh.graph
    lo, hi = mesh.window(n_pad)
    _check_layout(coupling_loc, None, mesh, l_loc)
    lead = spins_loc.shape[:-1]
    flat = spins_loc.reshape(-1, l_loc).to(torch.float32)
    if isinstance(coupling_loc, ShardedBlockSparseCoupling):
        parts = []
        for c, (c0, _v, c1) in enumerate(coupling_loc.plan.blocks):
            f = color_partial_fields(coupling_loc, flat, c,
                                     None if coupling_loc.quantized else matmul_dtype)
            parts.append(flat.new_zeros((flat.shape[0], c1 - c0)) if f is None else f)
        partial = torch.cat(parts, 1)
    else:
        partial = _dense_products(coupling_loc, flat, 0, n_pad, matmul_dtype)
    sa_loc = _reduce_products(partial, coupling_loc, mesh)[:, lo:hi]
    e_part = flat @ hp[lo:hi] + 0.5 * (flat * sa_loc).sum(-1)
    return mesh.all_reduce(e_part).reshape(lead)
