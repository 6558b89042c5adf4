"""The DVAE+GRBM training step and the sampler functions.

Port of ``image_generation_tpu/training/step.py``.  ``make_sample_fns``
builds what generation and serving need (the scaled, clipped, permuted
sampler model, the sweep dispatch, ``sample_fn``); ``make_train_fns``
adds the training step on top:

  1. negative phase #1: refresh the persistent chains under the cached
     sampler model (plain Gibbs, or one parallel-tempering round whose
     ladder energies are carried across steps through the sweep's ΔE);
  2. DVAE forward with R replicas (BatchNorm batch statistics,
     Dropout2d, stochastic straight-through spins), MSE + MMD, backward
     and an Adam(+L2) update at the scheduled LR;
  3. on scheduled steps (epoch < 6 and step % 10 == 0): negative phase
     #2, the closed-form NLL gradient and an Adam(+L2) update of the
     GRBM, then the sampler model and the ladder energies are rebuilt.

JAX's ``lax.cond`` on the GRBM schedule is a Python ``if`` on host
integers; its scanned epoch is a Python loop that keeps each step's
metrics on the device and stacks them once at the end.  The train state
is updated in place (modules, optimizers, tensors) instead of being
returned anew, which keeps one copy of it.

Dispatch (``SampleFns``): the JAX package's single-device choice between
the on-chip sweep kernel K1 (``ops/gibbs_cuda.py``, with an f32, bf16 or
int8 coupling) and the streaming kernels K2 / K3
(``ops/gibbs_hbm_cuda.py``), each with its ΔE mode under parallel
tempering.  A CUDA tensor launches the kernel, a CPU tensor runs its plain
version (for K1, K2 and K3 alike the sparse field gather's,
``gibbs_sweeps_sparse_reference``: the Pallas kernels' quantized units for
int8); ``USE_PALLAS="off"``
selects the plain XLA-semantics ``gibbs_sweeps_reference`` everywhere.

Graph sharding (``GRAPH_SHARDED``, the JAX dispatch of
``training/step.py:280-425``): given a ``Mesh`` (``parallel/mesh.py``)
whose graph axis tiles n_pad, every rank runs these functions on its own
part.  It builds only its row block of the cached coupling (quantized
with the whole matrix's scale, or cast, then packed on its shard-local
grid), holds its column window of the chains, sweeps through
``ops/gibbs_graph_sharded.py`` (one all-reduce per class span, the update
in kernel K4), computes ladder energies there too, and all-gathers the
target rung's columns where the loss and the NLL statistics read the
samples.  The DVAE (but for an outsized dense layer, below), the GRBM and
their optimizers are replicated: every rank computes the same step from
the same draws.

The data axis (``parallel/mesh.py``): on a mesh that does not graph-shard,
each rank sweeps its own chain rows through the kernel (the JAX
chain-sharded kernels) and the PT ladder's rungs are split over the ranks;
each data row trains on its slice of the batch, and the step reproduces
by hand what GSPMD gives the JAX step: BatchNorm, the MSE and the MMD
over the global batch, and the DVAE gradient summed over the data axis.

On every mesh of more than one rank, graph-sharded or not, an outsized
DVAE dense layer (the scaled config's Linear(5640 → 22560)) is
column-sharded over the whole mesh with its optimizer moments
(``parallel/dense.py``, the JAX ``_shard_large_dense``): its product
gathers what it needs inside the layer, and its weight's gradient is
whole on each rank, so the data axis's all-reduce leaves it out.

The DVAE's optimizer is ``torch.optim.Adam`` unless ``ADAM_MOMENT_DTYPE``
or ``ADAM_FACTORED_NU`` asks for ``training/optim.py``'s ``AdamMoments``.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.torch_pth import dvae_state_dict_from_jax
from image_generation_tpu_torch.models.batchnorm import global_batch_stats
from image_generation_tpu_torch.models.decoder import draw_dropout_masks
from image_generation_tpu_torch.models.dvae import DVAE, gumbel_uniforms
from image_generation_tpu_torch.models.grbm import (
    GRBMGraph,
    GRBMParams,
    nll_grads,
    nll_value,
    scaled_ising,
)
from image_generation_tpu_torch.ops.gibbs import (
    GibbsPlan,
    build_plan,
    gibbs_sweeps_reference,
    ising_energies,
    permuted_model,
    permuted_model_rows,
    pt_round,
    pt_sample,
    random_spins,
    to_original,
)
from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling, pack_coupling
from image_generation_tpu_torch.ops.gibbs_cuda import gibbs_sweeps_cuda, selects_k1
from image_generation_tpu_torch.ops.gibbs_hbm_cuda import gibbs_sweeps_hbm_cuda
from image_generation_tpu_torch.ops.mmd import GaussianKernel, mmd_loss
from image_generation_tpu_torch.ops.quant import quantize_coupling
from image_generation_tpu_torch.parallel.dense import (
    DENSE_MIN_ELEMS,
    rows_split_over_data,
    shard_large_dense,
)
from image_generation_tpu_torch.parallel.mesh import (
    AllGatherRows,
    AllReduceSum,
    shard_batch,
    shard_epoch_batches,
)
from image_generation_tpu_torch.training.observability import span
from image_generation_tpu_torch.training.schedules import geomspace_lr
from image_generation_tpu_torch.utils.device import resolve_device

__all__ = [
    "SampleFns",
    "make_sample_fns",
    "StepFeed",
    "StepMetrics",
    "TrainState",
    "TrainStepFns",
    "make_train_fns",
    "train_state_from_jax",
]

_ADAM = dict(betas=(0.9, 0.999), eps=1e-8)  # optax.scale_by_adam's defaults
# ADAM_FACTORED_NU="on" factors the second moment of 2-D DVAE parameters
# with at least this many elements (training/optim.py FactoredNu): only the
# scaled config's 127M dense layer.  Module-level so tests can lower it.
_FACTORED_NU_MIN = 1 << 22


@dataclass
class TrainState:
    """Everything one training step reads and updates.

    ``dvae`` holds the DVAE parameters and BatchNorm running statistics;
    the optimizers hold the Adam moments.  ``chains`` are the persistent
    chains, (NUM_READS, n_pad) or under parallel tempering the
    (T, NUM_READS, n_pad) ladder, with ``chain_energies`` (T, C) carried
    under the cached sampler model ((0,) otherwise).  ``sampler_h`` /
    ``sampler_coupling`` cache the permuted model of ``grbm_params``.
    ``sampler_coupling`` is stored as the dispatch reads it: an f32 or
    bf16 tensor, a ``QuantCoupling`` or a ``BlockSparseCoupling``.
    ``opt_step`` is a host integer; ``generator`` draws every random
    number of the step on the state's device.  ``pt_betas`` is the live
    (T,) ladder ((0,) outside PT)."""

    dvae: DVAE
    grbm_params: GRBMParams
    dvae_opt: torch.optim.Optimizer  # Adam, or AdamMoments (training/optim.py)
    grbm_opt: torch.optim.Adam
    chains: torch.Tensor
    chain_energies: torch.Tensor
    sampler_h: torch.Tensor
    sampler_coupling: object
    opt_step: int
    generator: torch.Generator
    pt_betas: torch.Tensor


@dataclass
class StepMetrics:
    """One step's metrics, as device tensors (no host sync)."""

    mse: torch.Tensor
    mmd: torch.Tensor
    dvae_loss: torch.Tensor
    nll: torch.Tensor
    grbm_trained: torch.Tensor
    pt_accept: torch.Tensor  # (T-1,) under PT, (0,) otherwise


@dataclass
class StepFeed:
    """Random numbers fed to one step in place of the generator's draws
    (the parity tests replay the JAX package's draws through it).

    ``sweeps1`` / ``sweeps2``: (GIBBS_SWEEPS, chains, n_pad) uniforms of
    negative phases #1 and #2; ``swaps1`` / ``swaps2``: the PT swap
    uniforms (even, odd), each (T−1, C); ``spin_uniforms``: (B, R, n)
    (in the gumbel mode already mapped into (1e-6, 1 − 1e-6), the JAX
    draw); ``dropout_masks``: four (B·R, C) multipliers; ``fresh_chains``:
    the restart chains of ``PERSISTENT_CHAINS=False``.  On a mesh every
    field covers the whole batch and the whole chains; each rank takes its
    part."""

    sweeps1: Optional[torch.Tensor] = None
    swaps1: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    sweeps2: Optional[torch.Tensor] = None
    swaps2: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    spin_uniforms: Optional[torch.Tensor] = None
    dropout_masks: Optional[Sequence[torch.Tensor]] = None
    fresh_chains: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class RowShard:
    """How the chain rows a sweep is given are split: over the mesh
    ``axes`` (a ``chain_row_axes`` value) in ``n`` equal slices, this rank
    holding slice ``index``."""

    axes: tuple = ()
    n: int = 1
    index: int = 0


_WHOLE = RowShard()


def fold_generator(generator: Optional[torch.Generator], index: int):
    """A generator of this rank's own stream: seeded from ``generator``'s
    state and ``index`` (the rank's slice of the chain rows), the JAX
    ``fold_in`` of the mesh index.  ``generator`` advances by one draw, the
    same on every rank, and is read on the host (no device sync)."""
    import hashlib

    if generator is None:
        return None
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(index).to_bytes(8, "little"), digest_size=8).digest()
    torch.randint(0, 2, (1,), generator=generator, device=generator.device)
    g = torch.Generator(device=generator.device)
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


class SampleFns:
    """Sampler functions bound to one (config, graph, plan, device).

    The dispatch is the JAX package's (``training/step.py``
    ``make_train_fns``): the cached coupling is stored int8
    (``SAMPLER_MATMUL_DTYPE="int8"``), in the resolved matmul dtype (bf16
    from n_pad 2048 under "auto") or f32, then packed into block-sparse
    panels where ``resolved_block_sparse`` holds.  The on-chip kernel K1
    takes a call when ``selects_k1`` (the JAX VMEM gate, on the effective
    chain count T·C at build time and again per call) holds and the
    coupling is not packed; the streaming kernels K2 (dense) and K3
    (packed) take the rest.  ``sampler_impl`` names the choice as the JAX
    package does, ``pallas`` spelled ``cuda``: ``cuda_vmem``, ``cuda_hbm``,
    ``torch`` (``USE_PALLAS="off"``, the JAX ``xla``), with ``+int8`` and
    ``+bs``.  It names the dispatch on either device: on the CPU each
    wrapper runs its kernel's plain version.

    On a ``mesh`` of more than one rank the JAX package's rules apply.
    Graph sharding: ``GRAPH_SHARDED`` "on", or "auto" with a resident
    coupling over 2 GiB, on a graph axis of size > 1 that tiles n_pad
    (``ValueError`` for "on" without one); ``sampler_impl`` is then
    ``torch_graph_sharded`` (the JAX ``xla_graph_sharded``), ``+plrng``
    (``+plrng_rs`` under ``PLRNG_ROW_SEED``) when the update runs in K4,
    then ``+int8`` and ``+bs``; block sparsity is decided on the padded
    per-shard occupancy.  Otherwise the chains are sharded (the JAX
    ``gibbs_sweeps_pallas_sharded``): each rank sweeps its own chain rows
    through the kernel with the model replicated and no communication,
    its Philox seed folded with its slice index (``fold_generator``), fed
    uniforms cut to its rows; ``sampler_impl`` gains ``_sharded``.  The
    kernel is chosen on the global chain count.  Where the JAX package
    drops to its XLA sweep because the chains do not tile the mesh (a
    call's count, or at build time the training count, and
    ``sampler_impl`` is then ``torch`` as JAX names it ``xla``), each rank
    still runs the gather kernel on its rows, at exactly the sweeps asked
    for as the XLA sweep does (``gibbs_sweeps_cuda``, or
    ``gibbs_sweeps_hbm_cuda(round_up=False)`` on packed panels).

    Under either the chains' leading axis (NUM_READS, or the ladder's T)
    is split over ``chain_row_axes``; the PT ladder's replica exchange
    then crosses ranks at the slices' edges (``parallel.mesh.LadderShard``).

    ``SampleFns.sampler_model`` counts, over every instance, the sampler
    models built (``"builds"``) and the bytes of their stored couplings
    (``"bytes"``; on a mesh this rank's part), as the launch counters
    count launches.  ``sample_fn`` builds one a call, inside the device
    span ``sampler.build`` (ids ``n_pad`` and ``form``, the stored form:
    ``int8``, ``bf16`` or ``f32``, with ``+bs`` when packed)."""

    sampler_model = collections.Counter()

    def __init__(self, cfg: TrainingConfig, graph: GRBMGraph, plan: GibbsPlan, device,
                 mesh=None):
        if cfg.SAMPLER == "pt" and isinstance(cfg.PT_NUM_BETAS, str):
            raise ValueError(
                "PT_NUM_BETAS='auto' must be resolved to a concrete ladder before the "
                "sampler functions are built: the Trainer does this at train_init/load "
                "(Trainer._resolve_auto_ladder); direct callers pass an explicit "
                "PT_NUM_BETAS or PT_BETAS"
            )
        self.config = cfg
        self.graph = graph
        self.plan = plan
        self.device = torch.device(device)
        self.use_kernel = cfg.USE_PALLAS != "off"
        self.pt_mode = cfg.SAMPLER == "pt"
        self.betas0 = (
            torch.tensor(cfg.initial_pt_betas(), dtype=torch.float32, device=self.device)
            if self.pt_mode else None
        )
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.int8 = cfg.SAMPLER_MATMUL_DTYPE == "int8"
        self.mm_dtype = cfg.resolved_sampler_matmul_dtype(plan.n_pad)
        # the resident coupling's itemsize, which the K1 gate and the
        # graph-sharded auto gate size against
        self.coupling_itemsize = 1 if self.int8 else (2 if self.mm_dtype is not None else 4)
        eff_chains = cfg.PT_NUM_BETAS * cfg.NUM_READS if self.pt_mode else cfg.NUM_READS
        self.graph_sharded = self._graph_sharded(cfg, plan, self.mesh)
        self.train_rows = self.row_shard(cfg.PT_NUM_BETAS if self.pt_mode else cfg.NUM_READS)
        # on a mesh the kernel runs per rank on chains that tile it (the JAX
        # shard_map wrapper); otherwise the counterpart of JAX's XLA sweep
        self.chain_sharded = (self.mesh is not None and not self.graph_sharded
                              and eff_chains % self.mesh.size == 0)
        self.block_sparse = cfg.resolved_block_sparse(plan)
        if self.block_sparse and self.graph_sharded:
            self.block_sparse = self._sharded_block_sparse(cfg, plan, self.mesh.graph)
        # the packed form replaces the dense cache K1 reads: block-sparse
        # wins and the sweep streams the panels (K3)
        self.vmem = (not self.graph_sharded and not self.block_sparse
                     and selects_k1(plan, eff_chains, self.coupling_itemsize))
        if self.graph_sharded:
            impl = "torch_graph_sharded" + (
                ("+plrng_rs" if cfg.PLRNG_ROW_SEED == "on" else "+plrng")
                if self.use_kernel else "")
        elif self.use_kernel and (self.mesh is None or self.chain_sharded):
            impl = ("cuda_vmem" if self.vmem else "cuda_hbm") + (
                "_sharded" if self.chain_sharded else "")
        else:
            impl = "torch"
        self.sampler_impl = impl + ("+int8" if self.int8 else "") + (
            "+bs" if self.block_sparse else "")
        self.stored_form = ("int8" if self.int8 else
                            "bf16" if self.mm_dtype is not None else "f32") + (
            "+bs" if self.block_sparse else "")

    def _graph_sharded(self, cfg: TrainingConfig, plan: GibbsPlan, mesh) -> bool:
        """The JAX gate: whether the coupling rows and spin columns are
        split over the mesh's graph axis."""
        sharded_ctx = mesh is not None
        tiles = sharded_ctx and mesh.graph > 1 and plan.n_pad % mesh.graph == 0
        if cfg.GRAPH_SHARDED == "on" and not tiles:
            where = (
                f"the mesh 'graph' axis ({mesh.graph}) cannot partition n_pad={plan.n_pad}: "
                f"it must have size > 1 and divide n_pad"
                if sharded_ctx else "there is no multi-device mesh to partition over"
            )
            raise ValueError(
                f"GRAPH_SHARDED='on' but {where}. Provide a mesh whose 'graph' axis fits "
                f"(create_mesh(shape=(1, graph))) or use GRAPH_SHARDED='off'."
            )
        return tiles and (cfg.GRAPH_SHARDED == "on" or (
            cfg.GRAPH_SHARDED == "auto"
            and plan.n_pad * plan.n_pad * self.coupling_itemsize > (2 << 30)))

    @staticmethod
    def _sharded_block_sparse(cfg: TrainingConfig, plan: GibbsPlan, n_shards: int) -> bool:
        """Block sparsity on the shard-local grid: the chunk must fit a row
        shard ("on" raises otherwise), and "auto" asks for a padded
        per-shard occupancy of at most 0.75."""
        from image_generation_tpu_torch.ops.block_sparse_sharded import (
            sharded_chunk_meta,
            supports_sharded_block_sparse,
        )

        chunk = cfg.SWEEP_BS_CHUNK
        if not supports_sharded_block_sparse(plan, n_shards, chunk):
            if cfg.SWEEP_BLOCK_SPARSE == "on":
                raise ValueError(
                    f"SWEEP_BLOCK_SPARSE='on' under GRAPH_SHARDED, but chunk={chunk} does "
                    f"not fit the {n_shards}-way row shard of n_pad={plan.n_pad} "
                    f"(= {plan.n_pad // n_shards} rows/shard). Lower SWEEP_BS_CHUNK or the "
                    f"graph-axis size, or use SWEEP_BLOCK_SPARSE='auto'."
                )
            return False
        if cfg.SWEEP_BLOCK_SPARSE == "auto":
            return sharded_chunk_meta(plan, n_shards, chunk).occupancy <= 0.75
        return True

    def row_shard(self, rows: int) -> RowShard:
        """The split of ``rows`` chain rows over this mesh
        (``chain_row_axes``)."""
        if self.mesh is None:
            return _WHOLE
        from image_generation_tpu_torch.parallel.mesh import chain_row_axes

        axes = chain_row_axes(rows, self.mesh, self.graph_sharded)
        _, n, index = self.mesh.axis(axes)
        return RowShard(axes, n, index)

    def local(self, spins: torch.Tensor, rows: Optional[RowShard] = None) -> torch.Tensor:
        """This rank's part of whole (rows, ..., n_pad) spins: its slice of
        the leading axis (``rows``, the training chains' split by default)
        and under graph sharding its column window."""
        rows = self.train_rows if rows is None else rows
        if rows.n > 1:
            per = spins.shape[0] // rows.n
            spins = spins[rows.index * per:(rows.index + 1) * per]
        if self.graph_sharded and spins.shape[-1] == self.plan.n_pad:
            lo, hi = self.mesh.window(self.plan.n_pad)
            spins = spins[..., lo:hi]
        return spins.contiguous()

    def unlocal(self, part: torch.Tensor, rows: Optional[RowShard] = None,
                columns: bool = True) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` part (collective):
        the ranks' slices of the leading axis gathered, and under graph
        sharding (with ``columns``) their column windows."""
        rows = self.train_rows if rows is None else rows
        if columns and self.graph_sharded:
            part = self.mesh.all_gather(part, dim=-1)
        if rows.n > 1:
            part = self.mesh.all_gather(part, dim=0, axis=rows.axes)
        return part

    def ladder(self, rows: RowShard, t_dim: int):
        """The PT ladder's split (``parallel.mesh.LadderShard``), or None
        when this rank holds every rung."""
        if rows.n == 1:
            return None
        from image_generation_tpu_torch.parallel.mesh import LadderShard

        return LadderShard(self.mesh, rows.axes, t_dim)

    def build_sampler_model(self, grbm_params: GRBMParams):
        """(hp, coupling_p) of the prefactor-scaled, range-clipped model in
        padded, color-permuted coordinates, the coupling stored as the
        dispatch reads it: quantized, then cast, then packed (the JAX
        order).  Under graph sharding: this rank's row block only, quantized
        at the whole matrix's scale, packed on its shard-local grid."""
        hp, coupling_p = self._build_sampler_model(grbm_params)
        SampleFns.sampler_model["builds"] += 1
        SampleFns.sampler_model["bytes"] += _stored_bytes(coupling_p)
        return hp, coupling_p

    def _build_sampler_model(self, grbm_params: GRBMParams):
        cfg = self.config
        h, j = scaled_ising(grbm_params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE)
        if self.graph_sharded:
            from image_generation_tpu_torch.ops.block_sparse_sharded import (
                pack_coupling_graph_sharded,
            )

            hp, coupling_p = permuted_model_rows(self.plan, h, j,
                                                 *self.mesh.window(self.plan.n_pad))
            if self.int8:
                coupling_p = quantize_coupling(coupling_p, mesh=self.mesh)
            elif self.mm_dtype is not None:
                coupling_p = coupling_p.to(self.mm_dtype)
            if self.block_sparse:
                coupling_p = pack_coupling_graph_sharded(self.plan, coupling_p, self.mesh,
                                                         cfg.SWEEP_BS_CHUNK)
            return hp, coupling_p
        hp, coupling_p = permuted_model(self.plan, h, j)
        if self.int8:
            coupling_p = quantize_coupling(coupling_p)
        elif self.mm_dtype is not None:
            coupling_p = coupling_p.to(self.mm_dtype)
        if self.block_sparse:
            coupling_p = pack_coupling(self.plan, coupling_p, cfg.SWEEP_BS_CHUNK)
        return hp, coupling_p

    def sweeps_fn(self, generator, hp, coupling_p, chains, n_sweeps, beta=1.0,
                  uniforms=None, track_delta_e=False, rows: RowShard = _WHOLE):
        """One sweep run of ``chains`` (C, n_pad) under (hp, coupling_p);
        returns spins, or (spins, ΔE) with ``track_delta_e``.  ``rows``:
        how ``chains`` are split over the mesh (whole on every rank by
        default).  The K1 gate is checked again per call, on this call's
        global chain count (a serving call folds coalesced requests into
        the chains).  Fed ``uniforms`` may cover the global rows, and are
        then cut to this rank's."""
        n_rows = chains.shape[0]
        if (uniforms is not None and rows.n > 1
                and uniforms.shape[1] == n_rows * rows.n):
            uniforms = uniforms[:, rows.index * n_rows:(rows.index + 1) * n_rows].contiguous()
        kw = dict(generator=generator, uniforms=uniforms, track_delta_e=track_delta_e)
        args = (hp, coupling_p, self.plan, chains, n_sweeps, beta)
        if self.graph_sharded:
            from image_generation_tpu_torch.ops.gibbs_graph_sharded import (
                gibbs_sweeps_graph_sharded,
            )

            if rows.n > 1 and uniforms is None and not self.use_kernel:
                kw["generator"] = fold_generator(generator, rows.index)
            return gibbs_sweeps_graph_sharded(*args[:5], self.mesh, beta, **kw,
                                              matmul_dtype=self.mm_dtype,
                                              use_kernel=self.use_kernel,
                                              row0=rows.index * n_rows)
        if rows.n > 1 and uniforms is None:
            kw["generator"] = fold_generator(generator, rows.index)
        n_global = n_rows * rows.n
        if not self.use_kernel:
            return gibbs_sweeps_reference(*args, **kw)
        if self.mesh is not None and (not self.chain_sharded or n_global % self.mesh.size):
            # JAX's XLA sweep: exactly n_sweeps on any stored form
            if isinstance(coupling_p, BlockSparseCoupling):
                return gibbs_sweeps_hbm_cuda(*args, **kw, round_up=False)
            return gibbs_sweeps_cuda(*args, **kw)
        if self.vmem and selects_k1(self.plan, n_global, self.coupling_itemsize):
            return gibbs_sweeps_cuda(*args, **kw)
        return gibbs_sweeps_hbm_cuda(*args, **kw)

    def compute_energies(self, hp, coupling_p, chains) -> torch.Tensor:
        """(T, C) ladder energies under the sampler model (this rank's
        rungs); (0,) outside PT."""
        if not self.pt_mode:
            return torch.zeros(0, device=chains.device)
        return self.energies(hp, coupling_p, chains)

    def energies(self, hp, coupling_p, spins) -> torch.Tensor:
        """Ising energies of (..., n_pad) spins, or under graph sharding of
        this rank's column window (``ising_energies_graph_sharded``)."""
        if self.graph_sharded:
            from image_generation_tpu_torch.ops.gibbs_graph_sharded import (
                ising_energies_graph_sharded,
            )

            return ising_energies_graph_sharded(hp, coupling_p, spins, self.mesh,
                                                matmul_dtype=self.mm_dtype)
        return ising_energies(hp, coupling_p, spins)

    def run_sweeps(self, generator, hp, coupling_p, chains, n_sweeps, energies=None,
                   betas=None, uniforms=None, swap_uniforms=None):
        """One negative-phase refresh of the training chains (this rank's
        part): ``n_sweeps`` Gibbs sweeps, or under PT one round (sweeps at
        every rung + replica exchange) at ``betas`` (the config ladder by
        default), carrying ``energies`` when given.  Returns (chains,
        energies, accept); the last two are (0,) outside PT."""
        rows = self.train_rows
        sweeps = partial(self.sweeps_fn, rows=rows)
        if self.pt_mode:
            betas = self.betas0 if betas is None else betas
            return pt_round(
                generator, hp, coupling_p, self.plan, chains, betas, n_sweeps,
                sweeps_fn=sweeps, energies=energies, return_accept=True,
                uniforms=uniforms, swap_uniforms=swap_uniforms, energies_fn=self.energies,
                ladder=self.ladder(rows, len(betas)),
            )
        empty = torch.zeros(0, device=chains.device)
        return sweeps(generator, hp, coupling_p, chains, n_sweeps, uniforms=uniforms), \
            empty, empty

    def chain_samples(self, chains) -> torch.Tensor:
        """(NUM_READS, n) target-distribution samples of the training
        chains in original order, whole on every rank."""
        return self.whole(chains, self.train_rows)

    def whole(self, chains, rows: RowShard) -> torch.Tensor:
        """Whole (C, n) samples in original order from this rank's part of
        the chains (C, ...) or of a PT ladder (T, C, ...): the β = 1 rung
        from the rank that holds it, the ranks' rows gathered, the graph
        windows gathered."""
        if self.pt_mode and chains.ndim == 3:
            ladder = self.ladder(rows, chains.shape[0] * rows.n)
            target = chains[-1] if ladder is None else ladder.target(chains)
        else:
            target = self.mesh.all_gather(chains, dim=0, axis=rows.axes) if rows.n > 1 \
                else chains
        return to_original(self.plan, self.gather(target))

    def gather(self, spins: torch.Tensor) -> torch.Tensor:
        """Whole-width spins from the ranks' column windows (graph
        sharding: an all-gather over the graph axis); as they are
        otherwise."""
        return self.mesh.all_gather(spins, dim=-1) if self.graph_sharded else spins

    def sample_fn(self, generator: Optional[torch.Generator],
                  grbm_params: GRBMParams, num_reads: int, n_sweeps: int, *,
                  init_spins: Optional[torch.Tensor] = None,
                  uniforms: Optional[torch.Tensor] = None,
                  betas: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Standalone sampler call for generation (the ``grbm.sample``
        equivalent): ``num_reads`` fresh chains, ``n_sweeps`` sweeps.
        Returns (num_reads, n) spins in original coordinates, the same on
        every rank of a mesh.

        Under PT a fresh ladder runs ``max(1, n_sweeps // GIBBS_SWEEPS)``
        rounds at ``betas`` (the config ladder by default) with carried
        energies, and the target rung is returned.  ``init_spins`` and
        ``uniforms`` (n_sweeps, num_reads, n_pad) replace the random start
        and draws of plain Gibbs: the entry the parity tests use.  On a
        mesh the chains are split as training splits its own
        (``chain_row_axes`` of num_reads, or of T under PT)."""
        cfg = self.config
        with span("sampler.build", device=self.device, n_pad=self.plan.n_pad,
                  form=self.stored_form):
            hp, coupling_p = self.build_sampler_model(grbm_params)
        if self.pt_mode:
            if uniforms is not None:
                raise ValueError("fed uniforms are taken by plain Gibbs sampling only")
            betas = self.betas0 if betas is None else betas
            rows = self.row_shard(len(betas))
            if init_spins is None and self.mesh is not None:
                init_spins = random_spins(generator, self.plan, len(betas) * num_reads,
                                          self.device).reshape(len(betas), num_reads, -1)
            _, ladder_s = pt_sample(
                generator, hp, coupling_p, self.plan, num_reads, betas,
                max(1, n_sweeps // max(cfg.GIBBS_SWEEPS, 1)), cfg.GIBBS_SWEEPS,
                init_spins=None if init_spins is None else self.local(init_spins, rows),
                sweeps_fn=partial(self.sweeps_fn, rows=rows), energies_fn=self.energies,
                ladder=self.ladder(rows, len(betas)),
            )
            return self.whole(ladder_s, rows)
        rows = self.row_shard(num_reads)
        if init_spins is None:
            init_spins = random_spins(generator, self.plan, num_reads, self.device)
        spins = self.sweeps_fn(generator, hp, coupling_p, self.local(init_spins, rows),
                               n_sweeps, uniforms=uniforms, rows=rows)
        return self.whole(spins, rows)


def _stored_bytes(coupling_p) -> int:
    """Bytes of a sampler coupling as it is stored: a dense f32 or bf16
    matrix, a ``QuantCoupling``'s int8 matrix or packed panels (whole or
    a graph shard's), each with its f32 scale where it has one."""
    mat = getattr(coupling_p, "panels", getattr(coupling_p, "q", coupling_p))
    scale = getattr(coupling_p, "scale", None)
    return mat.numel() * mat.element_size() + (4 if scale is not None else 0)


def make_sample_fns(cfg: TrainingConfig, graph: GRBMGraph,
                    plan: Optional[GibbsPlan] = None, device="cuda", mesh=None) -> SampleFns:
    """Sampler functions for a config and coupling graph on ``device``
    (the card unless ``device="cpu"``), graph-sharded over ``mesh`` where
    the JAX gate says so (``SampleFns``).  Raises ``ValueError`` for an
    unresolved ``PT_NUM_BETAS="auto"`` and for ``GRAPH_SHARDED="on"``
    without a graph axis that tiles n_pad."""
    device = resolve_device(device)
    if plan is None:
        plan = build_plan(graph)
    return SampleFns(cfg, graph, plan, device, mesh)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _flax_init_(dvae: DVAE, generator: torch.Generator) -> None:
    """The JAX model's initialisers: LeCun-normal (truncated at ±2σ,
    variance 1/fan_in) weights and zero biases for every convolution and
    dense layer, ones and zeros for BatchNorm."""
    for m in dvae.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            w = m.weight
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]  # (I, O, kh, kw)
            else:
                fan_in = w[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncnorm(±2) std
            t = torch.randn(w.shape, generator=generator)
            out = t.abs() > 2.0
            while out.any():  # redraw outside ±2σ: a truncated normal
                t[out] = torch.randn(int(out.sum()), generator=generator)
                out = t.abs() > 2.0
            with torch.no_grad():
                w.copy_(t * std)
                m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()


class TrainStepFns(SampleFns):
    """Training functions bound to one (config, graph, plan, device):
    ``init``, ``step_body``, ``epoch``, ``rebuild_cache``,
    ``rebuild_sampler``, the LR schedules, and the sampler functions."""

    def __init__(self, cfg: TrainingConfig, graph: GRBMGraph, plan: GibbsPlan,
                 device, total_steps: int, mesh=None, dense_min_elems: Optional[int] = None):
        super().__init__(cfg, graph, plan, device, mesh)
        self.dense_min_elems = DENSE_MIN_ELEMS if dense_min_elems is None else dense_min_elems
        self.kernel = GaussianKernel(n_kernels=cfg.N_KERNELS)
        self.dvae_lr = geomspace_lr(cfg.AUTOENCODER_INITIAL_LR, cfg.AUTOENCODER_FINAL_LR,
                                    total_steps)
        self.grbm_lr = geomspace_lr(cfg.BM_INITIAL_LR, cfg.BM_FINAL_LR, total_steps)

    def new_dvae(self) -> DVAE:
        cfg = self.config
        return DVAE(cfg.N_LATENTS, cfg.LATENT_TO_DISCRETE,
                    dtype=getattr(torch, cfg.COMPUTE_DTYPE),
                    gumbel_tau=cfg.GUMBEL_TAU).to(self.device)

    def new_optimizers(self, dvae: DVAE, grbm_params: GRBMParams):
        """Adam with the L2 term added to the gradient (torch's
        ``weight_decay``, which is optax's ``add_decayed_weights`` before
        ``scale_by_adam``); the LR is set before every update.  The DVAE's
        is stock Adam unless ``ADAM_MOMENT_DTYPE="bfloat16"`` or
        ``ADAM_FACTORED_NU="on"`` asks for ``training/optim.py``'s
        ``AdamMoments`` (the JAX ``scale_by_adam_moments``)."""
        cfg = self.config
        factored_min = _FACTORED_NU_MIN if cfg.ADAM_FACTORED_NU == "on" else None
        if cfg.ADAM_MOMENT_DTYPE == "float32" and factored_min is None:
            dvae_opt = torch.optim.Adam(dvae.parameters(), lr=cfg.AUTOENCODER_INITIAL_LR,
                                        weight_decay=cfg.AUTOENCODER_WEIGHT_DECAY, **_ADAM)
        else:
            from image_generation_tpu_torch.training.optim import AdamMoments

            dvae_opt = AdamMoments(
                dvae.parameters(), lr=cfg.AUTOENCODER_INITIAL_LR,
                weight_decay=cfg.AUTOENCODER_WEIGHT_DECAY, **_ADAM,
                moment_dtype=(None if cfg.ADAM_MOMENT_DTYPE == "float32"
                              else getattr(torch, cfg.ADAM_MOMENT_DTYPE)),
                factored_nu_min_size=factored_min)
        return (
            dvae_opt,
            torch.optim.Adam([grbm_params.linear, grbm_params.quadratic],
                             lr=cfg.BM_INITIAL_LR, weight_decay=cfg.BM_WEIGHT_DECAY, **_ADAM),
        )

    def new_chains(self, generator) -> torch.Tensor:
        """Fresh random whole chains, (NUM_READS, n_pad) or the PT ladder
        (T, NUM_READS, n_pad), the same on every rank (``state_from`` cuts
        them to this rank's part)."""
        cfg = self.config
        if self.pt_mode:
            return random_spins(generator, self.plan, cfg.PT_NUM_BETAS * cfg.NUM_READS,
                                self.device).reshape(cfg.PT_NUM_BETAS, cfg.NUM_READS, -1)
        return random_spins(generator, self.plan, cfg.NUM_READS, self.device)

    def init(self, seed: int) -> TrainState:
        """A fresh state: the JAX model's initialisers, small random GRBM
        parameters, random chains burned in for ``GIBBS_BURN_IN`` sweeps
        (one PT round of that many sweeps under PT)."""
        cfg = self.config
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        g_cpu = torch.Generator().manual_seed(int(seed))
        dvae = self.new_dvae()
        _flax_init_(dvae, g_cpu)
        grbm_params = self.graph.init_params(g, device=self.device)
        return self.state_from(dvae, grbm_params, self.new_chains(g), g, burn_in=True)

    def state_from(self, dvae: DVAE, grbm_params: GRBMParams, chains: torch.Tensor,
                   generator: torch.Generator, *, burn_in: bool,
                   chain_energies: Optional[torch.Tensor] = None,
                   pt_betas: Optional[torch.Tensor] = None, opt_step: int = 0) -> TrainState:
        """A state around given weights and whole chains (and their whole
        ladder energies) with fresh optimizers, cut to this rank's part of
        them on a mesh (``local``); ``burn_in`` runs ``GIBBS_BURN_IN`` sweeps
        under the model first.  On a mesh, ``dvae``'s outsized dense layers
        are column-sharded in place first (``parallel.dense.shard_large_dense``
        at ``dense_min_elems``), so the optimizer holds their blocks."""
        shard_large_dense(dvae, self.mesh, self.dense_min_elems)
        hp, coupling_p = self.build_sampler_model(grbm_params)
        if chain_energies is not None and chain_energies.numel():
            chain_energies = self.local(chain_energies[..., None])[..., 0]
        chains = self.local(chains)
        if pt_betas is None:
            pt_betas = (self.betas0.clone() if self.pt_mode
                        else torch.zeros(0, device=self.device))
        if burn_in:
            chains, chain_energies, _ = self.run_sweeps(
                generator, hp, coupling_p, chains, self.config.GIBBS_BURN_IN, betas=pt_betas)
        elif chain_energies is None:
            chain_energies = self.compute_energies(hp, coupling_p, chains)
        dvae_opt, grbm_opt = self.new_optimizers(dvae, grbm_params)
        return TrainState(dvae, grbm_params, dvae_opt, grbm_opt, chains, chain_energies,
                          hp, coupling_p, opt_step, generator, pt_betas)

    def step_body(self, state: TrainState, images: torch.Tensor, epoch: int,
                  feed: Optional[StepFeed] = None) -> StepMetrics:
        """One training step on the global batch ``images`` (B, S, S, 1),
        whole on every rank; updates ``state`` in place and returns the
        step's metrics as device tensors.

        On a mesh whose data axis B tiles, each rank trains on its slice
        (``parallel.mesh.shard_batch``) with the JAX package's
        single-device semantics on the global batch: BatchNorm's
        statistics, the MSE and the MMD are over the global batch, the MMD
        and the GRBM update see every slice's spins (gathered), and the
        DVAE gradient is summed over the data axis, so the replicated
        parameters stay equal on every rank.  The straight-through
        uniforms and dropout masks are drawn for the global batch (fed
        ones cover it too) and cut to this slice."""
        local = shard_batch(images, self.mesh)
        return self._step(state, local, epoch, feed, local.shape[0] != images.shape[0])

    def _step(self, state: TrainState, images: torch.Tensor, epoch: int,
              feed: Optional[StepFeed], dp: bool) -> StepMetrics:
        """``step_body`` on this rank's ``images``, its slice of the global
        batch along the data axis when ``dp``."""
        cfg = self.config
        feed = feed or StepFeed()
        g = state.generator
        dev = self.device
        pt_carry = self.pt_mode and cfg.PERSISTENT_CHAINS
        with span("train.step", device=dev, step=state.opt_step):
            # ---- negative phase #1, under the cached sampler model ----
            with span("train.sampler", device=dev):
                chains_in = state.chains
                if not cfg.PERSISTENT_CHAINS:
                    flat = feed.fresh_chains
                    if flat is None:
                        flat = random_spins(g, self.plan,
                                            chains_in[..., 0].numel() * self.train_rows.n,
                                            self.device)
                    whole = ((chains_in.shape[0] * self.train_rows.n,)
                             + tuple(chains_in.shape[1:-1]))
                    chains_in = self.local(flat.reshape(*whole, -1))
                chains, chain_e, pt_accept = self.run_sweeps(
                    g, state.sampler_h, state.sampler_coupling, chains_in, cfg.GIBBS_SWEEPS,
                    energies=state.chain_energies if pt_carry else None, betas=state.pt_betas,
                    uniforms=feed.sweeps1, swap_uniforms=feed.swaps1,
                )
                samples = self.chain_samples(chains)

            # ---- DVAE forward + MSE + MMD, backward, Adam ----
            with span("train.forward", device=dev):
                dvae = state.dvae.train()
                state.dvae_opt.zero_grad(set_to_none=True)
                spin_u, masks = feed.spin_uniforms, feed.dropout_masks
                if dp:
                    spin_u, masks = self._global_draws(g, images, spin_u, masks)
                    with global_batch_stats(self._data_sum, self.mesh.data), \
                            rows_split_over_data():
                        _logits, spins, recon = dvae(images, cfg.N_REPLICAS, g,
                                                     spin_uniforms=spin_u, dropout_masks=masks)
                else:
                    _logits, spins, recon = dvae(images, cfg.N_REPLICAS, g,
                                                 spin_uniforms=spin_u, dropout_masks=masks)
                mse = torch.square(recon - images[:, None]).mean()
                flat_spins = spins.reshape(-1, spins.shape[-1])
                if dp:  # this slice's share of the global mean; every slice's spins
                    mse = mse / self.mesh.data
                    flat_spins = AllGatherRows.apply(flat_spins, self.mesh, "data")
                mmd = mmd_loss(flat_spins, samples, self.kernel)
                loss = mse + mmd
            with span("train.backward", device=dev):
                loss.backward()
                if dp:
                    mse = self.mesh.all_reduce(mse.detach().clone(), axis="data")
                    loss = mse + mmd.detach()
                    self._sum_gradients(dvae)
            with span("train.optimizer", device=dev):
                for group in state.dvae_opt.param_groups:
                    group["lr"] = self.dvae_lr(state.opt_step)
                state.dvae_opt.step()

            # ---- scheduled GRBM update (host integers: no device sync) ----
            train_grbm = epoch < 6 and state.opt_step % 10 == 0
            nll = torch.zeros((), device=self.device)
            if train_grbm:
                with span("train.grbm_update", device=dev):
                    data_spins = flat_spins.detach()
                    chains, chain_e2, _ = self.run_sweeps(
                        g, state.sampler_h, state.sampler_coupling, chains, cfg.GIBBS_SWEEPS,
                        energies=chain_e if self.pt_mode else None, betas=state.pt_betas,
                        uniforms=feed.sweeps2, swap_uniforms=feed.swaps2,
                    )
                    model_spins = self.chain_samples(chains)
                    params = state.grbm_params
                    nll = nll_value(params, self.graph, data_spins, model_spins)
                    grads = nll_grads(self.graph, data_spins, model_spins)
                    params.linear.grad, params.quadratic.grad = grads.linear, grads.quadratic
                    for group in state.grbm_opt.param_groups:
                        group["lr"] = self.grbm_lr(state.opt_step)
                    state.grbm_opt.step()
                    params.linear.grad = params.quadratic.grad = None
                    with span("train.sampler_rebuild", device=dev):
                        state.sampler_h, state.sampler_coupling = self.build_sampler_model(params)
                        # energies depend on the model: re-anchor under the new one
                        chain_e = self.compute_energies(state.sampler_h, state.sampler_coupling,
                                                        chains)
            state.chains, state.chain_energies = chains, chain_e
            state.opt_step += 1
            return StepMetrics(
                mse=mse.detach(), mmd=mmd.detach(), dvae_loss=loss.detach(), nll=nll.detach(),
                grbm_trained=torch.full((), float(train_grbm), device=self.device),
                pt_accept=pt_accept,
            )

    def _data_sum(self, t: torch.Tensor) -> torch.Tensor:
        return AllReduceSum.apply(t, self.mesh, "data")

    def _global_draws(self, g, images, spin_u, masks):
        """This data slice's straight-through uniforms and dropout masks:
        drawn (or fed) for the global batch, in the single-device order,
        and cut to the slice's rows."""
        cfg, mesh = self.config, self.mesh
        b, r, n = images.shape[0], cfg.N_REPLICAS, cfg.N_LATENTS
        lo = mesh.data_index * b
        if spin_u is None and cfg.LATENT_TO_DISCRETE != "heaviside":
            spin_u = torch.rand((b * mesh.data, r, n), generator=g, device=self.device)
            if cfg.LATENT_TO_DISCRETE == "gumbel":
                spin_u = gumbel_uniforms(spin_u)
        if masks is None:
            masks = draw_dropout_masks(b * mesh.data * r, g, self.device)
        return (None if spin_u is None else spin_u[lo:lo + b],
                [m[lo * r:(lo + b) * r] for m in masks])

    def _sum_gradients(self, dvae: DVAE) -> None:
        """Sum the DVAE gradient over the data axis in one all-reduce (the
        ranks of one data row hold the same slice and are not summed).  A
        column-sharded weight's gradient is whole already and is left
        out."""
        grads = [p.grad for p in dvae.parameters()
                 if p.grad is not None and getattr(p, "column_shard", None) is None]
        flat = self.mesh.all_reduce(torch.cat([g_.reshape(-1) for g_ in grads]), axis="data")
        i = 0
        for g_ in grads:
            g_.copy_(flat[i:i + g_.numel()].view_as(g_))
            i += g_.numel()

    def epoch(self, state: TrainState, batches: torch.Tensor, epoch: int):
        """Every global batch of (n_batches, B, S, S, 1) in turn, each rank
        on its data slice (``parallel.mesh.shard_epoch_batches``); returns
        (state, dict of per-step metrics stacked on the device)."""
        local = shard_epoch_batches(batches, self.mesh)
        dp = local.shape[1] != batches.shape[1]
        out: List[StepMetrics] = [self._step(state, b, epoch, None, dp) for b in local]
        return state, {
            f: torch.stack([getattr(m, f) for m in out])
            for f in StepMetrics.__dataclass_fields__
        }

    def rebuild_cache(self, state: TrainState) -> TrainState:
        """Recompute only the cached sampler model from ``grbm_params``."""
        with span("train.sampler_rebuild", device=self.device):
            state.sampler_h, state.sampler_coupling = self.build_sampler_model(
                state.grbm_params)
        return state

    def rebuild_sampler(self, state: TrainState) -> TrainState:
        """Recompute the cached sampler model and re-burn the chains under
        it (after swapping in other GRBM parameters)."""
        self.rebuild_cache(state)
        state.chains, state.chain_energies, _ = self.run_sweeps(
            state.generator, state.sampler_h, state.sampler_coupling, state.chains,
            self.config.GIBBS_BURN_IN, betas=state.pt_betas,
        )
        return state


def make_train_fns(cfg: TrainingConfig, graph: GRBMGraph, total_steps: int,
                   plan: Optional[GibbsPlan] = None, device="cuda",
                   mesh=None, dense_min_elems: Optional[int] = None) -> TrainStepFns:
    """Training functions for a config and coupling graph on ``device``
    (the card unless ``device="cpu"``), graph-sharded over ``mesh`` as
    ``make_sample_fns`` says; ``total_steps`` = epochs × batches fixes the
    LR schedules.  ``dense_min_elems``: the size from which a DVAE dense
    layer is column-sharded over a mesh (the JAX ``shard_train_state``
    keyword; ``parallel.dense.DENSE_MIN_ELEMS`` by default)."""
    device = resolve_device(device)
    if plan is None:
        plan = build_plan(graph)
    return TrainStepFns(cfg, graph, plan, device, total_steps, mesh, dense_min_elems)


def train_state_from_jax(fns: TrainStepFns, state, seed: int = 0) -> TrainState:
    """The port's ``TrainState`` from the JAX package's: ``state`` is read
    through its leaves as numpy (``dvae_params``, ``batch_stats``,
    ``grbm_params.linear/.quadratic``, ``chains``, ``chain_energies``,
    ``pt_betas``, ``opt_step``).  The cached sampler model is rebuilt from
    ``grbm_params`` in the form the dispatch stores (quantized, cast,
    packed; this rank's rows under graph sharding, with its columns of
    the chains), as the JAX package rebuilds it on restore.  Optimizer moments
    start fresh, as after the JAX ``init``; ``seed`` seeds the state's
    generator."""
    dev = fns.device
    dvae = fns.new_dvae()
    dvae.load_state_dict(dvae_state_dict_from_jax(state.dvae_params, state.batch_stats))

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    grbm_params = GRBMParams(t(state.grbm_params.linear), t(state.grbm_params.quadratic))
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return fns.state_from(
        dvae, grbm_params, t(state.chains), g, burn_in=False,
        chain_energies=t(state.chain_energies), pt_betas=t(state.pt_betas),
        opt_step=int(np.asarray(state.opt_step)),
    )
