"""The device mesh over ``torch.distributed`` ranks, its collectives and
sharding rules.

Port of ``image_generation_tpu/parallel/mesh.py``.  The JAX mesh is one
program over a grid of devices; here every rank is its own process (or,
in the CPU tests, its own thread) running the same code on its own part of
the state, and a ``Mesh`` says which part: the axis sizes ``(data,
graph)``, this rank's coordinates and the process groups of its axes.

The axes keep the JAX package's meaning.  ``data`` splits the global
batch: each data row trains on its slice (``shard_batch``), and the DVAE
gradient, BatchNorm's statistics, the MSE and the MMD's inputs are summed
or gathered over it (``training/step.py``).  The second axis is the JAX
package's "chain" axis, named ``graph`` here: under graph sharding
(``ops/gibbs_graph_sharded.py``) it splits the padded spin dimension into
``graph`` windows (rank g holds columns ``[g·L, (g+1)·L)`` of the chains
and rows ``[g·L, (g+1)·L)`` of the coupling, L = n_pad / graph);
otherwise it splits the chain rows, as the JAX chain-sharded kernels do.
Which axes split the chain rows is ``chain_row_axes``: the JAX
``shard_train_state`` rule.

The DVAE, the GRBM, their optimizers and the fields h are replicated:
every rank computes the same step from the same random draws (every
rank's generators are seeded alike), and the collectives give every rank
the same bytes.  The exception is an outsized dense layer, which is
column-sharded over the whole mesh with its Adam moments, on every mesh
of more than one rank (``parallel/dense.py``, the JAX
``_shard_large_dense``).

Collectives go through the axis groups' own methods (``allreduce``,
``allgather``, ``broadcast``, ``send`` / ``recv``), so a ``Mesh`` works over
groups made by ``torch.distributed.new_group`` and over ones made directly
(the CPU tests' threaded ``ProcessGroupGloo``).  The backend is the
caller's choice: NCCL with one card per rank (the default), or gloo for
ranks that share a card (NCCL refuses two ranks on one device); under
gloo, gathers and point-to-point exchanges of CUDA tensors go through the
host.  Each collective's host time is summed in ``comm_seconds`` /
``comm_calls``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from image_generation_tpu_torch.parallel.dense import DENSE_MIN_ELEMS, shard_large_dense

__all__ = [
    "Mesh",
    "create_mesh",
    "auto_mesh",
    "chain_row_axes",
    "LadderShard",
    "shard_batch",
    "shard_epoch_batches",
    "shard_train_state",
    "shard_large_dense",
    "DENSE_MIN_ELEMS",
]


@dataclass(eq=False)
class Mesh:
    """This rank's view of a (data × graph) mesh.

    ``graph_group`` / ``data_group``: the process groups of this rank's
    graph axis (the ranks of its data row) and data axis (the ranks of
    its graph column), None for an axis of size 1; ``world_group``: all
    ranks of the mesh (needed when both axes exceed 1, otherwise the
    larger axis's group).  ``backend``: the groups' backend."""

    shape: Tuple[int, int]
    data_index: int = 0
    graph_index: int = 0
    graph_group: object = None
    backend: str = "nccl"
    data_group: object = None
    world_group: object = None
    comm_seconds: float = field(default=0.0, repr=False)
    comm_calls: int = field(default=0, repr=False)

    def __post_init__(self):
        self.shape = tuple(int(x) for x in self.shape)
        if len(self.shape) != 2 or min(self.shape) < 1:
            raise ValueError(f"mesh shape must be (data, graph) >= 1, got {self.shape}")
        if not (0 <= self.data_index < self.shape[0] and 0 <= self.graph_index < self.shape[1]):
            raise ValueError(f"index ({self.data_index}, {self.graph_index}) outside {self.shape}")
        if self.shape[1] > 1 and self.graph_group is None:
            raise ValueError("a graph axis of size > 1 needs its process group")
        if self.shape[0] > 1 and self.data_group is None:
            raise ValueError("a data axis of size > 1 needs its process group")
        if min(self.shape) > 1 and self.world_group is None:
            raise ValueError("a mesh with both axes > 1 needs its world group")

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def graph(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def rank(self) -> int:
        """This rank's place in the mesh, row-major (data, graph)."""
        return self.data_index * self.graph + self.graph_index

    def window(self, n_pad: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of the padded spin dimension (graph
        sharding)."""
        if n_pad % self.graph:
            raise ValueError(f"n_pad={n_pad} does not tile the graph axis ({self.graph})")
        l_loc = n_pad // self.graph
        return self.graph_index * l_loc, (self.graph_index + 1) * l_loc

    # ---- axes ----------------------------------------------------------
    def axis(self, axes) -> Tuple[object, int, int]:
        """(group, size, this rank's index) of ``axes``: "graph", "data",
        or a tuple of them ((data, graph) jointly is the whole mesh,
        row-major, as the JAX ``fold_in`` index over ("data", "chain"))."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes == ("graph",):
            return self.graph_group, self.graph, self.graph_index
        if axes == ("data",):
            return self.data_group, self.data, self.data_index
        if axes == ("data", "graph"):
            if self.data == 1:
                return self.graph_group, self.size, self.rank
            if self.graph == 1:
                return self.data_group, self.size, self.rank
            return self.world_group, self.size, self.rank
        if axes == ():
            return None, 1, 0
        raise ValueError(f"unknown mesh axes {axes}")

    # ---- collectives ---------------------------------------------------
    def _timed(self, work_fn):
        t0 = time.perf_counter()
        work_fn().wait()
        self.comm_seconds += time.perf_counter() - t0
        self.comm_calls += 1

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis="graph") -> torch.Tensor:
        """Sum (or "max") ``t`` over ``axis`` (the graph axis by default),
        in place; returns it."""
        group, size, _ = self.axis(axis)
        if size == 1:
            return t
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        t = t.contiguous()
        self._timed(lambda: group.allreduce([t], opts))
        return t

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        src = t.contiguous()
        return src.cpu() if src.is_cuda and self.backend == "gloo" else src

    def all_gather(self, t: torch.Tensor, dim: int = -1, axis="graph") -> torch.Tensor:
        """Every ``axis`` rank's ``t`` (equal shapes) concatenated along
        ``dim`` in rank order.  Gloo gathers only host tensors, so a CUDA
        tensor goes through the host under gloo (what gloo's own CUDA
        all-reduce does inside)."""
        group, size, _ = self.axis(axis)
        if size == 1:
            return t
        src = self._host(t)
        parts = [torch.empty_like(src) for _ in range(size)]
        self._timed(lambda: group.allgather([parts], [src]))
        return torch.cat(parts, dim=dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0, axis="graph") -> torch.Tensor:
        """``t`` of ``axis`` rank ``src`` on every ``axis`` rank, in
        place."""
        group, size, _ = self.axis(axis)
        if size == 1:
            return t
        import torch.distributed as dist

        buf = self._host(t)
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        self._timed(lambda: group.broadcast([buf], opts))
        if buf is not t:
            t.copy_(buf)
        return t

    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]], axis) -> None:
        """Point to point over ``axis``: send each ``(peer, tensor)`` of
        ``sends`` and receive into each ``(peer, tensor)`` of ``recvs``, all
        posted before any is waited on (peers are ``axis`` ranks).  They are
        posted peer by peer in ascending order, and with each peer the lower
        of the two ranks sends first: NCCL runs one pair's operations in the
        order they were posted, so two ranks that both sent first would each
        wait for the other's receive."""
        group, _, me = self.axis(axis)
        t0 = time.perf_counter()
        works, held, out = [], [], []
        for peer in sorted({p for p, _ in sends} | {p for p, _ in recvs}):
            to = [(True, t) for p, t in sends if p == peer]
            back = [(False, t) for p, t in recvs if p == peer]
            for is_send, t in (to + back if me < peer else back + to):
                buf = self._host(t)
                if is_send:
                    held.append(buf)  # a host copy must outlive its send
                    works.append(group.send([buf], peer, 0))
                else:
                    out.append((buf, t))
                    works.append(group.recv([buf], peer, 0))
        for w in works:
            w.wait()
        for buf, t in out:
            if buf is not t:
                t.copy_(buf)
        self.comm_seconds += time.perf_counter() - t0
        self.comm_calls += 1

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here (an all-reduce of one
        value, on the card under NCCL)."""
        self.all_reduce(torch.zeros(1, device="cuda" if self.backend == "nccl" else "cpu"),
                        axis=("data", "graph"))


# ---------------------------------------------------------------------------
# differentiable collectives (the data-parallel step)
# ---------------------------------------------------------------------------

class AllReduceSum(torch.autograd.Function):
    """Sum over a mesh axis whose gradient is the sum of the ranks'
    gradients: each rank backpropagates its own share of the loss, and the
    statistic's gradient gathers every share (BatchNorm's batch
    statistics over the global batch)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(t.clone(), axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), axis=ctx.axis), None, None


class AllGatherRows(torch.autograd.Function):
    """The ranks' (N, ...) tensors stacked along dim 0 in rank order; the
    gradient of this rank's rows is its slice of the output's gradient
    (every rank computes the same loss from the gathered tensor, and
    backpropagates through its own rows only)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        _, ctx.size, ctx.index = mesh.axis(axis)
        ctx.rows = t.shape[0]
        return mesh.all_gather(t, dim=0, axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


class LadderShard:
    """This rank's rungs [t0, t1) of a T-rung PT ladder split over mesh
    ``axes`` (``chain_row_axes``), and the exchanges the replica swaps
    need: the JAX ``jnp.roll`` over the sharded T axis.  Swap decisions are
    made from the whole ladder's energies (small: T × C), gathered, so
    they are the same on every rank; only the rungs at the slices' edges
    cross ranks, and only in the pass whose pairs straddle them."""

    def __init__(self, mesh: Mesh, axes, t_dim: int):
        self.mesh, self.axes, self.t_dim = mesh, axes, int(t_dim)
        _, self.n, self.index = mesh.axis(axes)
        if self.t_dim % self.n:
            raise ValueError(f"a {t_dim}-rung ladder does not split over {self.n} ranks")
        per = self.t_dim // self.n
        self.t0, self.t1 = self.index * per, (self.index + 1) * per

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole ladder's (T, ...) rows from every rank's (t1 − t0, ...)."""
        return self.mesh.all_gather(x, dim=0, axis=self.axes)

    def neighbours(self, x: torch.Tensor, parity: int):
        """(rung t1, rung t0 − 1) of the ladder whose local rungs are ``x``
        (t1 − t0, ...), each from the rank that holds it, where this swap
        pass's pairs (t, t + 1 with t % 2 == parity) straddle the slice's
        edges; None where they do not."""
        up = self.t1 < self.t_dim and (self.t1 - 1) % 2 == parity
        down = self.t0 > 0 and (self.t0 - 1) % 2 == parity
        after = torch.empty_like(x[-1]) if up else None
        before = torch.empty_like(x[0]) if down else None
        sends = [(self.index + 1, x[-1])] * up + [(self.index - 1, x[0])] * down
        recvs = [(self.index + 1, after)] * up + [(self.index - 1, before)] * down
        if sends:
            self.mesh.exchange(sends, recvs, self.axes)
        return after, before

    def target(self, x: torch.Tensor) -> torch.Tensor:
        """The β = 1 rung (T − 1) on every rank, from the rank that holds
        it (the JAX one-hot contraction's psum)."""
        buf = x[-1].clone() if self.index == self.n - 1 else torch.empty_like(x[-1])
        return self.mesh.broadcast(buf, src=self.n - 1, axis=self.axes)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def default_shape(n: int) -> Tuple[int, int]:
    """The JAX ``create_mesh`` default: (n/2, 2) for an even n ≥ 2 (both
    axes exercised), (n, 1) otherwise."""
    return (n // 2, 2) if n % 2 == 0 and n >= 2 else (n, 1)


def create_mesh(shape: Optional[Sequence[int]] = None, backend: str = "nccl") -> Mesh:
    """This rank's mesh over the initialised ``torch.distributed`` world.

    ``shape`` (data, graph) defaults to JAX's (``default_shape`` of the
    world size).  Rank r sits at (r // graph, r % graph).  Every rank of
    the world must call this with the same arguments: it makes every data
    row's graph group, every graph column's data group and the world group
    (``torch.distributed.new_group`` is collective) over ``backend``:
    "nccl" (one card per rank) or "gloo" (ranks that share a card, or the
    CPU)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call init_process_group (with "
            "tcp://localhost:<port>, the world size and this rank) first"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = default_shape(world) if shape is None else tuple(int(x) for x in shape)
    if len(shape) != 2 or min(shape) < 1 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    n_data, n_graph = shape
    d, g = rank // n_graph, rank % n_graph
    graph_group = data_group = world_group = None
    for row in range(n_data):  # every rank makes every group, in one order
        grp = dist.new_group([row * n_graph + c for c in range(n_graph)], backend=backend)
        if row == d and n_graph > 1:
            graph_group = grp
    for col in range(n_graph):
        grp = dist.new_group([r * n_graph + col for r in range(n_data)], backend=backend)
        if col == g and n_data > 1:
            data_group = grp
    if min(shape) > 1:
        world_group = dist.new_group(list(range(world)), backend=backend)
    return Mesh(shape, data_index=d, graph_index=g, graph_group=graph_group,
                backend=backend, data_group=data_group, world_group=world_group)


def auto_mesh() -> Optional[Mesh]:
    """The default mesh: the initialised world in the JAX default shape
    over the world's own backend, or None when no process group is
    initialised or the world has one rank (the JAX ``auto_mesh`` on one
    device)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return create_mesh(backend=dist.get_backend())


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def chain_row_axes(rows: int, mesh: Optional[Mesh], graph_sharded: bool = False) -> tuple:
    """The mesh axes the chains' leading axis (NUM_READS rows, or the PT
    ladder's T) is split over, the JAX ``shard_train_state`` rule: under
    graph sharding ("data",) when the rows tile it, else none; otherwise
    (data, graph) jointly, else ("data",), else ("graph",), else none
    (replicated).  An axis of size 1 is left out."""
    if mesh is None or mesh.size == 1:
        return ()
    cands = [("data",)] if graph_sharded else [("data", "graph"), ("data",), ("graph",)]
    for axes in cands:
        _, size, _ = mesh.axis(axes)
        if rows % size == 0:
            return tuple(a for a in axes if (mesh.data if a == "data" else mesh.graph) > 1)
    return ()


def _data_slice(b: int, mesh: Optional[Mesh]) -> Optional[slice]:
    if mesh is None or mesh.data == 1 or b % mesh.data:
        return None
    per = b // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(images: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slice of a (B, H, W, C) batch along ``data`` (the whole
    batch when B does not tile the axis, which JAX then replicates)."""
    sl = _data_slice(images.shape[0], mesh)
    return images if sl is None else images[sl]


def shard_epoch_batches(batches: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's slice of an epoch's (n_batches, B, H, W, C) stack along
    ``data`` (the per-step batch axis); the step axis stays whole."""
    sl = _data_slice(batches.shape[1], mesh)
    return batches if sl is None else batches[:, sl]


def shard_train_state(state, mesh: Mesh, graph_sharded: bool = False,
                      dense_min_elems: int = DENSE_MIN_ELEMS):
    """Cut a whole-mesh ``TrainState`` to this rank's part, in place, and
    return it.

    The chains' leading axis goes to this rank's slice of
    ``chain_row_axes``.  Under graph sharding the chains also keep only
    their column window ((C, n_pad) or the PT ladder (T, C, n_pad)) and the
    cached coupling its row block (a dense tensor, or a ``QuantCoupling``'s
    int8 rows with its scale); a packed coupling's layout depends on the
    shard count, so a single-device ``BlockSparseCoupling`` (or a packed
    shard of another mesh) is refused: rebuild the cache
    (``fns.rebuild_cache``).  The carried ladder energies follow the
    ladder's rows.  On every mesh, graph-sharded or not, a DVAE dense layer
    of at least ``dense_min_elems`` elements whose output features tile the
    mesh is column-sharded with its optimizer moments
    (``parallel.dense.shard_large_dense``).  Everything else is replicated
    and stays as it is."""
    from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
    from image_generation_tpu_torch.ops.block_sparse_sharded import (
        ShardedBlockSparseCoupling,
    )
    from image_generation_tpu_torch.ops.quant import QuantCoupling

    rows = int(state.chains.shape[0])
    _, n_shards, index = mesh.axis(chain_row_axes(rows, mesh, graph_sharded))
    per = rows // n_shards
    state.chains = state.chains[index * per:(index + 1) * per].contiguous()
    if getattr(state, "chain_energies", torch.zeros(0)).numel():
        state.chain_energies = state.chain_energies[index * per:(index + 1) * per].contiguous()
    if graph_sharded:
        n_pad = state.chains.shape[-1]
        lo, hi = mesh.window(n_pad)
        state.chains = state.chains[..., lo:hi].contiguous()
        cp = state.sampler_coupling
        if isinstance(cp, ShardedBlockSparseCoupling):
            if cp.n_shards != mesh.graph or cp.shard != mesh.graph_index:
                raise ValueError(
                    f"packed sampler coupling was built for shard {cp.shard} of "
                    f"{cp.n_shards}, this rank is {mesh.graph_index} of {mesh.graph}: "
                    "rebuild the sampler cache"
                )
        elif isinstance(cp, BlockSparseCoupling):
            raise ValueError(
                "single-device packed coupling in graph-sharded state: rebuild the "
                "sampler cache (fns.rebuild_cache)"
            )
        elif isinstance(cp, QuantCoupling):
            state.sampler_coupling = QuantCoupling(cp.q[lo:hi].contiguous(), cp.scale)
        else:
            state.sampler_coupling = cp[lo:hi].contiguous()
    shard_large_dense(getattr(state, "dvae", None), mesh, dense_min_elems,
                      opt=getattr(state, "dvae_opt", None))
    return state
