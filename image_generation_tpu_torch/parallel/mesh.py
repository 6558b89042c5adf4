"""The device mesh over ``torch.distributed`` ranks, and graph sharding.

Port of ``image_generation_tpu/parallel/mesh.py``.  The JAX mesh is one
program over a grid of devices; here every rank is its own process (or,
in the CPU tests, its own thread) running the same code on its own part of
the state, and a ``Mesh`` says which part: the axis sizes ``(data,
graph)``, this rank's coordinates, and the process group of its graph
axis.  (The JAX package calls the graph axis "chain": under graph sharding
its "chain" axis partitions the coupling.)

Graph sharding (``ops/gibbs_graph_sharded.py``) splits the padded spin
dimension into ``graph`` equal windows: rank g holds columns
``[g·L, (g+1)·L)`` of the chains and rows ``[g·L, (g+1)·L)`` of the
coupling, L = n_pad / graph.  The GRBM, the DVAE, their optimizers and
the fields h are replicated: every rank computes the same step from the
same random draws (every rank's generators are seeded alike), and the
collectives give every rank the same bytes.

This slice runs meshes of one data row only: ``data > 1`` (data-parallel
batches with the DVAE gradient all-reduced over ``data``, the PT ladder
over ``data``, the column-sharded 127M-parameter dense layer) raises
``NotImplementedError``; ROADMAP.md queue 1 item 7 holds it.

Collectives go through the axis group's own methods (``allreduce``,
``allgather``, ``broadcast``), so a ``Mesh`` works over a group made by
``torch.distributed.new_group`` and over one made directly (the CPU tests'
threaded ``ProcessGroupGloo``).  The backend is the caller's choice: NCCL
with one card per rank (the default), or gloo, which also takes CUDA
tensors and stages them through the host, for ranks that share a card
(NCCL refuses two ranks on one device).  Each collective's host time is
summed in ``comm_seconds`` / ``comm_calls``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "Mesh",
    "create_mesh",
    "auto_mesh",
    "shard_train_state",
]

_DATA_AXIS_TODO = (
    "a mesh with data > 1 (data-parallel batches, the PT ladder over 'data', "
    "the column-sharded dense layer) is not ported yet: ROADMAP.md queue 1 item 7"
)


@dataclass(eq=False)
class Mesh:
    """This rank's view of a (data × graph) mesh.

    ``graph_group``: the process group of this rank's graph axis (None for
    a graph axis of size 1).  ``backend``: the group's backend, for the
    record."""

    shape: Tuple[int, int]
    data_index: int = 0
    graph_index: int = 0
    graph_group: object = None
    backend: str = "nccl"
    comm_seconds: float = field(default=0.0, repr=False)
    comm_calls: int = field(default=0, repr=False)

    def __post_init__(self):
        self.shape = tuple(int(x) for x in self.shape)
        if len(self.shape) != 2 or min(self.shape) < 1:
            raise ValueError(f"mesh shape must be (data, graph) >= 1, got {self.shape}")
        if self.shape[0] > 1:
            raise NotImplementedError(_DATA_AXIS_TODO)
        if not 0 <= self.graph_index < self.shape[1]:
            raise ValueError(f"graph index {self.graph_index} outside {self.shape}")
        if self.shape[1] > 1 and self.graph_group is None:
            raise ValueError("a graph axis of size > 1 needs its process group")

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def graph(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def window(self, n_pad: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of the padded spin dimension."""
        if n_pad % self.graph:
            raise ValueError(f"n_pad={n_pad} does not tile the graph axis ({self.graph})")
        l_loc = n_pad // self.graph
        return self.graph_index * l_loc, (self.graph_index + 1) * l_loc

    # ---- collectives over the graph axis ------------------------------
    def _timed(self, work_fn):
        t0 = time.perf_counter()
        work_fn().wait()
        self.comm_seconds += time.perf_counter() - t0
        self.comm_calls += 1

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or "max") ``t`` over the graph axis, in place; returns it."""
        if self.graph == 1:
            return t
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        t = t.contiguous()
        self._timed(lambda: self.graph_group.allreduce([t], opts))
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every graph rank's ``t`` concatenated along ``dim`` in rank order.
        Gloo gathers only host tensors, so a CUDA tensor goes through the
        host under gloo (what gloo's own CUDA all-reduce does inside)."""
        if self.graph == 1:
            return t
        src = t.contiguous()
        if src.is_cuda and self.backend == "gloo":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.graph)]
        self._timed(lambda: self.graph_group.allgather([parts], [src]))
        return torch.cat(parts, dim=dim).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of graph rank ``src`` on every graph rank, in place."""
        if self.graph == 1:
            return t
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = src, 0
        self._timed(lambda: self.graph_group.broadcast([t], opts))
        return t

    def barrier(self) -> None:
        """Wait until every graph rank is here (an all-reduce of one value,
        on the card under NCCL)."""
        self.all_reduce(torch.zeros(1, device="cuda" if self.backend == "nccl" else "cpu"))


def create_mesh(shape: Optional[Sequence[int]] = None, backend: str = "nccl") -> Mesh:
    """This rank's mesh over the initialised ``torch.distributed`` world.

    ``shape`` (data, graph) defaults to (1, world size): the whole world on
    the graph axis, the only layout this slice runs.  Rank r sits at
    (r // graph, r % graph).  ``backend`` is the graph axis group's:
    "nccl" (one card per rank) or "gloo" (ranks that share a card, or the
    CPU).  Every rank of the world must call this, with the same
    arguments (``torch.distributed.new_group`` is collective)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call init_process_group (with "
            "tcp://localhost:<port>, the world size and this rank) first"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (1, world) if shape is None else tuple(int(x) for x in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    if shape[0] > 1:
        raise NotImplementedError(_DATA_AXIS_TODO)
    group = None
    if shape[1] > 1:
        group = dist.new_group(list(range(world)), backend=backend)
    return Mesh(shape, data_index=rank // shape[1], graph_index=rank % shape[1],
                graph_group=group, backend=backend)


def auto_mesh() -> Optional[Mesh]:
    """The default mesh: the whole initialised world on the graph axis
    over the world's own backend, or None when no process group is
    initialised or the world has one rank (the JAX ``auto_mesh`` on one
    device)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return create_mesh(backend=dist.get_backend())


def shard_train_state(state, mesh: Mesh):
    """Cut a whole-graph ``TrainState`` to this rank's part, in place:
    the column window of the chains ((C, n_pad) or the PT ladder
    (T, C, n_pad)) and the row block of the cached coupling (a dense
    tensor, or a ``QuantCoupling``'s int8 rows with its scale).  A packed
    coupling's layout depends on the shard count, so a single-device
    ``BlockSparseCoupling`` (or a packed shard of another mesh) is
    refused: rebuild the cache (``fns.rebuild_cache``).  Everything else
    is replicated and stays as it is.  Returns the state."""
    from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling
    from image_generation_tpu_torch.ops.block_sparse_sharded import (
        ShardedBlockSparseCoupling,
    )
    from image_generation_tpu_torch.ops.quant import QuantCoupling

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
    return state
