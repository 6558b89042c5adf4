"""The column-sharded dense layer: outsized DVAE dense layers split over
the mesh.

Port of the JAX ``parallel/mesh.py`` ``_shard_large_dense``: a 2-D DVAE
leaf of at least ``min_elems`` elements whose output features tile the
mesh is column-sharded over the whole mesh, and its Adam moments with it.
At the scaled config that is the decoder's ``increase_latent_dim``,
Linear(5640 → 22560), 127M parameters: 509 MB in f32 on every rank
replicated, and as much again in each moment.  Flax's kernel is
``(in, out)``, so its columns are the rows (output features) of the
torch ``nn.Linear.weight``: the rank at row-major place k of ``(data,
graph)`` (``Mesh.rank``, the JAX ``P(None, ("data", "chain"))`` order)
holds ``weight[k·out/P : (k+1)·out/P]``.  The bias (1-D) stays replicated,
as JAX shards only 2-D leaves, and so does a leaf that does not tile.

``ColumnShardedLinear`` takes the ``nn.Linear``'s place (the same
``weight`` and ``bias`` parameters, the weight cut to this rank's rows).
Its product (``_ColumnShardedMatmul``):

  * forward: each rank gives its rows of the input and gets its rows × all
    output features.  When the rows are this rank's slice of the global
    batch along ``data`` (``rows_split_over_data``, the data-parallel
    step), the input is gathered over ``data`` first; this rank's column
    block of the product is taken for every row, the blocks are gathered
    over the whole mesh, and this rank's rows kept.  Otherwise every rank
    holds the same rows and no input gather is needed.
  * backward: the output gradient is gathered over ``data`` only (the
    ranks of one data row hold the same slice and the same gradient), the
    weight's gradient is this rank's columns of it against the gathered
    input (whole: nothing sums it again, so ``training/step.py`` leaves it
    out of its all-reduce), and the input's gradient is the column blocks'
    partial products summed over the mesh, this rank's rows kept.

Under bf16 autocast the product keeps autocast's casts (bf16 operands,
f32 accumulation, a bf16 output), and the partial input gradients are
summed in f32.  Under gloo the gathers of CUDA tensors go through the
host (``Mesh.all_gather``), counted in ``Mesh.comm_seconds``.

Across the boundary the layer is whole: ``gather_large_dense`` (collective)
gives a state dict with every sharded weight whole, bit for bit, under the
``nn.Linear``'s names; loading a whole weight into a sharded layer keeps
this rank's rows; ``gather_optimizer_state`` / ``cut_optimizer_state`` do
the same for the moments (μ, a dense ν, a factored ν's column factor).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch import nn

__all__ = [
    "ColumnShard",
    "ColumnShardedLinear",
    "shard_large_dense",
    "gather_large_dense",
    "gather_optimizer_state",
    "cut_optimizer_state",
    "rows_split_over_data",
    "DENSE_MIN_ELEMS",
]

DENSE_MIN_ELEMS = 1 << 23  # the JAX shard_train_state's dense_min_elems
WHOLE_MESH = ("data", "graph")
# the optimizer state of a parameter that has its rows: μ, a dense ν, and
# a factored ν's column (output) factor; the row factor is replicated
ROW_STATE = ("exp_avg", "exp_avg_sq", "nu_col")
_SPLIT = threading.local()  # this thread's: are a layer's rows a data slice


@dataclass(frozen=True, eq=False)
class ColumnShard:
    """Which rows of a whole ``(rows, in)`` weight this rank holds: block
    ``mesh.rank`` of ``mesh.size``.  Set on the parameter as
    ``column_shard``."""

    mesh: object
    rows: int

    @property
    def lo(self) -> int:
        return self.mesh.rank * (self.rows // self.mesh.size)

    @property
    def hi(self) -> int:
        return self.lo + self.rows // self.mesh.size

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's rows (collective)."""
        return self.mesh.all_gather(t.detach(), dim=0, axis=WHOLE_MESH)

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor (a local one as it is)."""
        return t[self.lo:self.hi].contiguous() if t.shape[0] == self.rows else t


@contextmanager
def rows_split_over_data():
    """Within the block, the rows a column-sharded layer is given are this
    rank's slice of the global batch along the mesh's data axis."""
    prev = getattr(_SPLIT, "on", False)
    _SPLIT.on = True
    try:
        yield
    finally:
        _SPLIT.on = prev


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    kind = x.device.type
    if torch.is_autocast_enabled(kind):
        return torch.get_autocast_dtype(kind)
    return x.dtype


class _ColumnShardedMatmul(torch.autograd.Function):
    """y = x @ Wᵀ + b for this rank's rows of x, with W column-sharded
    over the mesh (the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, shard, split):
        mesh, dt = shard.mesh, _compute_dtype(x)
        rows = x.shape[0]
        with torch.autocast(x.device.type, enabled=False):
            xg = (mesh.all_gather(x, dim=0, axis="data") if split else x).to(dt)
            wk = weight.to(dt)
            yk = torch.nn.functional.linear(xg, wk, bias[shard.lo:shard.hi].to(dt))
        y = mesh.all_gather(yk, dim=-1, axis=WHOLE_MESH)
        if split:
            y = y[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        ctx.save_for_backward(xg, wk)
        ctx.shard, ctx.split, ctx.rows = shard, split, rows
        ctx.dtypes = (x.dtype, weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        xg, wk = ctx.saved_tensors
        shard, mesh, rows = ctx.shard, ctx.shard.mesh, ctx.rows
        x_dt, w_dt, b_dt = ctx.dtypes
        gy = gy.to(wk.dtype)
        db = gy.sum(0).to(b_dt)  # this rank's rows: summed over data with the rest
        gyg = mesh.all_gather(gy, dim=0, axis="data") if ctx.split else gy
        gk = gyg[:, shard.lo:shard.hi]
        dw = (gk.t() @ xg).to(w_dt)
        dx = mesh.all_reduce((gk @ wk).float(), axis=WHOLE_MESH)
        if ctx.split:
            dx = dx[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return dx.to(wk.dtype).to(x_dt), dw, db, None, None


class ColumnShardedLinear(nn.Module):
    """An ``nn.Linear`` whose weight is column-sharded over the mesh: its
    ``weight`` holds this rank's rows of the whole weight, ``bias`` is
    whole.  Maps (..., in) to (..., out) for this rank's rows."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter, shard: ColumnShard):
        super().__init__()
        self.weight, self.bias, self.shard = weight, bias, shard
        self.in_features, self.out_features = weight.shape[1], shard.rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = _ColumnShardedMatmul.apply(x.reshape(-1, x.shape[-1]), self.weight, self.bias,
                                       self.shard, getattr(_SPLIT, "on", False))
        return y.reshape(*lead, self.out_features)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "weight"
        if key in state_dict:  # a whole weight: keep this rank's rows
            state_dict[key] = self.shard.cut(state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def shard_large_dense(module: nn.Module, mesh, min_elems: int = DENSE_MIN_ELEMS,
                      opt=None) -> nn.Module:
    """Column-shard, in place, every ``nn.Linear`` of ``module`` whose
    weight has at least ``min_elems`` elements and whose output features
    tile ``mesh`` (the JAX rule): its weight's data is cut to this rank's
    rows (the parameter keeps its identity, so an optimizer over it stays
    valid) and ``opt``'s moments of it with it; the layer becomes a
    ``ColumnShardedLinear``.  No-op without a mesh of more than one rank.
    Returns ``module``."""
    if mesh is None or mesh.size == 1 or module is None:
        return module
    targets = [(name, m) for name, m in module.named_modules()
               if type(m) is nn.Linear and m.weight.numel() >= min_elems
               and m.weight.shape[0] % mesh.size == 0]
    for name, lin in targets:
        shard = ColumnShard(mesh, lin.weight.shape[0])
        with torch.no_grad():
            lin.weight.data = shard.cut(lin.weight.data)
        lin.weight.column_shard = shard
        if opt is not None and lin.weight in opt.state:
            st = opt.state[lin.weight]
            for key in ROW_STATE:
                if key in st:
                    st[key] = shard.cut(st[key])
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, child,
                ColumnShardedLinear(lin.weight, lin.bias, shard))
    return module


def gather_large_dense(module: nn.Module) -> dict:
    """``module.state_dict()`` with every column-sharded weight whole, on
    every rank (collective: every rank of the mesh calls it)."""
    sd = module.state_dict()
    for name, m in module.named_modules():
        if isinstance(m, ColumnShardedLinear):
            sd[f"{name}.weight"] = m.shard.gather(m.weight)
    return sd


def _params(opt) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def _map_row_state(opt, sd: dict, fn) -> dict:
    state = dict(sd["state"])
    for i, p in enumerate(_params(opt)):
        shard = getattr(p, "column_shard", None)
        if shard is None or i not in state:
            continue
        state[i] = {k: fn(shard, v) if k in ROW_STATE else v for k, v in state[i].items()}
    return dict(sd, state=state)


def gather_optimizer_state(opt) -> dict:
    """``opt.state_dict()`` with the moments of every column-sharded
    parameter whole (collective); the live state is not touched."""
    return _map_row_state(opt, opt.state_dict(), lambda s, v: s.gather(v))


def cut_optimizer_state(opt, sd: dict) -> dict:
    """A state dict of ``opt``'s parameters with whole moments, cut to
    this rank's rows where ``opt``'s parameter is column-sharded."""
    return _map_row_state(opt, sd, lambda s, v: s.cut(v))
