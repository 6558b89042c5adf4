"""Adam with bf16-stored and factored moments.

Port of ``image_generation_tpu/training/optim.py``
(``scale_by_adam_moments``), as a ``torch.optim.Optimizer`` with the L2
term added to the gradient first (optax's ``add_decayed_weights`` before
the moments) and the LR applied as ``p − lr·update``.  Two opt-in storage
levers shrink the running moments while every operation stays f32:

  * ``moment_dtype=torch.bfloat16``: μ (and any dense ν) are read as f32,
    updated in f32 and stored in bf16 (rounded to nearest even, as XLA
    casts);
  * ``factored_nu_min_size=N``: ν of a 2-D parameter with at least N
    elements is stored as a ``FactoredNu``: EMAs of the row and column
    means of g², two f32 vectors, rebuilt as
    ``outer(row, col) / where(mean(row) > 0, mean(row), 1)``.

Orientation: the JAX factors follow the flax kernel ``(in, out)``, so its
``row`` is the mean over the output axis, length ``in``.  A torch
``nn.Linear.weight`` is ``(out, in)``; ``FactoredNu.row`` keeps JAX's
meaning (length ``in``, the mean over the weight's axis 0) and ``col``
has length ``out``, so ``mean(row)`` is the same vector's mean.

A column-sharded parameter (``parallel/dense.py``: this rank holds a
block of the weight's rows, the output features) keeps its moments'
rows: μ and a dense ν are elementwise and run on the block as they are;
a factored ν's ``col`` is the block's, and its ``row``, a mean over the
output axis, sums g² over every rank's rows (an all-reduce over the mesh)
and divides by the whole weight's row count, so ``row`` and ``mean(row)``
are the same on every rank.  Whether ν is factored is decided on the
whole parameter's size, as JAX decides it on the global leaf.

Memory: XLA fuses the upcast, the EMA and the outer product and never
materialises them.  Here the update runs over row chunks of at most
``_CHUNK_ELEMS`` elements with stock ops, and ``mean(row)`` is taken once
over the whole vector first, so no f32 temporary of a whole 2-D
parameter exists (at the scaled config's ``Linear(5640 → 22560)`` one
would be 509 MB).

The training step uses this optimizer only when a lever is set; the
default f32 path is ``torch.optim.Adam``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FactoredNu", "AdamMoments", "optimizer_state_bytes"]

_CHUNK_ELEMS = 1 << 22  # elements of one row chunk's f32 temporaries (16 MB)


class FactoredNu(NamedTuple):
    """Rank-1 factored second moment of one 2-D parameter, in JAX's
    orientation: ``row`` (in,) and ``col`` (out,), f32."""

    row: torch.Tensor
    col: torch.Tensor


def _chunks(n_rows: int, row_elems: int):
    step = max(1, _CHUNK_ELEMS // max(row_elems, 1))
    for a in range(0, n_rows, step):
        yield a, min(a + step, n_rows)


class AdamMoments(torch.optim.Optimizer):
    """Adam(+L2) with configurable moment storage (the module docstring).

    ``lr`` is set per step by the caller (``param_groups[i]["lr"]``);
    ``weight_decay`` is the L2 factor added to the gradient.  State per
    parameter: ``step`` (an int), ``exp_avg`` (μ, in ``moment_dtype`` or
    the parameter's dtype), and ``exp_avg_sq`` (dense ν, stored as μ) or
    ``nu_row`` / ``nu_col`` (a ``FactoredNu``, f32)."""

    def __init__(self, params: Iterable, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 moment_dtype: Optional[torch.dtype] = None,
                 factored_nu_min_size: Optional[int] = None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.moment_dtype = moment_dtype
        self.factored_nu_min_size = factored_nu_min_size

    def factored(self, p: torch.Tensor) -> bool:
        shard = getattr(p, "column_shard", None)
        numel = p.numel() if shard is None else shard.rows * p.shape[1]
        return (self.factored_nu_min_size is not None and p.ndim == 2
                and numel >= self.factored_nu_min_size)

    def _init_state(self, p: torch.Tensor) -> dict:
        dtype = self.moment_dtype or p.dtype
        state = {"step": 0, "exp_avg": torch.zeros_like(p, dtype=dtype)}
        if self.factored(p):
            state["nu_row"] = torch.zeros(p.shape[1], dtype=torch.float32, device=p.device)
            state["nu_col"] = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
        else:
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=dtype)
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore, then store the moments in their own dtype again
        (``torch.optim.Optimizer`` casts floating state to the parameter's
        dtype; bf16 → f32 → bf16 is exact)."""
        super().load_state_dict(state_dict)
        if self.moment_dtype is None:
            return
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = state[key].to(self.moment_dtype)

    def nu(self, p: torch.Tensor):
        """ν of ``p`` as stored: a tensor or a ``FactoredNu``."""
        st = self.state[p]
        if "nu_row" in st:
            return FactoredNu(st["nu_row"], st["nu_col"])
        return st["exp_avg_sq"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamMoments.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                if not self.state[p]:
                    self.state[p].update(self._init_state(p))
                self._update(p, self.state[p], group["lr"], b1, b2, group["eps"],
                             group["weight_decay"])

    def _update(self, p, st, lr, b1, b2, eps, wd) -> None:
        st["step"] += 1
        # the bias corrections in f32, as JAX's, on the host: a scalar made
        # on the card would wait for the card at every parameter
        count = np.float32(st["step"])
        bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
        grad, mu = p.grad, st["exp_avg"]
        # a 1-D parameter is one row; any other is cut along its first axis
        flat_p, flat_g, flat_mu = (t.view(t.shape[0], -1) if t.ndim else t.view(1, 1)
                                   for t in (p, grad, mu))
        n_rows, row_elems = flat_p.shape

        def g_chunk(a, b):
            g = flat_g[a:b].float()
            return g + wd * flat_p[a:b].float() if wd else g

        fac = "nu_row" in st
        if fac:
            # pass 1: the factors' EMAs from the means of g² (JAX row: the
            # mean over the weight's axis 0; col: over its axis 1)
            row_sum = torch.zeros(row_elems, dtype=torch.float32, device=p.device)
            col_mean = torch.empty(n_rows, dtype=torch.float32, device=p.device)
            for a, b in _chunks(n_rows, row_elems):
                g2 = torch.square(g_chunk(a, b))
                row_sum += g2.sum(0)
                col_mean[a:b] = g2.mean(1)
            shard = getattr(p, "column_shard", None)
            if shard is not None:  # the mean over every rank's rows
                shard.mesh.all_reduce(row_sum, axis=("data", "graph"))
            whole_rows = n_rows if shard is None else shard.rows
            st["nu_row"].mul_(b2).add_((1.0 - b2) * (row_sum / whole_rows))
            st["nu_col"].mul_(b2).add_((1.0 - b2) * col_mean)
            mean = st["nu_row"].mean()
            denom_scale = torch.where(mean > 0, mean, torch.ones_like(mean))
        else:
            flat_nu = st["exp_avg_sq"].view(flat_p.shape)
        # pass 2: μ (and dense ν), the update, the parameter, chunk by chunk
        for a, b in _chunks(n_rows, row_elems):
            g = g_chunk(a, b)
            m = b1 * flat_mu[a:b].float() + (1.0 - b1) * g
            flat_mu[a:b] = m.to(flat_mu.dtype)
            if fac:
                v_hat = torch.outer(st["nu_col"][a:b], st["nu_row"]) / denom_scale
            else:
                v_hat = b2 * flat_nu[a:b].float() + (1.0 - b2) * torch.square(g)
                flat_nu[a:b] = v_hat.to(flat_nu.dtype)
            update = (m / bc1) / (torch.sqrt(v_hat / bc2) + eps)
            flat_p[a:b] -= (lr * update).to(flat_p.dtype)


def optimizer_state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of every tensor in the optimizer's state (the moments)."""
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))
