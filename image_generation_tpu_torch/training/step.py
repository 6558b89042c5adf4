"""The sampler part of ``image_generation_tpu/training/step.py``.

``make_sample_fns`` builds what generation and serving need from the JAX
``make_train_fns`` closure: ``build_sampler_model`` (scaled, clipped,
permuted model), the single-device ``sweeps_fn`` dispatch and
``sample_fn``.  The training step itself (DVAE update, MMD, the GRBM
schedule) is not ported yet.

Dispatch: a CUDA tensor goes to the sweep kernel K1 (``ops/gibbs_cuda.py``)
and a CPU tensor to the plain ``gibbs_sweeps_reference``;
``USE_PALLAS="off"`` selects the plain version everywhere.  Every case the
JAX package sends to a path that is not ported raises
``NotImplementedError`` naming it, at construction or, for per-shape
gates, at the call.
"""

from __future__ import annotations

from typing import Optional

import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.models.grbm import GRBMGraph, GRBMParams, scaled_ising
from image_generation_tpu_torch.ops.gibbs import (
    GibbsPlan,
    build_plan,
    gibbs_sweeps_reference,
    permuted_model,
    random_spins,
    to_original,
)
from image_generation_tpu_torch.ops.gibbs_cuda import gibbs_sweeps_cuda

__all__ = ["SampleFns", "make_sample_fns"]


class SampleFns:
    """Sampler functions bound to one (config, graph, plan, device)."""

    def __init__(self, cfg: TrainingConfig, graph: GRBMGraph, plan: GibbsPlan,
                 device):
        self.config = cfg
        self.graph = graph
        self.plan = plan
        self.device = torch.device(device)
        self.use_kernel = cfg.USE_PALLAS != "off"
        # observability, as TrainStepFns.sampler_impl in the JAX package
        self.sampler_impl = (
            "cuda_gibbs" if self.use_kernel and self.device.type == "cuda"
            else "torch"
        )

    def build_sampler_model(self, grbm_params: GRBMParams):
        """(hp, coupling_p) of the prefactor-scaled, range-clipped model in
        padded, color-permuted coordinates (f32)."""
        cfg = self.config
        h, j = scaled_ising(grbm_params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE)
        return permuted_model(self.plan, h, j)

    def sweeps_fn(self, generator, hp, coupling_p, chains, n_sweeps, beta=1.0,
                  uniforms=None):
        """One sweep run of ``chains`` (C, n_pad) under (hp, coupling_p)."""
        if self.use_kernel:
            # CPU tensors run the plain version inside the wrapper; CUDA
            # shapes the kernel does not take raise there (K2 not ported)
            return gibbs_sweeps_cuda(
                hp, coupling_p, self.plan, chains, n_sweeps, beta,
                generator=generator, uniforms=uniforms,
            )
        return gibbs_sweeps_reference(
            hp, coupling_p, self.plan, chains, n_sweeps, beta,
            generator=generator, uniforms=uniforms,
        )

    def sample_fn(self, generator: Optional[torch.Generator],
                  grbm_params: GRBMParams, num_reads: int, n_sweeps: int, *,
                  init_spins: Optional[torch.Tensor] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Standalone sampler call for generation (the ``grbm.sample``
        equivalent): ``num_reads`` fresh chains, ``n_sweeps`` sweeps.
        Returns (num_reads, n) spins in original coordinates.

        ``init_spins`` (num_reads, n_pad) and ``uniforms`` (n_sweeps,
        num_reads, n_pad) replace the random start and the random draws:
        the entry the parity tests use."""
        if init_spins is None:
            init_spins = random_spins(generator, self.plan, num_reads, self.device)
        hp, coupling_p = self.build_sampler_model(grbm_params)
        spins = self.sweeps_fn(generator, hp, coupling_p, init_spins, n_sweeps,
                               uniforms=uniforms)
        return to_original(self.plan, spins)


def make_sample_fns(cfg: TrainingConfig, graph: GRBMGraph,
                    plan: Optional[GibbsPlan] = None, device="cpu") -> SampleFns:
    """Sampler functions for a config and coupling graph on ``device``.

    Raises ``NotImplementedError`` for every configuration the JAX
    ``make_train_fns`` sends to a sampler that is not ported."""
    if plan is None:
        plan = build_plan(graph)
    if cfg.SAMPLER == "pt":
        raise NotImplementedError(
            "SAMPLER='pt' (parallel tempering: pt_round/pt_sample) is not ported"
        )
    if cfg.SAMPLER_MATMUL_DTYPE == "int8":
        raise NotImplementedError(
            "SAMPLER_MATMUL_DTYPE='int8' (quantized coupling, ops/quant.py and "
            "K1's int8 mode) is not ported"
        )
    if cfg.resolved_sampler_matmul_dtype(plan.n_pad) is not None:
        raise NotImplementedError(
            f"bf16 sampler coupling (n_pad={plan.n_pad}, "
            f"SAMPLER_MATMUL_DTYPE={cfg.SAMPLER_MATMUL_DTYPE!r}; K1's bf16 "
            f"mode) is not ported"
        )
    if cfg.SWEEP_BLOCK_SPARSE == "on" or (
        cfg.SWEEP_BLOCK_SPARSE == "auto" and plan.n_pad >= 2048
    ):
        raise NotImplementedError(
            "block-sparse sweeps (ops/block_sparse.py, kernel K3) are not ported"
        )
    if cfg.GRAPH_SHARDED == "on":
        raise NotImplementedError(
            "GRAPH_SHARDED='on' needs a multi-device mesh (kernel K4), "
            "which is not ported"
        )
    return SampleFns(cfg, graph, plan, device)
