"""Block-Gibbs and parallel-tempering sampler backends.

Port of ``image_generation_tpu/samplers/gibbs_sampler.py``: ``ops/gibbs``
behind the SamplerBackend protocol with a per-graph plan cache.  The
backends build the dense f32 permuted model (``permuted_model``) and sweep
it through K1's wrapper (``ops/gibbs_cuda.gibbs_sweeps_cuda``): on a CUDA
tensor the sparse field gather kernel (``csrc/gibbs_sparse.cu``), counted
under ``"K1-f32"`` (``"K1-f32-dE"`` for the parallel-tempering rungs,
which carry their energies); on a CPU tensor the gather's plain version.
A CUDA problem the kernel does not take raises.  Each call runs exactly
the sweeps asked for, as the JAX backends' XLA ``gibbs_sweeps`` does.

Tensors live on the device of ``h`` (torch tensors; numpy arrays are
taken on the CPU); every draw comes from the ``torch.Generator`` passed
to ``sample``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from image_generation_tpu_torch.models.grbm import GRBMGraph
from image_generation_tpu_torch.ops.gibbs import (
    GibbsPlan,
    build_plan,
    ising_energies,
    permuted_model,
    pt_sample,
    random_spins,
    to_original,
)
from image_generation_tpu_torch.ops.gibbs_cuda import gibbs_sweeps_cuda
from image_generation_tpu_torch.utils.sampleset import SampleSet

__all__ = ["GibbsSampler", "PTSampler"]


class _PlanCache:
    def __init__(self):
        # each value holds its graph too: keying by id() alone is unsafe once
        # a graph is garbage-collected and its address reused
        self._plans: Dict[int, tuple] = {}

    def plan(self, graph: GRBMGraph) -> GibbsPlan:
        entry = self._plans.get(id(graph))
        if entry is None or entry[0] is not graph:
            entry = (graph, build_plan(graph))
            self._plans[id(graph)] = entry
        return entry[1]

    @staticmethod
    def _held(store: Dict[int, tuple], graph: GRBMGraph):
        """The value ``store`` holds for ``graph`` (None if it holds none,
        or one for another graph at the same address)."""
        entry = store.get(id(graph))
        return entry[1] if entry is not None and entry[0] is graph else None

    @staticmethod
    def model(plan: GibbsPlan, h, quadratic):
        """(hp, A_p): the dense f32 permuted model on ``h``'s device."""
        h = torch.as_tensor(h, dtype=torch.float32)
        return permuted_model(plan, h, torch.as_tensor(quadratic, device=h.device))


def _sample_set(plan, hp, cp, chains, info) -> SampleSet:
    return SampleSet(spins=to_original(plan, chains).cpu().numpy(),
                     energies=ising_energies(hp, cp, chains).cpu().numpy(), info=info)


class GibbsSampler(_PlanCache):
    """Block-Gibbs from random chains; optionally persistent chains across
    calls (per graph, while the read count stays the same)."""

    name = "gibbs"

    def __init__(self, n_sweeps: int = 64, persistent: bool = False):
        super().__init__()
        self.n_sweeps = n_sweeps
        self.persistent = persistent
        self._chains: Dict[int, tuple] = {}

    def sample(self, h, quadratic, graph, num_reads, generator, n_sweeps=None, *,
               init_spins: Optional[torch.Tensor] = None,
               uniforms: Optional[torch.Tensor] = None, **_) -> SampleSet:
        """``init_spins`` (num_reads, n_pad) and ``uniforms`` (sweeps,
        num_reads, n_pad) replace the random start and the sweeps' draws."""
        plan = self.plan(graph)
        sweeps = self.n_sweeps if n_sweeps is None else n_sweeps
        hp, cp = self.model(plan, h, quadratic)
        chains = init_spins
        if chains is None and self.persistent:
            chains = self._held(self._chains, graph)
        if chains is None or chains.shape[0] != num_reads:
            chains = random_spins(generator, plan, num_reads, hp.device)
        chains = gibbs_sweeps_cuda(hp, cp, plan, chains.to(hp.device).contiguous(), sweeps,
                                   generator=generator, uniforms=uniforms)
        if self.persistent:
            self._chains[id(graph)] = (graph, chains)
        return _sample_set(plan, hp, cp, chains, {"sampler": self.name, "n_sweeps": sweeps})


class PTSampler(_PlanCache):
    """Parallel tempering: a β ladder with replica exchange; returns the
    target-temperature chains.  For stiff or frustrated models where plain
    Gibbs mixes slowly."""

    name = "pt"

    def __init__(
        self,
        n_betas: int = 8,
        beta_min: float = 0.25,
        n_rounds: int = 16,
        sweeps_per_round: int = 4,
        persistent: bool = False,
        betas=None,
    ):
        super().__init__()
        # an explicit ladder (PT_BETAS, e.g. from the tune-pt command)
        # overrides the geometric one
        self.betas = torch.as_tensor(
            np.asarray(betas if betas is not None else np.geomspace(beta_min, 1.0, n_betas)),
            dtype=torch.float32)
        self.n_rounds = n_rounds
        self.sweeps_per_round = sweeps_per_round
        self.persistent = persistent
        self._ladders: Dict[int, tuple] = {}

    def sample(self, h, quadratic, graph, num_reads, generator, *,
               init_spins: Optional[torch.Tensor] = None, feed=None, **_) -> SampleSet:
        """``init_spins`` (T, num_reads, n_pad) replaces the random ladder
        and ``feed`` every round's draws (``pt_sample``'s)."""
        plan = self.plan(graph)
        hp, cp = self.model(plan, h, quadratic)
        betas = torch.as_tensor(self.betas, dtype=torch.float32).to(hp.device)
        init = init_spins
        if init is None and self.persistent:
            init = self._held(self._ladders, graph)
        if init is not None and tuple(init.shape[:2]) != (len(betas), num_reads):
            init = None

        def sweeps_fn(g, h_, c_, s_, n_, beta_, uniforms=None, track_delta_e=False):
            return gibbs_sweeps_cuda(h_, c_, plan, s_, n_, beta_, generator=g,
                                     uniforms=uniforms, track_delta_e=track_delta_e)

        target, ladder = pt_sample(
            generator, hp, cp, plan, num_reads, betas, self.n_rounds, self.sweeps_per_round,
            init_spins=None if init is None else init.to(hp.device), sweeps_fn=sweeps_fn,
            feed=feed)
        if self.persistent:
            self._ladders[id(graph)] = (graph, ladder)
        return _sample_set(plan, hp, cp, target, {
            "sampler": self.name, "n_betas": int(betas.shape[0]), "n_rounds": self.n_rounds})
