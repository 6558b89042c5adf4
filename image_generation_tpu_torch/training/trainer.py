"""Trainer: the serving subset of ``image_generation_tpu/training/trainer.py``.

``Trainer(config, device, seed)`` loads a reference-format model directory
and samples from it.  Unlike the JAX ``load`` it reads no dataset: serving
does not need one.  Training, ``generate_output`` and the ``samplers/``
backends are not ported yet.

Random streams: the JAX trainer splits one PRNG key per call; here each
call gets a fresh ``torch.Generator`` on the trainer's device, seeded from
one numpy stream seeded with ``RANDOM_SEED`` (or ``seed``).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.checkpoint import load_model_dir
from image_generation_tpu_torch.models.dvae import DVAE
from image_generation_tpu_torch.ops.gibbs import build_plan
from image_generation_tpu_torch.training.step import make_sample_fns

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, config: Optional[TrainingConfig] = None, device="cpu",
                 seed: Optional[int] = None):
        self.config = config if config is not None else TrainingConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # f32 means f32: TF32 would keep ~3 decimal digits in the f32
            # decode and in the plain sweep's matmul that the kernel is held
            # against. The one reduced precision is COMPUTE_DTYPE's bf16
            # decode, which DVAE asks for through autocast.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.n_latents = self.config.N_LATENTS
        self.graph = None
        self.plan = None
        self.fns = None
        self.dvae: Optional[DVAE] = None
        self.grbm_params = None
        self.losses = {"mse_losses": [], "dvae_losses": []}
        self._seeds = np.random.default_rng(
            self.config.RANDOM_SEED if seed is None else seed
        )
        self._seeds_lock = threading.Lock()

    def _next_generator(self) -> torch.Generator:
        """A fresh generator on the trainer's device (one per call, like
        the JAX trainer's key split)."""
        with self._seeds_lock:
            seed = int(self._seeds.integers(0, 2**63 - 1))
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def load(self, file_path) -> None:
        """Load a reference-format model directory; the coupling graph
        comes from the checkpoint itself."""
        dvae_sd, grbm_params, graph, parameters, losses = load_model_dir(
            file_path, self.device
        )
        if parameters:
            self.n_latents = parameters.get("n_latents", self.n_latents)
            self.config = self.config.replace(N_LATENTS=self.n_latents)
        cfg = self.config
        self.graph = graph
        self.plan = build_plan(graph)
        self.losses = losses
        self.fns = make_sample_fns(cfg, graph, self.plan, self.device)
        dvae = DVAE(
            self.n_latents, cfg.LATENT_TO_DISCRETE,
            dtype=getattr(torch, cfg.COMPUTE_DTYPE),
        )
        dvae.load_state_dict(dvae_sd)
        self.dvae = dvae.to(self.device).eval()
        self.grbm_params = grbm_params

    def sample_spins(self, num_reads: Optional[int] = None,
                     n_sweeps: Optional[int] = None) -> torch.Tensor:
        """(num_reads, n) ±1 spins in original coordinates from the loaded
        GRBM, on the trainer's device."""
        cfg = self.config
        return self.fns.sample_fn(
            self._next_generator(),
            self.grbm_params,
            num_reads or cfg.NUM_READS,
            n_sweeps or (cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS),
        )
