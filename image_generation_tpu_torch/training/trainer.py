"""Trainer: the reference ``ModelWrapper`` surface on PyTorch.

Port of ``image_generation_tpu/training/trainer.py``: ``setup`` selects the
latent coupling graph, ``train_init(n_epochs)`` builds the step functions,
schedules and chains, ``step`` / ``train_epoch`` / ``train`` train, ``save``
writes a reference-format model directory and ``load`` reads one, with the
dataset and a train state around its weights (``load_train_state``).
Tuning (``load`` then ``train_init``) keeps the loaded weights, builds
fresh optimizers and schedules and burns in fresh chains under the loaded
GRBM.  Generation: ``sampler_backend`` (the ``samplers/`` backend in the
persistent sample cache), ``sample_sampleset``, ``generate_output``,
``generate_reconstructed_samples`` and ``generate_loss_plot``.
``train`` writes a per-epoch JSONL record (``metrics_log``), a profiler
trace (``profile_dir``) and a native checkpoint per epoch
(``checkpoint_dir``); ``save_native`` / ``resume_native`` are the
full-state checkpoints (``io/native_ckpt.py``).  ``PT_NUM_BETAS="auto"``
is resolved at ``train_init`` and ``load`` by a swap-acceptance probe of
the model the sampler will run (``ops/pt_tune.size_ladder``), through the
sweep dispatch.

On a mesh (``mesh=``, ``parallel/mesh.py``; by default ``"auto"``: the
initialised ``torch.distributed`` world in the JAX default shape, or one
device) every rank of the world runs its own Trainer with the same config
and seed.  Each step trains this rank's slice of the global batch along
the data axis (when the batch tiles it), the chains are split over the
mesh (``GRAPH_SHARDED`` splits the coupling rows and chain columns over
the graph axis instead; ``training/step.py``), the DVAE and the GRBM are
replicated (cuDNN is set deterministic, so every rank computes the same
bits) but for an outsized dense layer, which is column-sharded over the
mesh with its moments (``parallel/dense.py``), ``save`` gathers that
layer on every rank and writes on rank 0 only, ``sample_spins`` samples
through the partitioned sampler, and generation decodes through the
sharded layer on every rank.  Native checkpoints are topology-independent
(``io/native_ckpt.py``): every rank takes part in ``save_native``, rank
0 writes the global state in the one-device schema, and ``resume_native``
restores such a file on any mesh or on one device.  The auto ladder's
probe runs on every rank alike, from the trainer's shared seeds.

The trainer runs on the card unless it is given ``device="cpu"``; with no
card visible a CUDA trainer raises.  The dataset lives on the trainer's
device.

Random streams: the JAX trainer splits one PRNG key per call; here each
call gets a fresh ``torch.Generator`` on the trainer's device, seeded from
one numpy stream seeded with ``RANDOM_SEED`` (or ``seed``).  A native
checkpoint holds that stream's state too, so a resumed run draws what the
uninterrupted run would have drawn (the JAX trainer restarts its key at
resume).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.io.checkpoint import (
    load_model_dir,
    make_parameters_json,
    save_model_dir,
)
from image_generation_tpu_torch.models.dvae import DVAE
from image_generation_tpu_torch.ops.gibbs import build_plan
from image_generation_tpu_torch.training.step import (
    TrainState,
    make_sample_fns,
    make_train_fns,
)
from image_generation_tpu_torch.parallel.mesh import auto_mesh
from image_generation_tpu_torch.utils.data import get_dataset, permuted_epoch
from image_generation_tpu_torch.utils.device import resolve_device
from image_generation_tpu_torch.utils.grid import interleave, make_grid, sharpen

__all__ = ["Trainer", "TrainingError"]


class TrainingError(Exception):
    """Raised when stepping before initialization."""


class Trainer:
    def __init__(self, config: Optional[TrainingConfig] = None, device="cuda",
                 seed: Optional[int] = None, mesh="auto"):
        """``device`` is where everything runs (the card unless ``"cpu"``);
        ``seed`` replaces ``RANDOM_SEED`` for the trainer's random streams;
        ``mesh``: ``"auto"`` (``parallel.mesh.auto_mesh``: the initialised
        world, or None on one rank or without a process group), None (one
        device) or a ``Mesh``."""
        config = config if config is not None else TrainingConfig()
        self.config = config
        self.qpu = config.QPU
        self.n_latents = config.N_LATENTS
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 means f32: TF32 would keep ~3 decimal digits in the f32
            # paths and in the plain sweep the kernel is held against. The
            # one reduced precision is COMPUTE_DTYPE's bf16, asked for
            # through autocast.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.mesh = auto_mesh() if mesh == "auto" else mesh
        if self.mesh is not None and self.device.type == "cuda":
            # the ranks compute the replicated DVAE step each on its own:
            # deterministic cuDNN keeps their weights the same bits
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.graph = None
        self.plan = None
        self.fns = None
        self.state: Optional[TrainState] = None
        self.dvae: Optional[DVAE] = None
        self.grbm_params = None
        self.images = None
        self.data_source = None
        self.losses = {"mse_losses": [], "dvae_losses": []}
        self.physical_nodes = None  # physical qubit id per logical spin
        self._n_epochs = 0
        self._init_done = False
        self._resume_start_epoch = 0  # set by resume_native, consumed by train
        self.pt_auto_info = None  # the PT_NUM_BETAS="auto" probe's summary
        self._seed = self.config.RANDOM_SEED if seed is None else seed
        self._seeds = np.random.default_rng(self._seed)
        self._seeds_lock = threading.Lock()
        self._backend = None  # sampler_backend's, built at first use
        self._backend_params = None  # the GRBM tensors (and versions) it sampled

    def _next_seed(self) -> int:
        with self._seeds_lock:
            return int(self._seeds.integers(0, 2**63 - 1))

    def _next_generator(self) -> torch.Generator:
        """A fresh generator on the trainer's device (one per call, like
        the JAX trainer's key split)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self._next_seed())
        return g

    # ------------------------------------------------------------------
    # setup / data
    # ------------------------------------------------------------------
    def setup(self) -> None:
        """Select the latent coupling graph for the configured QPU."""
        cfg = self.config
        if cfg.LATENT_TO_DISCRETE == "heaviside" and cfg.N_REPLICAS != 1:
            raise ValueError("heaviside latent-to-discrete can only be used with n_replicas=1")
        from image_generation_tpu_torch.utils.graph_cache import cached_latent_graph

        self.graph, self.physical_nodes = cached_latent_graph(
            self.qpu, self.n_latents, cfg.RANDOM_SEED)
        self.plan = build_plan(self.graph)

    def _load_dataset(self) -> None:
        cfg = self.config
        self.images, self.data_source = get_dataset(cfg.IMAGE_SIZE, cfg.DATASET_SIZE,
                                                    device=self.device)

    @property
    def n_batches(self) -> int:
        return int(self.images.shape[0]) // self.config.BATCH_SIZE

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def train_init(self, n_epochs: int) -> None:
        """Build schedules, optimizers and chains for an ``n_epochs`` run.
        Weights already held (loaded, or from an earlier run) are kept."""
        self.losses["mse_losses"].clear()
        self.losses["dvae_losses"].clear()
        self._seeds = np.random.default_rng(self._seed)
        keep = self.dvae is not None
        if self.graph is None:
            self.setup()
        if self.images is None:
            self._load_dataset()
        self._n_epochs = n_epochs
        self._resume_start_epoch = 0
        seed = self._next_seed()  # the state's: its generator, a fresh run's init
        self._resolve_auto_ladder(self.grbm_params if keep else None, init_seed=seed)
        self.fns = make_train_fns(self.config, self.graph, n_epochs * self.n_batches,
                                  self.plan, device=self.device, mesh=self.mesh)
        if keep:  # tune mode: fresh optimizers, chains burned in under the loaded GRBM
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            self.state = self.fns.state_from(self.dvae, self.grbm_params,
                                             self.fns.new_chains(g), g, burn_in=True)
        else:
            self.state = self.fns.init(seed)
        self.dvae, self.grbm_params = self.state.dvae, self.state.grbm_params
        self._init_done = True

    def _resolve_auto_ladder(self, grbm_params=None, init_seed: Optional[int] = None) -> None:
        """``PT_NUM_BETAS="auto"``: size the ladder by a short swap-acceptance
        probe of the model (``ops/pt_tune.size_ladder``) and freeze it into
        the config (``PT_BETAS``, hence ``PT_NUM_BETAS``) before the step
        functions are built; records ``pt_auto_info``.  No-op unless
        ``SAMPLER="pt"`` and ``PT_NUM_BETAS="auto"``.

        ``grbm_params``: the model to probe (a loaded or tuned model), or
        None for the small random initial model a fresh run starts from,
        drawn as ``init(init_seed)`` draws it.  The probe samples that
        model as training will: built by the dispatch's
        ``build_sampler_model`` (quantized under int8, cast under bf16,
        packed where block sparsity applies) and swept through its
        ``sweeps_fn``, so on the card it launches the kernel training
        would."""
        cfg = self.config
        if cfg.SAMPLER != "pt" or cfg.PT_NUM_BETAS != "auto":
            return
        # the probe builds a dense replicated coupling (> 2 GiB in f32 is the
        # beyond-one-device size, as in the JAX package) and has no
        # graph-sharded route.  On a mesh every rank runs the one-device
        # probe alike (the same seeds, the same kernel on the same inputs),
        # so every rank freezes the same ladder.
        if cfg.GRAPH_SHARDED == "on" or self.plan.n_pad ** 2 * 4 > 2 << 30:
            raise ValueError(
                "PT_NUM_BETAS='auto' cannot probe a beyond-HBM (graph-sharded) model at "
                "init; run the tune-pt CLI command (which measures through the "
                "graph-sharded layout) and pass its ladder as PT_BETAS / --pt-betas"
            )
        from image_generation_tpu_torch.ops.pt_tune import size_ladder

        t_probe = 16  # size_ladder's default probe ladder
        probe_fns = make_sample_fns(cfg.replace(PT_NUM_BETAS=t_probe), self.graph, self.plan,
                                    self.device)
        if grbm_params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self._next_seed() if init_seed is None else init_seed)
            grbm_params = self.graph.init_params(g, device=self.device)
        hp, coupling = probe_fns.build_sampler_model(grbm_params)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.default_rng([self._seed, 73]).integers(2**63 - 1)))
        betas, diag = size_ladder(g, hp, coupling, self.plan, beta_min=cfg.PT_BETA_MIN,
                                  t_probe=t_probe, sweeps_fn=probe_fns.sweeps_fn)
        self.pt_auto_info = {
            "num_betas": int(len(betas)),
            "probe_barrier": round(float(diag.barrier), 4),
            "probe_rungs": int(len(diag.betas)),
            "probe_sampler": probe_fns.sampler_impl,
        }
        self.config = cfg.replace(PT_BETAS=tuple(float(b) for b in betas))

    def step(self, batch, epoch: int) -> float:
        """Train on one batch; returns its MSE loss."""
        if not self._init_done:
            raise TrainingError("Initialization required before training.")
        images = batch[0] if isinstance(batch, (tuple, list)) else batch
        images = images.to(self.device)
        metrics = self.fns.step_body(self.state, images, epoch)
        mse = float(metrics.mse)
        self.losses["mse_losses"].append(mse)
        self.losses["dvae_losses"].append(float(metrics.dvae_loss))
        return mse

    def train_epoch(self, epoch: int, batch_cb=None, n_chunks: int = 1) -> dict:
        """One epoch over a fresh permutation of the dataset.  The step
        metrics stay on the device until the epoch ends.  ``n_chunks`` > 1
        splits the epoch into equal chunks (the largest divisor of
        n_batches ≤ n_chunks) and calls ``batch_cb(batches_done,
        n_batches)`` between them."""
        if not self._init_done:
            raise TrainingError("Initialization required before training.")
        batches = permuted_epoch(self.images, self.config.BATCH_SIZE, self._next_generator())
        nb = int(batches.shape[0])
        k = max(1, min(int(n_chunks), nb))
        while nb % k:
            k -= 1
        chunk = nb // k
        parts = []
        for i in range(k):
            _, m = self.fns.epoch(self.state, batches[i * chunk:(i + 1) * chunk], epoch)
            parts.append(m)
            if batch_cb is not None and k > 1:
                batch_cb((i + 1) * chunk, nb)
        metrics = {f: torch.cat([p[f] for p in parts]).cpu().numpy() for f in parts[0]}
        mses, totals = metrics["mse"], metrics["dvae_loss"]
        self.losses["mse_losses"].extend(mses.tolist())
        self.losses["dvae_losses"].extend(totals.tolist())
        stats = {"mse": float(mses.mean()), "dvae_loss": float(totals.mean())}
        acc = metrics["pt_accept"]  # (n_batches, T-1); width 0 outside PT
        if acc.size:
            from image_generation_tpu_torch.ops.pt_tune import recommend_num_betas

            acc = acc.mean(axis=0)
            stats["pt_accept_min"] = float(acc.min())
            stats["pt_accept_mean"] = float(acc.mean())
            stats["pt_recommended_num_betas"] = recommend_num_betas(acc)
            if self.config.PT_ADAPT == "epoch":
                stats["pt_betas"] = self._adapt_pt_betas(acc)
        return stats

    def _adapt_pt_betas(self, accept) -> list:
        """``PT_ADAPT="epoch"``: one equal-barrier re-spacing of the live
        ladder from the epoch's mean per-pair acceptance.  The carried
        energies stay valid: an Ising energy does not depend on β."""
        from image_generation_tpu_torch.ops.pt_tune import respace_betas

        cur = self.state.pt_betas.double().cpu().numpy()
        new = respace_betas(cur, accept)
        self.state.pt_betas = torch.tensor(new, dtype=torch.float32, device=self.device)
        return [round(float(b), 5) for b in new]

    def current_lrs(self) -> tuple:
        """(DVAE LR, GRBM LR) at the current step."""
        s = self.state.opt_step
        return float(self.fns.dvae_lr(s)), float(self.fns.grbm_lr(s))

    def train(self, n_epochs: int,
              progress_cb: Optional[Callable[[int, int], None]] = None,
              epoch_cb: Optional[Callable[[int, dict], None]] = None,
              metrics_log=None, profile_dir: Optional[str] = None,
              checkpoint_dir: Optional[str] = None,
              batch_cb: Optional[Callable[[int, int, int], None]] = None,
              epoch_chunks: int = 1, start_epoch: Optional[int] = None) -> dict:
        """The full epoch loop.

        ``metrics_log``: an ``observability.MetricsLog`` that gets one
        ``"epoch"`` record per epoch; ``profile_dir``: a ``torch.profiler``
        trace of the run written there; ``checkpoint_dir``: a native
        checkpoint (``save_native``) after every epoch.  ``start_epoch``:
        the first epoch index; by default the epoch a ``resume_native``-d
        run stopped in, else 0.  That resume hint is consumed by the first
        ``train`` call after ``resume_native`` whether or not it passes
        ``start_epoch``, so a later call starts at 0 again."""
        from image_generation_tpu_torch.training.observability import profile

        if not self._init_done or self._n_epochs != n_epochs:
            self.train_init(n_epochs)
        hint, self._resume_start_epoch = self._resume_start_epoch, 0
        if start_epoch is None:
            start_epoch = hint
        with profile(profile_dir):
            for epoch in range(start_epoch, n_epochs):
                t0 = time.perf_counter()
                cb = ((lambda done, nb, e=epoch: batch_cb(e, done, nb))
                      if batch_cb is not None else None)
                stats = self.train_epoch(epoch, batch_cb=cb, n_chunks=epoch_chunks)
                # train_epoch ends in a device-to-host copy of the metrics,
                # so this clock covers the epoch's device work
                stats["epoch_time_s"] = time.perf_counter() - t0
                stats["images_per_s"] = (self.n_batches * self.config.BATCH_SIZE
                                         / stats["epoch_time_s"])
                if metrics_log is not None:
                    metrics_log.log("epoch", epoch=epoch, **stats)
                if checkpoint_dir is not None:
                    self.save_native(checkpoint_dir)
                if progress_cb:
                    progress_cb(epoch + 1, n_epochs)
                if epoch_cb:
                    epoch_cb(epoch, stats)
        return {"final_mse": self.losses["mse_losses"][-1],
                "final_dvae_loss": self.losses["dvae_losses"][-1]}

    # ------------------------------------------------------------------
    # persistence (reference checkpoint format)
    # ------------------------------------------------------------------
    def save(self, file_path, n_epochs: Optional[int] = None,
             old_losses: Optional[dict] = None):
        """Write the model directory; ``old_losses`` (tune mode) is
        prepended to this run's loss history.  On a mesh every rank calls
        it: the column-sharded dense layers are gathered whole
        (collective), rank 0 writes, and every rank waits for it."""
        cfg = self.config
        losses = self.losses
        if old_losses:
            losses = {k: old_losses[k] + losses[k] for k in ("mse_losses", "dvae_losses")}
        parameters = make_parameters_json(
            n_latents=self.n_latents,
            n_epochs=n_epochs if n_epochs is not None else self._n_epochs,
            prefactor=cfg.PREFACTOR, qpu=self.qpu, num_reads=cfg.NUM_READS,
            loss_function=cfg.LOSS_FUNCTION, image_size=cfg.IMAGE_SIZE,
            batch_size=cfg.BATCH_SIZE, dataset_size=cfg.DATASET_SIZE,
            random_seed=cfg.RANDOM_SEED,
        )
        if self.physical_nodes is not None:
            parameters["physical_nodes"] = [int(p) for p in self.physical_nodes]
        if self.data_source is not None:
            parameters["data_source"] = self.data_source.origin
        if self.mesh is None:
            return save_model_dir(file_path, self.dvae, self.grbm_params, self.graph,
                                  parameters, losses)
        from image_generation_tpu_torch.parallel.dense import gather_large_dense

        dvae_sd = gather_large_dense(self.dvae)
        out = None
        if self.mesh.rank == 0:
            out = save_model_dir(file_path, dvae_sd, self.grbm_params, self.graph,
                                 parameters, losses)
        self.mesh.barrier()
        return out if out is not None else Path(file_path)

    def save_native(self, directory) -> Path:
        """A native checkpoint of the full train state (``io/native_ckpt.py``:
        weights, optimizers, chains and ladder energies, ``pt_betas``,
        ``opt_step``, the state's generator and the trainer's seed stream)
        under ``directory/step_<opt_step>.pt``, the loss history beside it
        as ``losses_step_<opt_step>.json``.  Returns the checkpoint's path.
        On a mesh every rank calls it, and rank 0 writes the global state
        (``io/native_ckpt.py``)."""
        from image_generation_tpu_torch.io.native_ckpt import save_train_state

        if not self._init_done:
            raise TrainingError("Initialization required before saving the train state.")
        path = save_train_state(directory, self.state, fns=self.fns,
                                extra={"seed_stream": self._seeds.bit_generator.state})
        if self.mesh is None or self.mesh.rank == 0:
            (path.parent / f"losses_{path.stem}.json").write_text(json.dumps(self.losses))
        if self.mesh is not None:  # no rank resumes before the history is written
            self.mesh.barrier()
        return path

    def resume_native(self, directory, n_epochs: int) -> int:
        """Resume an interrupted run: build the step functions for
        ``n_epochs`` (the LR schedules depend on it), restore the latest
        native checkpoint under ``directory`` over the fresh state (the
        sampler cache is rebuilt from the restored GRBM), its loss history
        and seed stream; the next ``train`` starts at the epoch the run
        stopped in.  The checkpoint may come from any mesh or one device; on
        a mesh each rank keeps its part.  Returns the restored
        ``opt_step``."""
        from image_generation_tpu_torch.io.native_ckpt import (
            latest_step,
            load_payload,
            restore_payload,
        )

        if not self._init_done or self._n_epochs != n_epochs:
            self.train_init(n_epochs)
        step = latest_step(directory)
        payload = load_payload(directory, step, map_location=self.device)
        self.state = restore_payload(payload, self.state, rebuild_cache=self.fns.rebuild_cache,
                                     fns=self.fns)
        self.dvae, self.grbm_params = self.state.dvae, self.state.grbm_params
        seeds = payload["extra"].get("seed_stream")
        if seeds is not None:
            self._seeds.bit_generator.state = seeds
        losses = Path(directory) / f"losses_step_{step:08d}.json"
        if losses.exists():
            self.losses = json.loads(losses.read_text())
        self._resume_start_epoch = self.state.opt_step // max(self.n_batches, 1)
        return self.state.opt_step

    def load(self, file_path, train_state: bool = True) -> None:
        """Load a reference-format model directory for sampling (and for
        tuning: ``train_init`` afterwards keeps these weights).  The
        coupling graph comes from the checkpoint itself.  With
        ``train_state`` (the JAX ``load``) it also loads the dataset and
        builds a train state around the weights (``load_train_state``);
        warm serving leaves both out."""
        dvae_sd, grbm_params, graph, parameters, losses = load_model_dir(
            file_path, self.device)
        if parameters:
            self.n_latents = parameters.get("n_latents", self.n_latents)
            self.config = self.config.replace(N_LATENTS=self.n_latents)
            if parameters.get("qpu"):
                self.qpu = parameters["qpu"]
            self.physical_nodes = parameters.get("physical_nodes")
        self.graph = graph
        self.plan = build_plan(graph)
        self.losses = losses
        self._resolve_auto_ladder(grbm_params)
        cfg = self.config
        self.fns = make_sample_fns(cfg, graph, self.plan, self.device, mesh=self.mesh)
        dvae = DVAE(self.n_latents, cfg.LATENT_TO_DISCRETE,
                    dtype=getattr(torch, cfg.COMPUTE_DTYPE), gumbel_tau=cfg.GUMBEL_TAU)
        dvae.load_state_dict(dvae_sd)
        self.dvae = dvae.to(self.device).eval()
        self.grbm_params = grbm_params
        self.state = None
        self._init_done = False
        self._n_epochs_loaded = parameters.get("n_epochs", 1) if parameters else 1
        if train_state:
            self.load_train_state()

    def load_train_state(self) -> None:
        """After ``load``: the dataset, the training functions for the
        checkpoint's epoch count and a train state around the loaded weights
        (fresh optimizers, chains burned in under the loaded GRBM), as the
        JAX ``load`` builds them, so the reconstruction grid,
        ``current_lrs`` and ``step`` work.  Its generator is seeded aside
        from the trainer's stream, so sampling after it draws what it drew
        before."""
        if self.images is None:
            self._load_dataset()
        total_steps = max(self._n_epochs_loaded or 1, 1) * max(self.n_batches, 1)
        self.fns = make_train_fns(self.config, self.graph, total_steps, self.plan,
                                  device=self.device, mesh=self.mesh)
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.default_rng([self._seed, 1]).integers(2**63 - 1)))
        self.state = self.fns.state_from(self.dvae, self.grbm_params, self.fns.new_chains(g),
                                         g, burn_in=True)
        self._init_done = True

    def sample_spins(self, num_reads: Optional[int] = None,
                     n_sweeps: Optional[int] = None) -> torch.Tensor:
        """(num_reads, n) ±1 spins in original coordinates from the current
        GRBM, on the trainer's device (under PT, at the live ladder); on a
        mesh through the partitioned sampler, the same on every rank."""
        cfg = self.config
        betas = self.state.pt_betas if (self.state is not None and self.fns.pt_mode) else None
        return self.fns.sample_fn(
            self._next_generator(), self.grbm_params, num_reads or cfg.NUM_READS,
            n_sweeps or (cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS), betas=betas,
        )

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def sampler_backend(self):
        """The configured sampler backend (``samplers/``: gibbs / pt /
        exact) in the persistent sample cache, built once per Trainer from
        the config (MAX_DEQUE_SIZE, ITERATIONS_BEFORE_RESAMPLING)."""
        if self._backend is None:
            from image_generation_tpu_torch.samplers.base import get_sampler
            from image_generation_tpu_torch.samplers.persistent import PersistentSampleCache

            cfg = self.config
            if cfg.SAMPLER == "pt":
                backend = get_sampler("pt", sweeps_per_round=max(cfg.GIBBS_SWEEPS, 1),
                                      persistent=cfg.PERSISTENT_CHAINS,
                                      betas=cfg.initial_pt_betas())
            elif cfg.SAMPLER == "exact":
                backend = get_sampler("exact")
            else:
                backend = get_sampler("gibbs", n_sweeps=cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS,
                                      persistent=cfg.PERSISTENT_CHAINS)
            self._backend = PersistentSampleCache(backend, cfg.MAX_DEQUE_SIZE,
                                                  cfg.ITERATIONS_BEFORE_RESAMPLING)
        return self._backend

    def sample_sampleset(self, num_reads: Optional[int] = None):
        """One sampling call through the backend protocol: a SampleSet
        (spins and energies) of the current GRBM.  The sample cache is reset
        whenever the GRBM parameters changed since it was filled (other
        tensors, or the same ones updated in place by training).  Under
        graph sharding it samples through the partitioned sampler
        (``sample_spins``) and computes energies edge-wise, never building
        the dense coupling; under PT the backend runs the live ladder."""
        from image_generation_tpu_torch.models.grbm import GRBMParams, energy, scaled_ising
        from image_generation_tpu_torch.utils.sampleset import SampleSet

        lin, quad = self.grbm_params.linear, self.grbm_params.quadratic
        stamp = (lin._version, quad._version)
        held = self._backend_params
        if held is None or held[0] is not lin or held[1] is not quad or held[2] != stamp:
            self.sampler_backend().reset()
            self._backend_params = (lin, quad, stamp)

        cfg = self.config
        n = num_reads or cfg.NUM_READS
        with torch.no_grad():
            h, q = scaled_ising(self.grbm_params, cfg.PREFACTOR, cfg.H_RANGE, cfg.J_RANGE)
            if self.fns is not None and self.fns.graph_sharded:
                spins = self.sample_spins(n)
                e = energy(GRBMParams(h, q), self.graph, spins)
                return SampleSet(spins=spins.cpu().numpy(), energies=e.cpu().numpy(),
                                 info={"sampler": "graph_sharded"})
            backend = self.sampler_backend()
            if cfg.SAMPLER == "pt" and self.state is not None and self.state.pt_betas.numel():
                backend.backend.betas = self.state.pt_betas.detach().clone()
            return backend.sample(h, q, self.graph, n, self._next_generator())

    def generate_output(self, do_sharpen: bool = False, num_reads: Optional[int] = None) -> dict:
        """Sample the GRBM (``sample_sampleset``) and decode: returns
        {'grid', 'images', 'latents', 'sample_set'}, images (N, S, S, 1) in
        [0, 1] on the host."""
        sample_set = self.sample_sampleset(num_reads)
        spins = torch.as_tensor(sample_set.spins, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            imgs = self.dvae.eval().decode(spins[:, None, :])[:, 0]
            imgs = torch.clamp(imgs, 0.0, 1.0).cpu().numpy()
        if do_sharpen:
            imgs = sharpen(imgs)
        return {"grid": make_grid(imgs, nrow=16), "images": imgs,
                "latents": np.asarray(sample_set.spins), "sample_set": sample_set}

    def generate_reconstructed_samples(self, do_sharpen: bool = False) -> dict:
        """The first ``BATCH_SIZE`` dataset images interleaved with their
        reconstructions (one stochastic spin replica each), a white
        separator column on every reconstruction."""
        batch = self.images[: self.config.BATCH_SIZE]
        with torch.inference_mode():
            _, _, recon = self.dvae.eval()(batch, 1, self._next_generator())
            recon = torch.clamp(recon[:, 0], 0.0, 1.0).cpu().numpy().copy()
        recon[:, :, -1, :] = 1.0  # the white separator column
        pairs = interleave(batch.cpu().numpy(), recon)
        if do_sharpen:
            pairs = sharpen(pairs)
        return {"grid": make_grid(pairs, nrow=16, padding=0), "images": pairs}

    # the reference's method name, kept as an alias (misspelling and all)
    generate_reconstucted_samples = generate_reconstructed_samples

    def generate_loss_plot(self, old_loss_data: Optional[dict] = None) -> dict:
        """Loss histories for plotting, ``old_loss_data`` prepended."""
        mse = self.losses["mse_losses"]
        total = self.losses["dvae_losses"]
        if old_loss_data:
            mse = old_loss_data["mse_losses"] + mse
            total = old_loss_data["dvae_losses"] + total
        return {"mse_losses": mse, "dvae_losses": total}
