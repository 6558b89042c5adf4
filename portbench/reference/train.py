"""The first training steps of the DVAE + Boltzmann machine, in plain f32.

Covers what a training step does: the negative phase (the sampler's sweeps
with their carried energy change, and the parallel-tempering exchanges),
the DVAE forward with its straight-through spins and dropout, the MSE +
MMD loss, its backward and the Adam (+ L2) update, and on scheduled steps
(epoch < 6, step % 10 == 0) the second negative phase, the closed-form
gradient of the Boltzmann machine's quasi-likelihood and its Adam update.

It starts from what the benchmark hands both sides (the config, the seed,
the dataset and the graph) and draws every random number from the streams
the program's trainer seeds from that seed, in the order its step draws
them: a numpy stream seeded with the seed gives the state's generator and
each epoch's permutation generator; the state's generator gives the
Boltzmann machine's start, the chains, each sweep run's seed and
exchange uniforms, the spins' uniforms and the dropout masks.  The
sampler's coupling is held in the configured sweep precision (bf16 from
2048 padded columns) and summed in f32; the DVAE runs in f32, TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import dvae as ref_dvae
from reference import gibbs
from reference.plan import build_plan

__all__ = ["ReferenceRun"]

_BETA1, _BETA2, _EPS = 0.9, 0.999, 1e-8


def mmd(x, y, n_kernels: int = 7):
    """Biased MMD^2 under a 7-kernel RBF mixture, bandwidth the joint
    sample's mean squared distance (held constant), scaled by 2^-3..2^3."""
    z = torch.cat([x, y], 0)
    sq = (z * z).sum(-1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (z @ z.T), min=0.0)
    m = z.shape[0]
    base = torch.clamp(d2.sum() / max(m * m - m, 1), min=1e-12).detach()
    k = sum(torch.exp(-d2 / (base * 2.0 ** (i - (n_kernels - 1) / 2.0)))
            for i in range(n_kernels))
    nx = x.shape[0]
    return k[:nx, :nx].mean() + k[nx:, nx:].mean() - 2.0 * k[:nx, nx:].mean()


def geomspace_lr(initial: float, final: float, total: int):
    n = max(total, 1)
    return lambda step: initial * (final / initial) ** (min(max(step - 1, 0), n) / n)


class Adam:
    """Adam with the L2 term added to the gradient, one leaf at a time."""

    def __init__(self, params: dict, weight_decay: float):
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict, lr: float) -> dict:
        """Updates ``params`` in place; returns the gradients it took (L2 in)."""
        self.t += 1
        bc1 = 1 - _BETA1 ** self.t
        bc2_sqrt = (1 - _BETA2 ** self.t) ** 0.5
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].lerp_(g, 1 - _BETA1)
            self.v[k].mul_(_BETA2).addcmul_(g, g, value=1 - _BETA2)
            denom = self.v[k].sqrt() / bc2_sqrt + _EPS
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
        return taken


class ReferenceRun:
    """The program's training run from ``seed``, replayed step by step.

    ``cfg``: the configuration's settings (the program's defaults filled
    in); ``graph``: (n, edge_i, edge_j); ``images``: the (N, S, S, 1)
    dataset on the device."""

    def __init__(self, cfg: dict, graph, images: torch.Tensor, seed: int, total_steps: int):
        gibbs.f32_only()
        self.cfg = cfg
        self.n, self.ei, self.ej = graph
        self.dev = images.device
        self.images = images
        self.plan = build_plan(self.n, self.ei, self.ej)
        self.sweep_bf16 = cfg["SAMPLER_MATMUL_DTYPE"] == "bfloat16" or (
            cfg["SAMPLER_MATMUL_DTYPE"] == "auto" and self.plan.n_pad >= 2048)
        self.pt = cfg["SAMPLER"] == "pt"
        self.t = int(cfg["PT_NUM_BETAS"]) if self.pt else 1
        self.betas = torch.tensor(np.geomspace(cfg["PT_BETA_MIN"], 1.0, self.t),
                                  dtype=torch.float32, device=self.dev)
        self.dvae_lr = geomspace_lr(cfg["AUTOENCODER_INITIAL_LR"], cfg["AUTOENCODER_FINAL_LR"],
                                    total_steps)
        self.grbm_lr = geomspace_lr(cfg["BM_INITIAL_LR"], cfg["BM_FINAL_LR"], total_steps)
        self.seeds = np.random.default_rng(int(seed))
        state_seed = self._next_seed()
        self.g = torch.Generator(device=self.dev)
        self.g.manual_seed(state_seed)
        self.w = ref_dvae.init_weights(self.n, state_seed, self.dev)
        self.params = {k: v for k, v in self.w.items()
                       if not k.endswith(("running_mean", "running_var"))}
        self.h = 0.01 * torch.randn(self.n, generator=self.g, device=self.dev)
        self.j = 0.01 * torch.randn(len(self.ei), generator=self.g, device=self.dev)
        chains = gibbs.random_spins(self.g, self.t * cfg["NUM_READS"], self.plan.n_pad)
        self._model()
        self.energies = None
        if self.pt:
            self.chains, self.energies = gibbs.pt_round(
                self.g, self.plan, self.hp, self.jp,
                chains.reshape(self.t, cfg["NUM_READS"], -1), self.betas, cfg["GIBBS_BURN_IN"])
        else:
            self.chains = self._gibbs(chains, cfg["GIBBS_BURN_IN"])
        self.dvae_opt = Adam(self.params, cfg["AUTOENCODER_WEIGHT_DECAY"])
        self.grbm_opt = Adam({"linear": self.h, "quadratic": self.j}, cfg["BM_WEIGHT_DECAY"])
        self.step_no = 0
        self.batches = None

    def _next_seed(self) -> int:
        return int(self.seeds.integers(0, 2**63 - 1))

    def _model(self):
        """The sampler's model: prefactor-scaled, clipped, in the plan's
        columns, the coupling rounded to the sweep precision."""
        c = self.cfg
        h = torch.clamp(c["PREFACTOR"] * self.h, *c["H_RANGE"])
        j = torch.clamp(c["PREFACTOR"] * self.j, *c["J_RANGE"])
        self.hp, self.jp = gibbs.permuted_model(self.plan, h, self.ei, self.ej, j)
        if self.sweep_bf16:
            self.jp = self.jp.to(torch.bfloat16).float()

    def _gibbs(self, chains, n_sweeps):
        """Plain Gibbs at beta 1, one seed for every chain."""
        rows = torch.arange(chains.shape[0], dtype=torch.int64, device=self.dev)
        key = gibbs.draw_seed(self.g).to(self.dev).expand(chains.shape[0])
        return gibbs.sweeps(self.plan, self.hp, self.jp, chains, n_sweeps, 1.0, key, rows)

    def _negative_phase(self):
        idx = torch.as_tensor(self.plan.orig_to_perm, device=self.dev)
        if not self.pt:
            self.chains = self._gibbs(self.chains, self.cfg["GIBBS_SWEEPS"])
            return self.chains[:, idx]
        self.chains, self.energies = gibbs.pt_round(
            self.g, self.plan, self.hp, self.jp, self.chains, self.betas,
            self.cfg["GIBBS_SWEEPS"], carried=self.energies)
        return self.chains[-1][:, idx]

    def start_epoch(self):
        g = torch.Generator(device=self.dev)
        g.manual_seed(self._next_seed())
        bsz = self.cfg["BATCH_SIZE"]
        nb = self.images.shape[0] // bsz
        perm = torch.randperm(self.images.shape[0], generator=g, device=self.dev)[:nb * bsz]
        self.batches = perm.reshape(nb, bsz)
        self.batch_no = 0

    def step(self, epoch: int) -> dict:
        """One step; returns its loss and the gradients Adam took (L2 in)
        and the loss gradient of each leaf, before the update."""
        c = self.cfg
        images = self.images[self.batches[self.batch_no]]
        self.batch_no += 1
        samples = self._negative_phase()
        for p in self.params.values():
            p.requires_grad_(True)
        logits = ref_dvae.encode(self.w, images)
        u = torch.rand((images.shape[0], c["N_REPLICAS"], self.n), generator=self.g,
                       device=self.dev)
        spins = ref_dvae.straight_through(logits, u)
        masks = ref_dvae.dropout_masks(images.shape[0] * c["N_REPLICAS"], self.g, self.dev)
        recon = ref_dvae.decode(self.w, spins, masks)
        mse = torch.square(recon - images[:, None]).mean()
        flat = spins.reshape(-1, self.n)
        loss = mse + mmd(flat, samples, c["N_KERNELS"])
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(loss, [self.params[k] for k in names])))
        with torch.no_grad():
            for p in self.params.values():
                p.requires_grad_(False)
            taken = self.dvae_opt.step(self.params, grads, self.dvae_lr(self.step_no))
            out = {"loss": float(loss), "grad": grads, "taken": taken}
            if epoch < 6 and self.step_no % 10 == 0:
                data = flat.detach()
                model = self._negative_phase()
                ei = torch.as_tensor(self.ei, device=self.dev, dtype=torch.long)
                ej = torch.as_tensor(self.ej, device=self.dev, dtype=torch.long)
                g_h = data.mean(0) - model.mean(0)
                g_j = (data[:, ei] * data[:, ej]).mean(0) - (model[:, ei] * model[:, ej]).mean(0)
                grbm = {"linear": self.h, "quadratic": self.j}
                t = self.grbm_opt.step(grbm, {"linear": g_h, "quadratic": g_j},
                                       self.grbm_lr(self.step_no))
                out["grad"].update({"grbm.linear": g_h, "grbm.quadratic": g_j})
                out["taken"].update({"grbm.linear": t["linear"],
                                     "grbm.quadratic": t["quadratic"]})
                self._model()
                if self.pt:
                    self.energies = gibbs.energies(self.hp, self.jp, self.chains)
        self.step_no += 1
        return out

    def leaves(self) -> dict:
        """Every trained leaf, keyed as the checkpoint keys it."""
        out = {k: v for k, v in self.params.items()}
        out["grbm.linear"] = self.h
        out["grbm.quadratic"] = self.j
        return out
