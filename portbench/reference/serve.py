"""Images served from a trained model, worked out again in plain f32.

A request of ``reads`` images from a model directory in the reference
model's format (``dvae.pth``, ``grbm.pth``) is ``reads`` Gibbs chains
started from random spins, ``sweeps`` sweeps of the prefactor-scaled,
clipped model at beta = 1, decoded by the DVAE in evaluation mode and
quantised to uint8 as round(clip(x, 0, 1) * 255).

Covers the sampler's sweeps, the decode, the quantisation and which chains
a request owns: a dispatch that serves ``k`` requests together draws its
chains and its sampler seed once for all ``k * reads`` chains from a
generator seeded by the ``d``-th draw of the server's numpy stream, and
request ``i`` owns rows ``[i * reads, (i + 1) * reads)``.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import dvae as ref_dvae
from reference import gibbs
from reference.plan import build_plan

__all__ = ["ReferenceServer"]


class ReferenceServer:
    def __init__(self, model_dir, cfg: dict, seed: int, device):
        gibbs.f32_only()
        self.dev = torch.device(device)
        self.cfg = cfg
        sd = torch.load(f"{model_dir}/dvae.pth", map_location=self.dev, weights_only=True)
        self.w = {k: v.float() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        grbm = torch.load(f"{model_dir}/grbm.pth", map_location="cpu", weights_only=True)
        self.ei = grbm["_edge_idx_i"].numpy().astype(np.int64)
        self.ej = grbm["_edge_idx_j"].numpy().astype(np.int64)
        self.n = int(grbm["_linear"].shape[0])
        self.plan = build_plan(self.n, self.ei, self.ej)
        h = torch.clamp(cfg["PREFACTOR"] * grbm["_linear"].float(), *cfg["H_RANGE"])
        j = torch.clamp(cfg["PREFACTOR"] * grbm["_quadratic"].float(), *cfg["J_RANGE"])
        self.hp, self.jp = gibbs.permuted_model(self.plan, h.to(self.dev), self.ei, self.ej,
                                                j.to(self.dev))
        self._seeds = np.random.default_rng(int(seed))
        self._drawn = []

    def dispatch_seed(self, d: int) -> int:
        """The seed of the ``d``-th dispatch's generator."""
        while len(self._drawn) <= d:
            self._drawn.append(int(self._seeds.integers(0, 2**63 - 1)))
        return self._drawn[d]

    def chains(self, requests):
        """(start spins, Philox keys, counter rows) of ``requests`` =
        [(d, i, k), ...], stacked request by request."""
        reads = self.cfg["NUM_READS"]
        starts, keys, rows = [], [], []
        for d, i, k in requests:
            g = torch.Generator(device=self.dev)
            g.manual_seed(self.dispatch_seed(d))
            s0 = gibbs.random_spins(g, k * reads, self.plan.n_pad)
            key = gibbs.draw_seed(g)
            starts.append(s0[i * reads:(i + 1) * reads])
            keys.append(key.expand(reads))
            rows.append(torch.arange(i * reads, (i + 1) * reads, device=self.dev))
        return torch.cat(starts), torch.cat(keys), torch.cat(rows)

    def images(self, requests) -> torch.Tensor:
        """(len(requests), reads, S, S, 1) uint8 images of ``requests`` =
        [(dispatch, slot, group size), ...]."""
        spins = self.spins(requests)
        with torch.no_grad():
            out = ref_dvae.decode(self.w, spins[:, None, :], train=False)[:, 0]
            img = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
        return img.reshape(len(requests), self.cfg["NUM_READS"], *img.shape[1:])

    def spins(self, requests) -> torch.Tensor:
        s0, keys, rows = self.chains(requests)
        sweeps = self.cfg["GIBBS_BURN_IN"] + self.cfg["GIBBS_SWEEPS"]
        s = gibbs.sweeps(self.plan, self.hp, self.jp, s0, sweeps, 1.0, keys, rows)
        return s[:, torch.as_tensor(self.plan.orig_to_perm, device=self.dev)]
