"""Maximum Mean Discrepancy with a Gaussian (RBF) mixture kernel.

Port of ``image_generation_tpu/ops/mmd.py``: the biased (V-statistic)
MMD² ``mean(K_xx) + mean(K_yy) − 2·mean(K_xy)`` under a mixture of
``n_kernels`` RBF kernels whose bandwidths are a data-adaptive base (the
mean pairwise squared distance of the joint sample, detached from the
gradient as JAX's ``stop_gradient`` does) scaled by powers of 2 centred
on 1.  Differentiable with respect to ``x`` (the encoded spins); ``y``
(the sampler's draws) is a constant at the call site.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["GaussianKernel", "mmd_loss", "pairwise_sq_dists"]


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances ‖x_i − y_j‖², shape (nx, ny), through
    the Gram expansion, clipped at 0."""
    xx = (x * x).sum(-1)
    yy = (y * y).sum(-1)
    d2 = xx[:, None] + yy[None, :] - 2.0 * (x @ y.T)
    return torch.clamp(d2, min=0.0)


class GaussianKernel:
    """k(d²) = Σ_w exp(−d² / (σ²₀ · multiplier^w)), w over the
    ``n_kernels`` integers centred on 0 (−3…3 for 7)."""

    def __init__(self, n_kernels: int = 7, multiplier: float = 2.0,
                 bandwidth: Optional[float] = None):
        self.n_kernels = n_kernels
        self.multiplier = multiplier
        self.bandwidth = bandwidth
        self.exponents = [i - (n_kernels - 1) / 2.0 for i in range(n_kernels)]

    def base_bandwidth(self, d2: torch.Tensor) -> torch.Tensor:
        if self.bandwidth is not None:
            return torch.as_tensor(self.bandwidth, dtype=d2.dtype, device=d2.device)
        n = d2.shape[0]
        mean_d2 = d2.sum() / max(n * n - n, 1)  # the diagonal is 0
        return torch.clamp(mean_d2, min=1e-12).detach()

    def __call__(self, d2: torch.Tensor, base: Optional[torch.Tensor] = None) -> torch.Tensor:
        if base is None:
            base = self.base_bandwidth(d2)
        out = None
        for w in self.exponents:
            term = torch.exp(-d2 / (base * (self.multiplier ** w)))
            out = term if out is None else out + term
        return out


def mmd_loss(x: torch.Tensor, y: torch.Tensor,
             kernel: Optional[GaussianKernel] = None) -> torch.Tensor:
    """Biased MMD² between samples x (nx, d) and y (ny, d), with one shared
    adaptive bandwidth from the joint sample."""
    if kernel is None:
        kernel = GaussianKernel()
    z = torch.cat([x, y], 0)
    d2 = pairwise_sq_dists(z, z)
    k = kernel(d2, kernel.base_bandwidth(d2))
    nx = x.shape[0]
    return k[:nx, :nx].mean() + k[nx:, nx:].mean() - 2.0 * k[:nx, nx:].mean()
