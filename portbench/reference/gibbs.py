"""Plain colour-block Gibbs sampling and parallel tempering, in f32.

The reference sampler of the benchmark.  A colour update of chains ``s``
(C, n_pad) under fields ``h`` and a symmetric coupling ``J`` is

    f = s @ J[:, c0:c1] + h[c0:c1]
    s[:, c0:c1] = +1 where u < sigmoid(-2 beta f), else -1

with ``u`` the uniform that the sampler under test draws for that spin:
Philox4x32-10 keyed by a 64-bit seed, counter (column, chain row, sweep,
0), u = (first word >> 8) * 2^-24 (``philox_uniforms``).  The seed is the
one the program's stream hands the sampler: one ``randint(0, 2**62)`` of
the caller's generator a sweep run (``draw_seed``), so a reference that
replays the same generator draws the same numbers.  Sums run as dense
matrix products in f32 with TF32 off, in another order than any kernel:
a spin whose uniform lies within rounding of its probability may go the
other way, so chains are compared by the share that differ, not bit for
bit.

``pt_round`` is one parallel-tempering round (sweeps at every rung, then
replica exchange of even pairs, then odd pairs), carrying the ladder's
energies by the sweeps' energy change when it is given them.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["f32_only", "philox_uniforms", "draw_seed", "slice_keys", "random_spins", "sweeps", "energies",
           "pt_round", "permuted_model"]

_M32 = 0xFFFFFFFF


def f32_only() -> None:
    """f32 means f32 in the reference: no TF32 in its products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mul(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` < 2^32 and a
    constant ``m`` < 2^32, in 16-bit limbs so that nothing overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    t = ((a_hi * m_lo + a_lo * m_hi) << 16) + a_lo * m_lo
    return (a_hi * m_hi + (t >> 32)) & _M32, t & _M32


def philox_uniforms(key: torch.Tensor, rows: torch.Tensor, n_pad: int, sweep: int) -> torch.Tensor:
    """(R, n_pad) f32 uniforms of one sweep: ``key`` (R,) int64 seeds (each
    row's own), ``rows`` (R,) int64 chain rows of the counter."""
    dev = rows.device
    k0 = (key & _M32).reshape(-1, 1)
    k1 = ((key >> 32) & _M32).reshape(-1, 1)
    c0 = torch.arange(n_pad, dtype=torch.int64, device=dev).reshape(1, -1).expand(len(rows), -1)
    c1 = rows.reshape(-1, 1).expand_as(c0)
    c2 = torch.full_like(c0, int(sweep))
    c3 = torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mul(c0, 0xD2511F53)
        hi1, lo1 = _mul(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return (c0 >> 8).to(torch.float32) * (2.0 ** -24)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """The sampler's Philox seed for one sweep run, as its caller draws it."""
    return torch.randint(0, 2**62, (1,), generator=generator, device=generator.device,
                         dtype=torch.int64)


def random_spins(generator: torch.Generator, n_chains: int, n_pad: int) -> torch.Tensor:
    """Fresh +-1 chains (n_chains, n_pad), as the program's stream draws them."""
    bits = torch.randint(0, 2, (n_chains, n_pad), generator=generator,
                         device=generator.device, dtype=torch.float32)
    return 2.0 * bits - 1.0


def permuted_model(plan, h: torch.Tensor, edge_i, edge_j, j: torch.Tensor):
    """(h_p (n_pad,), J_p (n_pad, n_pad)) in the plan's columns, f32."""
    dev = h.device
    pi = torch.as_tensor(plan.orig_to_perm[edge_i], device=dev)
    pj = torch.as_tensor(plan.orig_to_perm[edge_j], device=dev)
    jp = torch.zeros((plan.n_pad, plan.n_pad), dtype=torch.float32, device=dev)
    jp.index_put_((pi, pj), j.float(), accumulate=True)
    jp.index_put_((pj, pi), j.float(), accumulate=True)
    hp = torch.zeros(plan.n_pad, dtype=torch.float32, device=dev)
    hp[torch.as_tensor(plan.orig_to_perm, device=dev)] = h.float()
    return hp, jp


def sweeps(plan, hp, jp, spins, n_sweeps: int, beta, key: torch.Tensor,
           rows: Optional[torch.Tensor] = None, track_delta_e: bool = False):
    """``n_sweeps`` sweeps of ``spins`` (C, n_pad); ``beta`` scalar or (C,);
    ``key`` (1,) or (C,) Philox seeds; ``rows`` the counter's chain rows
    (0..C-1 by default).  Returns spins, or (spins, dE) with the energy
    change summed as f * (new - old) per update."""
    c = spins.shape[0]
    dev = spins.device
    rows = torch.arange(c, dtype=torch.int64, device=dev) if rows is None else rows
    key = key.reshape(-1).to(dev).expand(c)
    beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    beta = beta.reshape(-1, 1) if beta.ndim else beta
    s = spins.clone()
    de = torch.zeros(c, dtype=torch.float32, device=dev)
    for sweep in range(n_sweeps):
        u = philox_uniforms(key, rows, plan.n_pad, sweep)
        for c0, c1 in plan.spans:
            f = s @ jp[:, c0:c1] + hp[c0:c1]
            new = torch.where(u[:, c0:c1] < torch.sigmoid(-2.0 * beta * f), 1.0, -1.0)
            if track_delta_e:
                de += (f * (new - s[:, c0:c1])).sum(-1)
            s[:, c0:c1] = new
    return (s, de) if track_delta_e else s


def energies(hp, jp, spins):
    """E(s) = h.s + s^T J s / 2 over the last axis."""
    return spins @ hp + 0.5 * (spins * (spins @ jp)).sum(-1)


def pt_round(generator, plan, hp, jp, ladder, betas, n_sweeps: int, carried=None):
    """One round on ``ladder`` (T, C, n_pad) at ``betas`` (T,), drawing from
    ``generator`` as the program does: the sweeps' seed, then one (T-1, C)
    uniform per exchange pass.  ``carried``: the ladder's energies, moved by
    the sweeps' energy change; without them they are computed after the
    sweeps.  Returns (ladder, energies)."""
    t, c, n_pad = ladder.shape
    beta_chain = betas.repeat_interleave(c)
    rows = torch.arange(t * c, dtype=torch.int64, device=ladder.device)
    key = draw_seed(generator).to(ladder.device).expand(t * c)
    flat = ladder.reshape(t * c, n_pad)
    if carried is not None:
        flat, de = sweeps(plan, hp, jp, flat, n_sweeps, beta_chain, key, rows,
                          track_delta_e=True)
        e = carried + de.reshape(t, c)
    else:
        flat = sweeps(plan, hp, jp, flat, n_sweeps, beta_chain, key, rows)
    s = flat.reshape(t, c, n_pad)
    if carried is None:
        e = energies(hp, jp, s)
    d_beta = (betas[:-1] - betas[1:])[:, None]
    pairs = torch.arange(t - 1, device=s.device) % 2
    pad = torch.zeros((1, c), dtype=torch.bool, device=s.device)
    for parity in (0, 1):
        delta = d_beta * (e[:-1] - e[1:])
        u = torch.rand(delta.shape, generator=generator, device=generator.device)
        accept = (torch.log(u) < delta) & (pairs == parity)[:, None]
        up = torch.cat([accept, pad], 0)[..., None]
        down = torch.cat([pad, accept], 0)[..., None]
        s = torch.where(up, torch.roll(s, -1, 0), torch.where(down, torch.roll(s, 1, 0), s))
        e = torch.where(up[..., 0], torch.roll(e, -1, 0),
                        torch.where(down[..., 0], torch.roll(e, 1, 0), e))
    return s, e
