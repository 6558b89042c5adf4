"""Parallel-tempering ladder tools: the acceptance probe and ladder sizing.

Port of ``image_generation_tpu/ops/pt_tune.py``.  The communication
barrier of a ladder is Λ = Σ(1 − a_k) over its adjacent pairs' swap
acceptances a_k (Syed et al. 2021):

  * ``recommend_num_betas``: the rung count of an equal-barrier ladder
    whose per-pair acceptance is at least a target, from any measured
    acceptance curve (``Trainer.train_epoch`` reports it under PT);
  * ``respace_betas``: one equal-barrier re-spacing (``PT_ADAPT="epoch"``);
  * ``make_acceptance_measurer`` / ``swap_acceptance``: run the real
    exchanging process (``pt_round`` with carried energies) and average
    its analytic per-pair acceptance;
  * ``size_ladder``: the ``PT_NUM_BETAS="auto"`` probe, a geometric
    probe ladder measured, then T rungs at its equal-barrier quantiles;
  * ``round_trip_count``: replica-flow diagnostics (hot→cold→hot trips and
    ladder coverage);
  * ``tune_pt_betas``: the offline tuner (the ``tune-pt`` command),
    equal-barrier re-spacing iterated on measured acceptance.

The sweeps go through ``sweeps_fn`` (``pt_round``'s contract): the
dispatch's ``SampleFns.sweeps_fn``, so on the card the probe launches the
sweep kernel training would (K1, or K2 / K3), or the plain sweep when it
is None; ``energies_fn`` replaces ``ising_energies`` (the graph-sharded
layout's).  JAX's jitted scan is a Python loop here.  ``feed`` replaces
each round's draws (sweep uniforms, swap uniforms) for the parity tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from image_generation_tpu_torch.ops.gibbs import (
    GibbsPlan,
    ising_energies,
    pt_round,
    random_spins,
)

__all__ = [
    "PTLadderDiagnostics",
    "make_acceptance_measurer",
    "recommend_num_betas",
    "respace_betas",
    "round_trip_count",
    "size_ladder",
    "swap_acceptance",
    "tune_pt_betas",
]


class PTLadderDiagnostics(NamedTuple):
    betas: np.ndarray        # (T,) the ladder measured
    accept: np.ndarray       # (T-1,) mean swap acceptance per adjacent pair
    barrier: float           # Λ(1) = Σ rejection: lower mixes better


def _round_draws(feed, i: int):
    return (None, None) if feed is None else feed[i]


def make_acceptance_measurer(hp: torch.Tensor, coupling_p, plan: GibbsPlan, t_dim: int,
                             n_chains: int = 256, n_rounds: int = 24,
                             sweeps_per_round: int = 2, burn_rounds: int = 8,
                             sweeps_fn=None, energies_fn=None):
    """``rounds(generator, flat_spins, betas, feed=None) -> (spins,
    accept)``: ``burn_rounds`` then ``n_rounds`` rounds of the exchanging
    process from the (T·C, n_pad) ``flat_spins``, energies computed once
    and carried; ``accept`` is the (T−1,) mean over the measured rounds of
    ``pt_round``'s analytic per-pair acceptance.  ``feed``: one (sweep
    uniforms, (even, odd) swap uniforms) pair per round, burn-in first.
    ``energies_fn`` (``pt_round``'s) replaces ``ising_energies``."""
    energies = energies_fn or ising_energies

    def rounds(generator, flat, betas, feed: Optional[Sequence] = None):
        s = flat.reshape(t_dim, n_chains, flat.shape[-1])
        e = energies(hp, coupling_p, s)
        acc = torch.zeros(t_dim - 1, dtype=torch.float32, device=flat.device)
        for i in range(burn_rounds + n_rounds):
            u, w = _round_draws(feed, i)
            s, e, pair_acc = pt_round(generator, hp, coupling_p, plan, s, betas,
                                      sweeps_per_round, sweeps_fn=sweeps_fn, energies=e,
                                      return_accept=True, uniforms=u, swap_uniforms=w,
                                      energies_fn=energies_fn)
            if i >= burn_rounds:
                acc = acc + pair_acc
        return s.reshape(flat.shape), acc / n_rounds

    return rounds


def swap_acceptance(generator: Optional[torch.Generator], hp: torch.Tensor, coupling_p,
                    plan: GibbsPlan, betas, n_chains: int = 256, n_rounds: int = 24,
                    sweeps_per_round: int = 2, burn_rounds: int = 8, measurer=None,
                    sweeps_fn=None, *, init_spins: Optional[torch.Tensor] = None,
                    feed: Optional[Sequence] = None, energies_fn=None,
                    local=None) -> PTLadderDiagnostics:
    """Per-pair swap acceptance E[min(1, e^{Δβ·ΔE})] at ``betas``, measured
    on a real ladder from random spins (``init_spins`` (T·C, n_pad)
    replaces them).  ``measurer``: a ``make_acceptance_measurer`` result
    built for the same model, T and round counts.  ``local`` cuts the
    whole-width random spins to what the sweeps take (a graph-sharded
    rank's column window)."""
    betas = np.asarray(betas, np.float64)
    t_dim = len(betas)
    if measurer is None:
        measurer = make_acceptance_measurer(hp, coupling_p, plan, t_dim, n_chains, n_rounds,
                                            sweeps_per_round, burn_rounds, sweeps_fn,
                                            energies_fn)
    if init_spins is None:
        init_spins = random_spins(generator, plan, t_dim * n_chains, hp.device)
        if local is not None:
            init_spins = local(init_spins)
    _, acc = measurer(generator, init_spins,
                      torch.tensor(betas, dtype=torch.float32, device=hp.device), feed)
    acc = np.clip(acc.double().cpu().numpy(), 1e-4, 1.0)
    return PTLadderDiagnostics(betas=betas, accept=acc, barrier=float(np.sum(1.0 - acc)))


def round_trip_count(generator: Optional[torch.Generator], hp: torch.Tensor, coupling_p,
                     plan: GibbsPlan, betas, n_chains: int, n_rounds: int,
                     sweeps_per_round: int = 2, sweeps_fn=None, *,
                     init_spins: Optional[torch.Tensor] = None,
                     feed: Optional[Sequence] = None):
    """Completed hot→cold→hot round trips and the mean ladder coverage
    (mean (max_row − min_row)/(T−1) over replicas) of an ``n_rounds`` run
    with carried energies; per-replica labels ride ``pt_round``'s ``aux``.
    ``betas``: one (T,) ladder (→ one ``(trips, coverage)``) or a list of
    same-T ladders (→ a list, all from one initial ladder and the same
    draws, as the JAX package's shared key gives them)."""
    many = isinstance(betas, (list, tuple)) and np.ndim(betas[0]) == 1
    dev = hp.device
    ladders = [torch.tensor(np.asarray(b, np.float32), device=dev)
               for b in (betas if many else [betas])]
    t_dim = int(ladders[0].shape[0])
    if any(int(b.shape[0]) != t_dim for b in ladders):
        raise ValueError("round_trip_count compares ladders of one rung count")
    if generator is None:  # a generator of its own, so every ladder sees the same draws
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(torch.randint(0, 2**62, (1,))))
    if init_spins is None:
        init_spins = random_spins(generator, plan, t_dim * n_chains, dev)
    ladder0 = init_spins.reshape(t_dim, n_chains, plan.n_pad)
    rows = torch.arange(t_dim, device=dev)[:, None].expand(t_dim, n_chains)
    draws = generator.get_state()
    out = []
    for bs in ladders:
        generator.set_state(draws)
        s, e = ladder0, ising_energies(hp, coupling_p, ladder0)
        direc = torch.zeros((t_dim, n_chains), dtype=torch.int32, device=dev)
        direc[0] = 1
        aux = {"dir": direc, "rmin": rows.clone(), "rmax": rows.clone()}
        trips = 0
        for i in range(n_rounds):
            u, w = _round_draws(feed, i)
            s, e, aux = pt_round(generator, hp, coupling_p, plan, s, bs, sweeps_per_round,
                                 sweeps_fn=sweeps_fn, energies=e, aux=aux, uniforms=u,
                                 swap_uniforms=w)
            d = aux["dir"]
            d = torch.where((rows == t_dim - 1) & (d == 1), -1, d)
            trips += int(((rows == 0) & (d == -1)).sum())
            d = torch.where(rows == 0, 1, d)
            aux = {"dir": d.to(torch.int32), "rmin": torch.minimum(aux["rmin"], rows),
                   "rmax": torch.maximum(aux["rmax"], rows)}
        coverage = float(((aux["rmax"] - aux["rmin"]).float() / (t_dim - 1)).mean())
        out.append((trips, coverage))
    return out if many else out[0]


def recommend_num_betas(accept, target_accept: float = 0.5, t_min: int = 2,
                        t_max: int = 64) -> int:
    """Rung count of an equal-barrier ladder whose per-pair acceptance is
    ≥ ``target_accept``: T = ⌈Λ / (1 − target)⌉ + 1, clipped."""
    accept = np.clip(np.asarray(accept, np.float64), 0.0, 1.0)
    barrier = float(np.sum(1.0 - accept))
    t = int(np.ceil(barrier / max(1e-9, 1.0 - float(target_accept)))) + 1
    return int(np.clip(t, t_min, t_max))


def size_ladder(generator: Optional[torch.Generator], hp: torch.Tensor, coupling_p,
                plan: GibbsPlan, *, beta_min: float, t_probe: int = 16,
                target_accept: float = 0.5, t_min: int = 2, t_max: int = 64,
                n_chains: int = 128, n_rounds: int = 16, sweeps_per_round: int = 2,
                burn_rounds: int = 8, sweeps_fn=None):
    """The rung count and ladder for a model from a short acceptance probe
    (the ``PT_NUM_BETAS="auto"`` backend): per-pair acceptance on a
    ``t_probe``-rung geometric probe over [beta_min, 1] (densified once,
    2× up to ``t_max``, when a pair is nearly dead: min acceptance < 0.05),
    T from ``recommend_num_betas``, the T rungs at the probe's
    equal-barrier quantiles.  Returns ``(betas, probe_diag)``: a strictly
    ascending (T,) ladder ending at exactly 1.0."""
    t_probe = int(np.clip(t_probe, 4, t_max))
    for _ in range(2):
        probe = np.geomspace(beta_min, 1.0, t_probe)
        diag = swap_acceptance(generator, hp, coupling_p, plan, probe, n_chains, n_rounds,
                               sweeps_per_round, burn_rounds, sweeps_fn=sweeps_fn)
        if float(diag.accept.min()) >= 0.05 or t_probe >= t_max:
            break
        t_probe = min(2 * t_probe, t_max)
    t_dim = recommend_num_betas(diag.accept, target_accept, t_min, t_max)
    rej = np.maximum(1.0 - diag.accept, 1e-4)
    lam = np.concatenate([[0.0], np.cumsum(rej)])
    betas = np.interp(np.linspace(0.0, lam[-1], t_dim), lam, probe)
    betas[0], betas[-1] = probe[0], 1.0
    return betas, diag


def respace_betas(betas, accept) -> np.ndarray:
    """Move the interior rungs to the equal-Λ quantiles of the
    piecewise-linear barrier through the current rungs (endpoints fixed)."""
    betas = np.asarray(betas, np.float64)
    accept = np.clip(np.asarray(accept, np.float64), 1e-4, 1.0)
    rej = np.maximum(1.0 - accept, 1e-4)  # keeps Λ strictly increasing
    lam = np.concatenate([[0.0], np.cumsum(rej)])
    new = np.interp(np.linspace(0.0, lam[-1], len(betas)), lam, betas)
    new[0], new[-1] = betas[0], betas[-1]
    return new


def tune_pt_betas(generator: Optional[torch.Generator], hp: torch.Tensor, coupling_p,
                  plan: GibbsPlan, betas0, n_iters: int = 3, n_chains: int = 256,
                  n_rounds: int = 24, sweeps_per_round: int = 2, verbose: bool = False,
                  sweeps_fn=None, energies_fn=None, local=None, *,
                  feeds: Optional[Sequence] = None):
    """Iteratively equalize the ladder's swap acceptance: ``n_iters``
    measurements (``swap_acceptance`` through one measurer), each followed
    by ``respace_betas``, then one measurement of the tuned ladder.
    Returns ``(betas_tuned, diag_before, diag_after)``.  ``sweeps_fn`` /
    ``energies_fn`` / ``local``: the sampler's layout (the dispatch's
    ``SampleFns``).  ``feeds``: one (initial (T·C, n_pad) spins, round
    feed) pair per measurement, replacing its draws."""
    betas = np.asarray(betas0, np.float64)
    measurer = make_acceptance_measurer(hp, coupling_p, plan, len(betas), n_chains, n_rounds,
                                        sweeps_per_round, sweeps_fn=sweeps_fn,
                                        energies_fn=energies_fn)

    def measure(i: int, b) -> PTLadderDiagnostics:
        init, feed = (None, None) if feeds is None else feeds[i]
        return swap_acceptance(generator, hp, coupling_p, plan, b, n_chains, n_rounds,
                               sweeps_per_round, measurer=measurer, init_spins=init,
                               feed=feed, local=local)

    def report(tag: str, d: PTLadderDiagnostics) -> None:
        if verbose:
            print(f"{tag}: acc min/mean/max = {d.accept.min():.3f}/{d.accept.mean():.3f}/"
                  f"{d.accept.max():.3f} barrier={d.barrier:.3f}")

    diag0 = None
    for it in range(n_iters):
        diag = measure(it, betas)
        if diag0 is None:
            diag0 = diag
        report(f"iter {it}", diag)
        betas = respace_betas(betas, diag.accept)
    diag_final = measure(n_iters, betas)
    report("tuned", diag_final)
    return betas, diag0, diag_final
