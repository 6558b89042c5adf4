"""Training traffic: epochs of the port's ``Trainer`` on a dataset made from the seed.

Mix parameters (``traffic/<mix>.json``): ``schedule_epochs`` (the LR
schedule's length, as ``cli train --epochs``), ``trace_skip_s`` and
``trace_s`` (where the traced run's stretch starts in the window and how
long it lasts, in whole steps), ``checked_steps`` (the steps the reference
follows).  Configuration (``configs/<config>.json``): ``training`` (every
setting the run uses, handed to the program's ``TrainingConfig``),
``graph_seed`` (the latent graph's selection seed, the same for every
``--seed``), ``graph`` (the selected graph, frozen, which the program's own
selection must match), ``dataset_size`` and ``ink`` (the share of lit
pixels of the binary images drawn on the device).

Set-up builds one ``Trainer`` at the seed and trains epoch 0 through
``Trainer.train_epoch``, one step a chunk, which warms the plain step and
the scheduled update of the Boltzmann machine and records what the
comparison needs: each step's loss, the first gradient of every leaf as
Adam holds it after step 1, and after ``checked_steps`` steps each leaf's
change and the chains.  The window trains the same object on through
``train_epoch`` from epoch 1 and closes at the first step boundary past
``--seconds``; the images counted are those of the steps issued in it, all
finished at its closing synchronise.  Then the program is freed and
``reference/train.py`` replays the checked steps from the seed.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from compare import leaf_gaps, relative_gap
from reference.train import ReferenceRun

_BETA1 = 0.9  # Adam's first-moment decay: after one step exp_avg = (1 - beta1) g


class _WindowClosed(Exception):
    pass


def make_dataset(seed: int, n: int, size: int, ink: float, device) -> torch.Tensor:
    """(n, size, size, 1) binary f32 images drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return (torch.rand((n, size, size, 1), generator=g, device=device) < ink).float()


def load_graph(run) -> tuple:
    with np.load(run.root / run.config["graph"]) as z:
        return int(z["n"]), z["edge_i"].astype(np.int64), z["edge_j"].astype(np.int64)


def _leaves(trainer) -> dict:
    out = dict(trainer.dvae.named_parameters())
    out["grbm.linear"] = trainer.grbm_params.linear
    out["grbm.quadratic"] = trainer.grbm_params.quadratic
    return out


def _first_moments(trainer) -> dict:
    """Each leaf's first gradient, as Adam holds it after one step (L2 in)."""
    moments = {}
    for opt, leaves in ((trainer.state.dvae_opt, dict(trainer.dvae.named_parameters())),
                        (trainer.state.grbm_opt, {"grbm.linear": trainer.grbm_params.linear,
                                                  "grbm.quadratic":
                                                      trainer.grbm_params.quadratic})):
        for name, p in leaves.items():
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                moments[name] = st["exp_avg"]
    return {k: v / (1 - _BETA1) for k, v in _norms(moments).items()}


def run(run, program_overrides=None) -> dict:
    """One run of the cell on one card, then the comparison."""
    side = _train(run, program_overrides, torch.device(run.device))
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    checks = _compare(run, side, side["notes"])
    checks["graph_mismatch"] = float(side["graph_mismatch"])
    side["work"]["n_edges"] = len(side["graph"][1])
    return {"metrics": side["metrics"], "attempted": side["steps"], "failed": 0,
            "checks": checks, "notes": side["notes"], "memory_peak_bytes": side["peak"], "work": side["work"]}


def _norms(values: dict) -> dict:
    """Each leaf's norm."""
    names = list(values)
    norms = torch.stack([values[k].detach().float().norm() for k in names])
    return {k: float(v) for k, v in zip(names, norms.tolist())}


def _train(run, program_overrides, dev) -> dict:
    """The program's side of a run: set-up, the window, and what the
    comparison reads."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda
    from image_generation_tpu_torch.training.trainer import Trainer

    conf, mix = run.config, run.traffic
    settings = dict(conf["training"])
    marks = [("imports", time.perf_counter())]
    cfg = TrainingConfig(**{**settings, "RANDOM_SEED": conf["graph_seed"],
                            **(program_overrides or {})})
    images = make_dataset(run.seed, conf["dataset_size"], settings["IMAGE_SIZE"],
                          conf["ink"], dev)
    trainer = Trainer(cfg, device=dev, seed=run.seed, mesh=None)
    trainer.images = images
    trainer.setup()
    marks.append(("graph and plan", time.perf_counter()))
    trainer.train_init(mix["schedule_epochs"])
    marks.append(("train_init", time.perf_counter()))
    nb, bsz = trainer.n_batches, cfg.BATCH_SIZE
    checked = mix["checked_steps"]
    p0 = {k: v.detach().to("cpu", copy=True) for k, v in _leaves(trainer).items()}
    # the burned-in ladder and its energies, under the model both sides start from
    seen = {"start": (trainer.state.chains.to("cpu", copy=True),
                      trainer.state.chain_energies.to("cpu", copy=True))}

    def setup_cb(done, _nb):
        if done == 1:
            seen["first_grad"] = _first_moments(trainer)
        if done == checked:
            seen["change"] = _norms({k: v.detach() - p0[k].to(dev)
                                     for k, v in _leaves(trainer).items()})
            seen["chains"] = trainer.state.chains.to("cpu", copy=True)

    trainer.train_epoch(0, batch_cb=setup_cb, n_chunks=nb)
    marks.append(("epoch 0", time.perf_counter()))
    del p0
    tracer = None
    if run.trace:
        from core import Tracer

        tracer = Tracer()
        tracer.warm(lambda: torch.ones(1 << 20, device=dev).sum())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - run.t_start
    t_prev = run.t_start
    notes = [f"sampler {trainer.fns.sampler_impl}, chain rows split {trainer.fns.train_rows.n} "
             f"ways"]
    for name, t in marks + [("the rest", run.t_start + setup_s)]:
        notes.append(f"set-up {name}: {t - t_prev:.3f} s")
        t_prev = t

    launches = lambda: (sum(gibbs_cuda.gibbs_sweeps_cuda.launches.values())
                        + sum(gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches.values()))
    work = {"steps": [], "gather_launches": 0}
    state = {"steps": 0, "epoch": 1, "trace_from": None}
    t0 = time.perf_counter()
    t_end = t0 + run.seconds

    def traced(now: float) -> bool:
        """Whether the step just issued falls in the traced stretch:
        ``trace_s`` of whole steps from ``trace_skip_s`` on."""
        if state["trace_from"] is None and now - t0 >= mix["trace_skip_s"]:
            tracer.start()
            state["trace_from"] = (now, launches())
            return False
        return state["trace_from"] is not None

    def window_cb(_done, _nb):
        state["steps"] += 1
        now = time.perf_counter()
        if run.trace and tracer.summary is None and traced(now):
            step = trainer.state.opt_step - 1
            work["steps"].append(state["epoch"] < 6 and step % 10 == 0)
            if now - state["trace_from"][0] >= mix["trace_s"]:
                tracer.stop()
                work["gather_launches"] = launches() - state["trace_from"][1]
        if now >= t_end:
            raise _WindowClosed

    try:
        while True:
            trainer.train_epoch(state["epoch"], batch_cb=window_cb, n_chunks=nb)
            state["epoch"] += 1
    except _WindowClosed:
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if run.trace and tracer.summary is None:
        raise RuntimeError("the window closed before the traced stretch did: "
                           "trace_skip_s + trace_s must fit in it")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    work.update(trace=tracer.summary if tracer else None, config=dict(settings),
                window_s=window_s)
    graph = load_graph(run)
    return {"metrics": {"train_images_per_s": state["steps"] * bsz / window_s,
                        "setup_s": setup_s},
            "steps": state["steps"], "peak": peak, "work": work, "notes": notes,
            "graph": graph, "graph_mismatch": _graph_mismatch(trainer.graph, graph),
            "losses": list(trainer.losses["dvae_losses"][:checked]), "seen": seen,
            "settings": settings}


def _graph_mismatch(program_graph, frozen) -> int:
    n, ei, ej = frozen
    if program_graph.n != n or len(program_graph.edge_i) != len(ei):
        return max(len(ei), 1)
    return int(((program_graph.edge_i != ei) | (program_graph.edge_j != ej)).sum())


def _compare(run, side, notes) -> dict:
    """The reference's readings of the checked steps against the program's."""
    dev = torch.device(run.device)
    settings, graph, losses, seen = side["settings"], side["graph"], side["losses"], side["seen"]
    checked = run.traffic["checked_steps"]
    images = make_dataset(run.seed, run.config["dataset_size"], settings["IMAGE_SIZE"],
                          run.config["ink"], dev)
    ref = ReferenceRun(settings, graph, images, run.seed,
                       run.traffic["schedule_epochs"] * (images.shape[0]
                                                         // settings["BATCH_SIZE"]))
    p0 = {k: v.clone() for k, v in ref.leaves().items()}
    start_chains = ref.chains.clone()
    start_energies = None if ref.energies is None else ref.energies.clone()
    ref.start_epoch()
    ref_losses, first = [], None
    for _ in range(checked):
        out = ref.step(epoch=0)
        ref_losses.append(out["loss"])
        if first is None:
            first = out
    grad_norm = {k: float(v.norm()) for k, v in first["grad"].items()}
    taken_norm = {k: float(v.norm()) for k, v in first["taken"].items()}
    change = {k: float((v - p0[k]).norm()) for k, v in ref.leaves().items()}
    # leaves that only round-off moves (a bias under BatchNorm): a loss
    # gradient under a thousandth of the median leaf's
    median_grad = float(np.median(list(grad_norm.values())))
    moved = [k for k, v in grad_norm.items() if v >= 1e-3 * median_grad]
    chains = seen["chains"].to(dev)
    grad = leaf_gaps(seen["first_grad"], taken_norm)
    update = leaf_gaps({k: seen["change"][k] for k in moved}, {k: change[k] for k in moved})
    notes.append(f"losses {losses} against the reference's {ref_losses}")
    for what, gaps, prog, ref_n in (("first gradient", grad, seen["first_grad"], taken_norm),
                                    ("change", update, seen["change"], change)):
        for k in sorted(gaps, key=gaps.get, reverse=True)[:3]:
            notes.append(f"{what} of {k}: {prog.get(k, 0.0)!r} against {ref_n[k]!r} "
                         f"(gap {gaps[k]:.3g})")
    notes.append(f"leaves left out of the change (loss gradient under a thousandth of the "
                 f"median leaf's): {sorted(set(grad_norm) - set(moved))}")
    notes.append(f"first gradient: worst leaf's gap {max(grad.values())!r}")
    # the burned-in ladder's energies where a chain's spins agree, under the
    # start model both sides share: they read the coupling's precision, which
    # the chains of a fresh model (couplings ~1e-4, every spin near even odds)
    # barely show
    out = {
        "loss_gap": max(relative_gap(a, b) for a, b in zip(losses, ref_losses)),
        # the median leaf's: the worst leaf's reads one small leaf's bf16 rounding
        "grad_gap": float(np.median(list(grad.values()))),
        "update_gap": max(update.values()),
        "chain_mismatch": float((chains != ref.chains).float().mean()),
    }
    if start_energies is not None:  # a ladder carries its energies
        s_prog, e_prog = (t.to(dev) for t in seen["start"])
        same = (s_prog == start_chains).all(-1)
        gap = (e_prog[same] - start_energies[same]).abs()
        scale = float(start_energies.abs().median())
        out["energy_gap"] = float(gap.max()) / scale if gap.numel() else 1.0
    return out
