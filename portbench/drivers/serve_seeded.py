"""Serving traffic on a model drawn from the seed: closed-loop clients of
the port's warm generator, served a model too large to commit.

The mix (``traffic/<mix>.json``) is ``serve_closed_loop``'s, and so are
the clients, the coalescer's settings, the window, the traced stretch and
the tagging of every reply (that driver's ``Recorder`` and ``_window``,
loaded as they are).  The configuration's ``training`` settings go to
``TrainingConfig``; its ``graph`` is the frozen coupling graph, and
``seeded`` the sizes the weights are drawn at.

Set-up writes the model directory the program serves, in the reference
model's format, from ``--seed`` on the card: ``dvae.pth`` (each weight
normal with the training initialiser's LeCun deviation, clipped at two,
zero biases, BatchNorm at unit scale and running variance; the last
transposed convolution's bias at ``seeded.decoder_bias``, which centres
the images inside the uint8 range), ``grbm.pth`` (the graph's edges; each
field and coupling, times the prefactor, normal at ``seeded.h`` /
``seeded.J``'s mean and deviation, clipped at its ``max``) and
``parameters.json``.  Then it serves that directory as
``serve_closed_loop`` serves a checkpoint.

The comparison (``reference/serve_int8.py``) reads two numbers.  Each kept
reply's images against the reference's of its slot, as
``serve_closed_loop`` reads them (``changed_images``).  And the kept
slots' spins: after the window, with the clients done, the program's own
sampler (``SampleFns.sample_fn`` of the served trainer, as a dispatch
calls it) runs each kept reply's dispatch again from that dispatch's
generator seed, and ``spin_mismatch`` is the share of those slots' spins
unlike the reference's.  A sampler at another precision moves single
spins of these weak couplings, which no image shows past the bf16
decode's rounding.
"""

from __future__ import annotations

import gc
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from core import load_module
from reference import dvae as ref_dvae
from reference.serve_int8 import Int8ReferenceServer

_loop = load_module("drivers", "serve_closed_loop")


def _normal(g, shape, mean, std, bound, device) -> torch.Tensor:
    t = torch.randn(shape, generator=g, device=device) * std + mean
    return t.clamp_(-bound, bound)


def write_model(run, path: Path, device) -> int:
    """The seeded model directory of ``run`` at ``path``; returns n."""
    conf, seeded = run.config, run.config["seeded"]
    cfg = conf["training"]
    with np.load(run.root / conf["graph"]) as z:
        n, ei, ej = int(z["n"]), z["edge_i"].astype(np.int64), z["edge_j"].astype(np.int64)
    g = torch.Generator(device=device)
    g.manual_seed(int(run.seed))
    sd = {}
    for name, shape, fan_in in ref_dvae._shapes(n):
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        sd[f"{name}.weight"] = _normal(g, shape, 0.0, std, 2.0 * std, device)
        sd[f"{name}.bias"] = torch.zeros(shape[1] if "convtrans" in name else shape[0],
                                         device=device)
    sd[f"{ref_dvae.DEC}.{ref_dvae.LAST_DECONV}.bias"].fill_(seeded["decoder_bias"])
    for prefix, keys, chans in ((ref_dvae.ENC, ref_dvae.CONV_KEYS, (32, 64, 128, n)),
                                (ref_dvae.DEC, ref_dvae.DECONV_KEYS, (128, 64, 32, 1))):
        for k, c in zip(keys, chans):
            bn = f"{prefix}.{k + 1}"
            for key, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                              ("running_var", 1.0)):
                sd[f"{bn}.{key}"] = torch.full((c,), fill, device=device)
            sd[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    pre = cfg["PREFACTOR"]
    h, j = seeded["h"], seeded["J"]
    grbm = {"_linear": _normal(g, (n,), h["mean"], h["std"], h["max"], device) / pre,
            "_quadratic": _normal(g, (len(ei),), j["mean"], j["std"], j["max"], device) / pre,
            "_edge_idx_i": torch.from_numpy(ei), "_edge_idx_j": torch.from_numpy(ej)}
    path.mkdir(parents=True)
    torch.save({k: v.cpu().clone() for k, v in sd.items()}, path / "dvae.pth")
    torch.save({k: v.cpu() for k, v in grbm.items()}, path / "grbm.pth")
    (path / "parameters.json").write_text(json.dumps({
        "n_latents": n, "qpu": cfg["QPU"], "prefactor": pre, "num_read": cfg["NUM_READS"],
        "image_size": cfg["IMAGE_SIZE"], "random_seed": int(run.seed)}))
    return n


def run(run, program_overrides=None) -> dict:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda

    from core import Tracer

    dev = torch.device(run.device)
    mix, settings = run.traffic, dict(run.config["training"])
    workdir = tempfile.mkdtemp(prefix="portbench_serve_")
    try:
        model = str(Path(workdir) / "model")
        write_model(run, Path(model), dev)
        t_model = time.perf_counter()
        wg = WarmGenerator(workdir, config_overrides={**settings, "RANDOM_SEED": run.seed,
                                                      **(program_overrides or {})},
                           device=dev, mesh=None, serve_max_batch=mix["max_batch"],
                           serve_window_ms=mix["window_ms"])
        rec = _loop.Recorder(wg)
        wg.warm_buckets(model, mix["clients"])
        tracer = Tracer()
        tracer.warm(lambda: wg.warm_buckets(model, 1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_loop = time.perf_counter()
        out = _loop._window(run, wg, rec, model, tracer,
                            lambda: (sum(gibbs_cuda.gibbs_sweeps_cuda.launches.values())
                                     + sum(gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches.values())))
        setup_s = out.pop("t0") - run.t_start
        notes = [f"set-up before the model: {t_model - run.t_start:.3f} s, the seeded model "
                 f"written in it; the model's load and one dispatch a group size: "
                 f"{t_loop - t_model:.3f} s; the clients' closed loop before the window: "
                 f"{run.t_start + setup_s - t_loop:.3f} s"]
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        kept = out.pop("kept")
        tags = [getattr(k, "portbench_tag", None) for k in kept]
        ref = Int8ReferenceServer(model, settings, run.seed, dev)
        resampled = None if not kept or None in tags else _resample(wg, model, ref, tags)
        del wg
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = _compare(ref, kept, tags, resampled, notes)
        n_latents, n_edges = _loop._n_latents(model), _loop._n_edges(model)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks["unanswered"] = float(out["failed"])
    out["notes"] = notes + out["notes"]
    out["metrics"]["setup_s"] = setup_s
    out.update(checks=checks, memory_peak_bytes=peak)
    out["work"].update(config=dict(settings, N_LATENTS=n_latents), n_edges=n_edges)
    return out


def _resample(wg, model, ref, tags) -> dict:
    """{tag: (reads, n) int8 spins}: the program's sampler run again for
    each kept tag's dispatch, from that dispatch's generator seed."""
    trainer = wg._trainer_for(model)
    cfg = trainer.config
    reads, sweeps = cfg.NUM_READS, cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS
    out = {}
    with torch.inference_mode():
        for d, k in sorted({(d, k) for d, _i, k in tags}):
            g = torch.Generator(device=trainer.device)
            g.manual_seed(ref.dispatch_seed(d))
            spins = trainer.fns.sample_fn(g, trainer.grbm_params, k * reads, sweeps)
            for d2, i, k2 in tags:
                if (d2, k2) == (d, k):
                    out[(d, i, k)] = spins[i * reads:(i + 1) * reads].to(torch.int8)
    return out


def _compare(ref, kept, tags, resampled, notes) -> dict:
    """``changed_images`` as ``serve_closed_loop`` reads it, and
    ``spin_mismatch``: the share of the kept slots' spins, sampled again
    by the program, unlike the reference's."""
    if not kept or resampled is None:
        return {"changed_images": 1.0, "spin_mismatch": 1.0}
    dev = ref.dev
    got = torch.as_tensor(np.stack([np.rint(np.asarray(k) * 255.0) for k in kept]),
                          dtype=torch.float32, device=dev)
    inside = float(((got > 0) & (got < 255)).float().mean())
    wrong, total, chains = 0, 0, 0
    want = []
    for i in range(0, len(tags), 16):
        part = tags[i:i + 16]
        spins = ref.spins(part)
        with torch.no_grad():
            img = ref_dvae.decode(ref.w, spins[:, None, :], train=False)[:, 0]
            want.append(torch.round(torch.clamp(img, 0.0, 1.0) * 255.0))
        mine = torch.cat([resampled[t] for t in part]).float()
        differ = mine != spins
        wrong += int(differ.sum())
        chains += int(differ.any(1).sum())
        total += differ.numel()
    want = torch.cat(want).reshape(got.shape)
    widest = (got - want).abs().flatten(2).amax(-1)
    notes.append(f"served pixels strictly inside (0, 255): {inside!r}; widest pixel gap "
                 f"{float(widest.max())!r} levels; images with a pixel "
                 + ", ".join(f"over {lv} levels {int((widest > lv).sum())}"
                             for lv in (2, 4, 8, 16, 64)) + f", of {widest.numel()}")
    notes.append(f"spins sampled again unlike the reference's: {wrong} of {total}, "
                 f"in {chains} of {total // ref.n} chains")
    return {"changed_images": float((widest > _loop.CHANGED_LEVELS).float().mean()),
            "spin_mismatch": wrong / max(total, 1)}
