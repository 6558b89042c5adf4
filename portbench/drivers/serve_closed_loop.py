"""Serving traffic: closed-loop clients of the port's warm generator.

Mix parameters (``traffic/<mix>.json``): ``clients`` threads, each sending
its next request when its reply comes; ``max_batch`` and ``window_ms``, the
coalescer's settings; ``sharpen``; ``kept_per_client``, the replies each
client keeps for the comparison (a reservoir drawn from the seed, so every
reply of the window has the same chance); ``warm_s``, the seconds the
clients run in set-up before the window opens; ``trace_skip_s`` and
``trace_s`` (the traced run's stretch: whole dispatches).  Configuration:
``training`` (the serving settings, handed to ``TrainingConfig``) and
``checkpoint`` (the model directory under this benchmark that is served).

Set-up loads the model into ``WarmGenerator``, runs one dispatch of every
group size up to ``clients`` (``warm_buckets``), then starts the clients:
each calls ``WarmGenerator.serve`` in a closed loop, and the window opens
``warm_s`` later, once the coalescer's groups have settled, with the
clients running on through it.  A reply counts when it returns inside the
window, and every request sent before the window closes is waited for.  Every
dispatch passes through a recorder that numbers it and tags each reply
with (dispatch, slot, group size): the reference draws what that dispatch
drew and works out that slot's images.

The profiler is warmed in set-up in every run.  An untraced run profiles
the whole window, between dispatches, and reports the card's busy time over
the images those dispatches served (``serve_card_us_per_image``); a traced
run profiles only its stretch, for the per-layer readings.  The images
returned in the window over its seconds are a per-layer reading: the host's
pace of the clients sets them, and they spread too widely to bound.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from reference.serve import ReferenceServer

# a pixel further than this from the reference's is not the bf16 decode's
# rounding (at most 4 levels in every sound run) but another image
CHANGED_LEVELS = 8.0


class Tagged(np.ndarray):
    """A reply's images, carrying (dispatch, slot, group size)."""

    def __array_finalize__(self, obj):
        self.portbench_tag = getattr(obj, "portbench_tag", None)


class Recorder:
    """Numbers every dispatch of a ``WarmGenerator`` in the order it draws
    its generator, tags each reply, and lets the traced run hold
    dispatches back at the stretch's ends (``gate``)."""

    def __init__(self, wg):
        self.gate = threading.Lock()
        self.count = 0
        self.traced = None  # group sizes of the dispatches inside the stretch
        inner = wg._run_group

        def run_group(group):
            with self.gate:
                d = self.count
                self.count += 1
                inner(group)
                if self.traced is not None:
                    self.traced.append(len(group))
            for i, r in enumerate(group):
                if r.result is not None:
                    imgs, k = r.result
                    tagged = imgs.view(Tagged)
                    tagged.portbench_tag = (d, i, len(group))
                    r.result = (tagged, k)

        wg._run_group = run_group
        wg._coalescer._run_group = run_group


def run(run, program_overrides=None) -> dict:
    from image_generation_tpu_torch.app.warm import WarmGenerator
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda

    dev = torch.device(run.device)
    conf, mix = run.config, run.traffic
    settings = dict(conf["training"])
    model = str(run.root / conf["checkpoint"])
    workdir = tempfile.mkdtemp(prefix="portbench_serve_")
    try:
        wg = WarmGenerator(workdir, config_overrides={**settings, "RANDOM_SEED": run.seed,
                                                      **(program_overrides or {})},
                           device=dev, mesh=None, serve_max_batch=mix["max_batch"],
                           serve_window_ms=mix["window_ms"])
        rec = Recorder(wg)
        t_warm = time.perf_counter()
        wg.warm_buckets(model, mix["clients"])
        from core import Tracer

        # profiled in every run: the whole window (the card's time an image)
        # or, traced, a stretch of it (the per-layer readings)
        tracer = Tracer()
        tracer.warm(lambda: wg.warm_buckets(model, 1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_loop = time.perf_counter()
        out = _window(run, wg, rec, model, tracer,
                      lambda: (sum(gibbs_cuda.gibbs_sweeps_cuda.launches.values())
                               + sum(gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches.values())))
        setup_s = out.pop("t0") - run.t_start
        notes = [f"set-up before the model: {t_warm - run.t_start:.3f} s; the model's load "
                 f"and one dispatch a group size: {t_loop - t_warm:.3f} s; the clients' "
                 f"closed loop before the window: {run.t_start + setup_s - t_loop:.3f} s"]
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del wg
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _compare(run, settings, model, out.pop("kept"), notes)
    checks["unanswered"] = float(out["failed"])
    out["notes"] = notes + out["notes"]
    out["metrics"]["setup_s"] = setup_s
    out.update(checks=checks, memory_peak_bytes=peak)
    out["work"].update(config=dict(settings, N_LATENTS=_n_latents(model)),
                       n_edges=_n_edges(model))
    return out


def _window(run, wg, rec, model, tracer, launches) -> dict:
    mix = run.traffic
    t0 = time.perf_counter() + mix["warm_s"]
    t_end = t0 + run.seconds
    done, lock = [], threading.Lock()
    kept = []

    def client(c: int):
        rng = np.random.default_rng([run.seed, c])
        reservoir, seen = [], 0
        while True:
            ta = time.perf_counter()
            if ta >= t_end:
                break
            try:
                reply = wg.serve(model, sharpen=mix["sharpen"])
                images, ok = reply["images"], True
            except Exception:  # a failed request counts against the run
                images, ok = None, False
            tb = time.perf_counter()
            with lock:
                done.append((ta, tb, 0 if images is None else len(images), ok))
            if ok and tb > t0:
                seen += 1
                if len(reservoir) < mix["kept_per_client"]:
                    reservoir.append(images)
                else:
                    j = int(rng.integers(0, seen))
                    if j < mix["kept_per_client"]:
                        reservoir[j] = images
        with lock:
            kept.extend(reservoir)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(mix["clients"])]
    for t in threads:
        t.start()
    time.sleep(max(0.0, t0 - time.perf_counter()))
    stats0 = wg.stats
    trace, stretch = None, (t_end, t_end)
    if run.trace:
        time.sleep(mix["trace_skip_s"])
        with rec.gate:
            tracer.start()
            n0, rec.traced, s0 = launches(), [], time.perf_counter()
        time.sleep(mix["trace_s"])
        with rec.gate:
            trace = tracer.stop()
            traced, rec.traced = rec.traced, None
            gather, stretch = launches() - n0, (s0, time.perf_counter())
    else:
        # the whole window, from the first dispatch that starts in it to the
        # last that ends in it: the card's busy time over the images served
        with rec.gate:
            tracer.start()
            rec.traced = []
        time.sleep(max(0.0, t_end - time.perf_counter()))
        with rec.gate:
            trace = tracer.stop()
            traced, rec.traced = rec.traced, None
    for t in threads:
        t.join(timeout=run.seconds + 120)
    stuck = sum(t.is_alive() for t in threads)
    stats1 = wg.stats
    served = [d for d in done if d[3] and t0 < d[1] <= t_end]
    # the tail of every request that returned in the window, but those that
    # overlap a traced stretch, which the profiler slows
    lat = [(tb - ta) * 1e3 for ta, tb, _, ok in done
           if ok and tb > t0 and (tb < stretch[0] or ta > stretch[1])]
    metrics, notes = {"serve_images_per_s": sum(d[2] for d in served) / run.seconds}, []
    if not run.trace:
        images = sum(traced) * run.config["training"]["NUM_READS"]
        metrics["serve_card_us_per_image"] = trace["busy_s"] / max(images, 1) * 1e6
        notes.append(f"the card busy {trace['busy_s']!r} s of the profiled "
                     f"{trace['stretch_s']!r} s, for {images} images in {len(traced)} dispatches")
    quarter = run.seconds / 4
    notes += ["images returned by quarter of the window: " + ", ".join(
        str(sum(d[2] for d in served if t0 + q * quarter < d[1] <= t0 + (q + 1) * quarter))
        for q in range(4))]
    notes.append(f"requests a dispatch over the window: {stats1['served'] - stats0['served']}"
                 f" in {stats1['dispatches'] - stats0['dispatches']}")
    if run.trace:
        notes.append(f"dispatches in the traced stretch: {len(traced)}, group sizes {traced}")
    work = {"trace": trace if run.trace else None, "dispatches": traced if run.trace else [],
            "images_per_s": metrics["serve_images_per_s"],
            "request_ms_p95": float(np.percentile(lat, 95)) if lat else None,
            "gather_launches": gather if run.trace else 0,
            "requests_per_dispatch": ((stats1["served"] - stats0["served"])
                                      / max(stats1["dispatches"] - stats0["dispatches"], 1))}
    # a request that failed in the set-up's loop fails the run as well
    return {"metrics": metrics, "attempted": sum(d[1] > t0 for d in done) + stuck,
            "failed": sum(not d[3] for d in done) + stuck, "kept": kept, "work": work,
            "notes": notes, "t0": t0}


def _n_latents(model) -> int:
    import json

    with open(f"{model}/parameters.json") as f:
        return int(json.load(f)["n_latents"])


def _n_edges(model) -> int:
    return int(torch.load(f"{model}/grbm.pth", map_location="cpu",
                          weights_only=True)["_edge_idx_i"].shape[0])


def _compare(run, settings, model, kept, notes) -> dict:
    """Each kept reply against the reference's images of its slot: the
    share of images with a pixel more than ``CHANGED_LEVELS`` off.  A
    sound reply differs by the decode's rounding; a chain that went
    another way (a uniform within rounding of its spin's probability) is
    one changed image, which the share's limit leaves room for.  The
    notes give the widest pixel gap and the images past a few levels."""
    dev = torch.device(run.device)
    tags = [getattr(k, "portbench_tag", None) for k in kept]
    if not kept or any(t is None for t in tags):
        return {"changed_images": 1.0}
    ref = ReferenceServer(model, settings, run.seed, dev)
    got = torch.as_tensor(np.stack([np.rint(np.asarray(k) * 255.0) for k in kept]),
                          dtype=torch.float32, device=dev)
    want = torch.cat([ref.images(tags[i:i + 16]) for i in range(0, len(tags), 16)]).float()
    widest = (got - want.reshape(got.shape)).abs().flatten(2).amax(-1)
    notes.append(f"widest pixel gap {float(widest.max())!r} levels; images with a pixel "
                 + ", ".join(f"over {lv} levels {int((widest > lv).sum())}"
                             for lv in (2, 4, 8, 16, 64)) + f", of {widest.numel()}")
    return {"changed_images": float((widest > CHANGED_LEVELS).float().mean())}
