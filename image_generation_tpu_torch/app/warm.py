"""In-process warm generation serving with request coalescing.

Port of the serving half of ``image_generation_tpu/app/warm.py``.
``WarmGenerator`` keeps one loaded :class:`Trainer` resident; ``serve()``
is the concurrent surface (the server's ``POST /api/generate_now``):
requests that arrive while a dispatch is in flight are queued and served
together through one fused sample → decode dispatch, their chains folded
into the chain dimension of one sampler call (chains are iid: request i
owns rows [i·reads, (i+1)·reads)).  The leader/follower ``_Coalescer`` is
the JAX package's, unchanged.

PyTorch runs eagerly and keeps no compiled executable per shape, so a
group of k requests runs exactly k·NUM_READS chains: the JAX package's
padding to a power-of-two bucket would only add work here.
``WarmGenerator.generate`` is the artifact writer: one request written as
the CLI's ``generate`` writes it.  The resident trainer is loaded without
the dataset and train state (``Trainer.load(train_state=False)``);
``generate`` adds them on first use (``Trainer.load_train_state``).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.training.trainer import Trainer
from image_generation_tpu_torch.utils.device import resolve_device
from image_generation_tpu_torch.utils.grid import make_grid, sharpen as _sharpen


class _Request:
    """One ``serve()`` call waiting for its slice of a fused dispatch."""

    __slots__ = ("group", "done", "result", "error")

    def __init__(self, group: str):
        self.group = group
        self.done = False
        self.result = None
        self.error = None


class _Coalescer:
    """Leader/follower request batcher (see the JAX package's class).

    ``submit()`` enqueues the request; the first thread to find no leader
    becomes the leader and repeatedly takes every pending request of the
    head request's group (up to ``max_batch``), runs them through
    ``run_group`` in one dispatch and wakes them, until its own request is
    served; then it steps down and wakes a waiting follower to lead what
    remains.  ``window_s`` is the batching window the leader sleeps before
    each drain.  All queue state lives under one condition variable."""

    def __init__(self, run_group, max_batch: int, window_s: float = 0.005):
        self._cv = threading.Condition()
        self._pending: list[_Request] = []
        self._busy = False
        self._run_group = run_group
        self.max_batch = max_batch
        self.window_s = window_s
        self.dispatches = 0  # fused device dispatches
        self.served = 0      # requests completed

    def submit(self, req: _Request):
        lead = False
        with self._cv:
            self._pending.append(req)
            while not req.done and self._busy:
                self._cv.wait()
            if not req.done:
                self._busy = lead = True
        if lead:
            self._lead(req)
        if req.error is not None:
            raise req.error
        return req.result

    def _lead(self, own: _Request):
        """Dispatch groups until ``own`` is served, then hand off."""
        group: list[_Request] = []
        try:
            while True:
                with self._cv:
                    if own.done:
                        self._busy = False
                        if self._pending:
                            self._cv.notify_all()
                        return
                if self.window_s > 0:
                    time.sleep(self.window_s)
                with self._cv:
                    g = self._pending[0].group
                    group = [r for r in self._pending if r.group == g]
                    group = group[: self.max_batch]
                    for r in group:
                        self._pending.remove(r)
                try:
                    self._run_group(group)
                except Exception as e:  # surfaced to every request of the group
                    for r in group:
                        r.error = e
                with self._cv:
                    self.dispatches += 1
                    self.served += len(group)
                    for r in group:
                        r.done = True
                    self._cv.notify_all()
        except BaseException:
            # never strand followers: step down and wake the queue
            with self._cv:
                self._busy = False
                stranded, self._pending = self._pending, []
                for r in stranded + [r for r in group if not r.done]:
                    r.error = r.error or RuntimeError("serving leader died")
                    r.done = True
                self._cv.notify_all()
            raise


class WarmGenerator:
    def __init__(self, workdir, config_overrides: Optional[dict] = None,
                 device="cuda", mesh="auto", params=None, serve_max_batch: int = 16,
                 serve_window_ms: float = 5.0):
        """``config_overrides``: TrainingConfig field overrides for the
        serving trainer (the checkpoint's parameters.json still decides
        N_LATENTS).  ``device``: where the trainer runs (the card unless
        ``"cpu"``; with no card visible a CUDA server raises).
        ``mesh``: the Trainer's (``"auto"``, the CLI's default: the
        initialised ``torch.distributed`` world, if any; a mesh the port
        cannot run raises there).  ``params``: a training-parameters YAML
        path (the CLI's ``--params``), applied under the overrides as the
        CLI's ``_build_trainer`` applies it.
        ``serve_max_batch`` / ``serve_window_ms``: the most requests
        folded into one dispatch, and the batching window the leader
        waits before each drain."""
        self.workdir = Path(workdir)
        self.config_overrides = dict(config_overrides or {})
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.lock = threading.Lock()
        self._trainer = None
        self._key = None  # (resolved model dir, dvae.pth mtime_ns)
        self._coalescer = _Coalescer(
            self._run_group, max_batch=serve_max_batch,
            window_s=serve_window_ms / 1e3,
        )

    def _trainer_for(self, model_path):
        mp = Path(model_path)
        key = (str(mp.resolve()), (mp / "dvae.pth").stat().st_mtime_ns)
        if self._key != key:
            cfg = (TrainingConfig.from_yaml(self.params, **self.config_overrides)
                   if self.params else TrainingConfig(**self.config_overrides))
            cfg = cfg.for_serving_dir(mp)
            trainer = Trainer(config=cfg, device=self.device, mesh=self.mesh)
            trainer.load(mp, train_state=False)
            self._trainer, self._key = trainer, key
        return self._trainer

    def generate(self, model_path, sharpen: bool = False) -> None:
        """One generation request written as the CLI's ``generate`` writes
        it: the ``generated_json`` figures and details and the model-diagram
        assets under ``workdir``, assets before the epoch-figure trigger."""
        from image_generation_tpu_torch.app.cli import _write_details, _write_diagram_assets
        from image_generation_tpu_torch.app.files import RunFiles

        with self.lock:
            t = self._trainer_for(model_path)
            if t.state is None:
                t.load_train_state()
            gen = t.generate_output(do_sharpen=sharpen)
            files = RunFiles(self.workdir)
            files.clean()
            _write_details(t, files)
            rec = t.generate_reconstructed_samples(do_sharpen=sharpen)
            _write_diagram_assets(t, files, gen)
            files.write_epoch(0, gen["grid"], rec["grid"],
                              t.losses["mse_losses"], t.losses["dvae_losses"])

    @property
    def stats(self) -> dict:
        """Coalescing counters: fused dispatches vs requests served."""
        c = self._coalescer
        return {"dispatches": c.dispatches, "served": c.served}

    def serve(self, model_path, sharpen: bool = False) -> dict:
        """One synchronous generation request, coalescing-aware: returns
        {'grid', 'images', 'batched'}, where ``batched`` is how many
        requests shared this request's dispatch.  The uint8 → f32
        conversion, optional sharpen and grid assembly run in the calling
        thread."""
        req = _Request(str(Path(model_path).resolve()))
        imgs8, batched = self._coalescer.submit(req)
        out = imgs8.astype(np.float32) / 255.0
        if sharpen:
            out = _sharpen(out)
        return {"grid": make_grid(out, nrow=16), "images": out,
                "batched": batched}

    def warm_buckets(self, model_path, max_concurrency: int) -> list:
        """Run one dispatch for every group size a burst of up to
        ``max_concurrency`` requests can form (capped at the coalescer's
        ``max_batch``).  The first dispatch loads the model and builds the
        kernel; each size's first dispatch also pays cuDNN's per-shape plan
        choice and the allocator's growth (PERF.md).  Returns the group
        sizes warmed."""
        model = str(Path(model_path).resolve())
        sizes = list(range(1, min(max(1, max_concurrency), self._coalescer.max_batch) + 1))
        for k in sizes:
            self._run_group([_Request(model) for _ in range(k)])
        return sizes

    def _run_group(self, group) -> None:
        """Serve ``group`` (one model) through one fused dispatch.  Each
        request's ``result`` is its raw (reads, S, S, 1) uint8 slice plus
        the batch count."""
        with self.lock:
            t = self._trainer_for(group[0].group)
            k = len(group)
            imgs8 = self._serve_fn(t, k)  # (k, reads, S, S, 1)
        for i, r in enumerate(group):
            r.result = (imgs8[i], k)

    def _serve_fn(self, trainer, k: int):
        """The fused dispatch for ``k`` requests: one sampler call of
        k·NUM_READS chains, one decode, a clip and a uint8 quantisation on
        the device; returns the host uint8 array."""
        cfg = trainer.config
        reads = cfg.NUM_READS
        sweeps = cfg.GIBBS_BURN_IN + cfg.GIBBS_SWEEPS
        with torch.inference_mode():
            spins = trainer.fns.sample_fn(
                trainer._next_generator(), trainer.grbm_params,
                k * reads, sweeps,
            )  # (k·reads, n)
            out = trainer.dvae.decode(spins[:, None, :])[:, 0]
            img8 = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
            img8 = img8.reshape(k, reads, *img8.shape[1:])
            return img8.cpu().numpy()
