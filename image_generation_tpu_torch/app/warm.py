"""In-process warm generation serving with request coalescing.

Port of the serving half of ``image_generation_tpu/app/warm.py``.
``WarmGenerator`` keeps one loaded :class:`Trainer` resident; ``serve()``
is the concurrent surface (the server's ``POST /api/generate_now``):
requests that arrive while a dispatch is in flight are queued and served
together through one fused sample → decode dispatch, their chains folded
into the chain dimension of one sampler call (chains are iid: request i
owns rows [i·reads, (i+1)·reads)).  The leader/follower ``_Coalescer`` is
the JAX package's, with the port's spans (``training.observability``): a
request's ``coalescer.queue`` and ``serve.reply``, a dispatch's
``serve.dispatch`` (its requests' ids) and, inside ``_serve_fn``,
``serve.sample`` and ``serve.decode``.

PyTorch runs eagerly and keeps no compiled executable per shape, so a
group of k requests runs exactly k·NUM_READS chains: the JAX package's
padding to a power-of-two bucket would only add work here.
``WarmGenerator.generate`` is the artifact writer: one request written as
the CLI's ``generate`` writes it.  The resident trainer is loaded without
the dataset and train state (``Trainer.load(train_state=False)``);
``generate`` adds them on first use (``Trainer.load_train_state``).

Several cards (``make_warm_generator``, as the JAX ``WarmGenerator(mesh=
"auto")`` samples on every local chip): where the ``--mesh`` value asks
for n > 1 ranks (``parallel.mesh.local_world_size``: 'auto' every visible
card) and no launcher started this process, the serving process becomes
rank 0 of a world of n ranks (NCCL, one card a rank; gloo on the CPU) and
starts n − 1 follower processes (``WarmWorld``).  Every operation on the
device (load a model, serve k requests, write a ``generate`` job) runs on
every rank in lockstep: rank 0 rings each follower's doorbell (a pipe,
which waits without a timeout while the server idles and closes when
rank 0 is gone), broadcasts a small header (the operation and its
integers; a model path by ``broadcast_object_list``), and every rank runs
the same calls, whose collectives are bounded by the world's timeout.
The sampler splits the k·NUM_READS chains over the ranks and returns the
whole on every rank (``SampleFns.sample_fn``); every rank decodes the
whole batch (the same calls on every rank, as a decoder whose dense layer
is column-sharded over the mesh needs), rank 0 answers, and followers
write no files.  A follower that is gone fails the next dispatch, and
every one after it: the server never serves on fewer cards.
"""

from __future__ import annotations

import atexit
import itertools
import os
import signal
import socket
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.training.observability import record, span, tracing
from image_generation_tpu_torch.training.trainer import Trainer
from image_generation_tpu_torch.utils.device import resolve_device
from image_generation_tpu_torch.utils.grid import make_grid, sharpen as _sharpen


_REQUEST_IDS = itertools.count()


class _Request:
    """One ``serve()`` call waiting for its slice of a fused dispatch:
    its id, the clock at its place in the queue (``queued_ns``) and the
    dispatch that serves it with that dispatch's start, which the leader
    stamps, for the spans."""

    __slots__ = ("group", "done", "result", "error", "id", "queued_ns", "dispatch",
                 "dispatch_ns")

    def __init__(self, group: str):
        self.group = group
        self.done = False
        self.result = None
        self.error = None
        self.id = next(_REQUEST_IDS)
        self.queued_ns = self.dispatch_ns = 0
        self.dispatch = None


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
            req.queued_ns = time.perf_counter_ns()
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
                    now = time.perf_counter_ns()
                    for r in group:
                        self._pending.remove(r)
                        r.dispatch, r.dispatch_ns = self.dispatches, now
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
                 serve_window_ms: float = 5.0, world: Optional["WarmWorld"] = None):
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
        waits before each drain.  ``world``: the followers this process
        leads as rank 0 (``make_warm_generator``), told every device
        operation before this process runs it."""
        self.workdir = Path(workdir)
        self.config_overrides = dict(config_overrides or {})
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.world = world
        self.lock = threading.Lock()
        self._trainer = None
        self._key = None  # (resolved model dir, dvae.pth mtime_ns)
        self._coalescer = _Coalescer(
            self._run_group, max_batch=serve_max_batch,
            window_s=serve_window_ms / 1e3,
        )

    def _load(self, model_path) -> Trainer:
        mp = Path(model_path)
        cfg = (TrainingConfig.from_yaml(self.params, **self.config_overrides)
               if self.params else TrainingConfig(**self.config_overrides))
        cfg = cfg.for_serving_dir(mp)
        trainer = Trainer(config=cfg, device=self.device, mesh=self.mesh)
        trainer.load(mp, train_state=False)
        return trainer

    def _trainer_for(self, model_path):
        mp = Path(model_path)
        key = (str(mp.resolve()), (mp / "dvae.pth").stat().st_mtime_ns)
        if self._key != key:
            if self.world is not None:
                self.world.tell(_LOAD, path=str(mp))
            self._trainer, self._key = self._run_world_call(self._load, mp), key
        return self._trainer

    def generate(self, model_path, sharpen: bool = False) -> None:
        """One generation request written as the CLI's ``generate`` writes
        it: the ``generated_json`` figures and details and the model-diagram
        assets under ``workdir``, assets before the epoch-figure trigger."""
        from image_generation_tpu_torch.app.files import RunFiles

        with self.lock:
            t = self._trainer_for(model_path)
            if self.world is not None:
                self.world.tell(_GENERATE, int(sharpen))
            self._run_world_call(self._generate_on, t, sharpen, RunFiles(self.workdir))

    def _generate_on(self, t: Trainer, sharpen: bool, files) -> None:
        """``generate``'s device work and writes on one rank (``files``:
        ``UnwrittenRunFiles`` on a follower)."""
        from image_generation_tpu_torch.app.cli import _write_details, _write_diagram_assets

        if t.state is None:
            t.load_train_state()
        gen = t.generate_output(do_sharpen=sharpen)
        files.clean()
        _write_details(t, files)
        rec = t.generate_reconstructed_samples(do_sharpen=sharpen)
        _write_diagram_assets(t, files, gen)
        files.write_epoch(0, gen["grid"], rec["grid"],
                          t.losses["mse_losses"], t.losses["dvae_losses"])

    def _run_world_call(self, fn, *args):
        """``fn(*args)`` on this rank; with followers, a failure that left
        the world out of step (a follower gone, a collective that timed
        out) fails this dispatch and every later one."""
        if self.world is None:
            return fn(*args)
        try:
            return fn(*args)
        except Exception as e:
            self.world.failed(e)
            raise

    def close(self) -> list:
        """Stop the followers, if any (``WarmWorld.close``); returns their
        reports.  The generator serves no more on several cards."""
        with self.lock:
            return [] if self.world is None else self.world.close()

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
        record("coalescer.queue", req.queued_ns, req.dispatch_ns, request=req.id,
               dispatch=req.dispatch)
        with span("serve.reply", request=req.id):
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
        k = len(group)
        ids = ({"dispatch": group[0].dispatch, "requests": [r.id for r in group], "k": k}
               if tracing() else {})
        with span("serve.dispatch", **ids), self.lock:
            t = self._trainer_for(group[0].group)
            if self.world is not None:
                self.world.tell(_SERVE, k)
            imgs8 = self._run_world_call(self._serve_fn, t, k)  # (k, reads, S, S, 1)
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
            with span("serve.sample"):
                spins = trainer.fns.sample_fn(
                    trainer._next_generator(), trainer.grbm_params,
                    k * reads, sweeps,
                )  # (k·reads, n)
            with span("serve.decode"):
                out = trainer.dvae.decode(spins[:, None, :])[:, 0]
                img8 = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
                img8 = img8.reshape(k, reads, *img8.shape[1:])
            return img8.cpu().numpy()


# ---------------------------------------------------------------------------
# several cards: rank 0 (the serving process) and its followers
# ---------------------------------------------------------------------------

_LOAD, _SERVE, _GENERATE, _STOP = 1, 2, 3, 4
WORLD_TIMEOUT_S = 300.0  # the most a collective of a dispatch waits for a rank
_WORLD_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _world_env(rank: int, n: int, port: int) -> dict:
    return dict(WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _world_mesh(spec):
    """The ``--mesh`` value's mesh over the started world ('auto': the
    world in the JAX default shape), made on every rank in one order."""
    from image_generation_tpu_torch.app.cli import parse_mesh
    from image_generation_tpu_torch.parallel.mesh import auto_mesh

    mesh = parse_mesh(spec)
    return auto_mesh() if mesh == "auto" else mesh


def _read_header(device) -> tuple:
    """A follower's side of ``WarmWorld.tell``: (operation, integer, path)."""
    import torch.distributed as dist

    header = torch.zeros(2, dtype=torch.int64, device=device)
    dist.broadcast(header, src=0)
    op, arg = (int(v) for v in header.tolist())
    path = None
    if op == _LOAD:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        path = box[0]
    return op, arg, path


def _launch_counts() -> dict:
    from image_generation_tpu_torch.ops import gibbs_cuda, gibbs_hbm_cuda

    return {**gibbs_cuda.gibbs_sweeps_cuda.launches,
            **gibbs_hbm_cuda.gibbs_sweeps_hbm_cuda.launches}


def _follower(rank: int, n: int, port: int, device: str, mesh_spec, kwargs: dict,
              timeout_s: float, conn) -> None:
    """A follower rank: joins the world on card ``rank`` (or the CPU), makes
    the mesh and a ``WarmGenerator`` as rank 0 made its own, then runs each
    operation rank 0 tells it until "stop", which it answers with its
    report (rank, operations run, kernel launches by mode, and the seconds
    from its start to its world, mesh and generator made).  Ends when rank
    0 is gone (its pipe closed) too."""
    import torch.distributed as dist

    from image_generation_tpu_torch.app.files import UnwrittenRunFiles
    from image_generation_tpu_torch.parallel.mesh import init_world

    t0 = time.perf_counter()
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # rank 0 stops it, also on Ctrl-C
    os.environ.update(_world_env(rank, n, port))
    dev = init_world(device, timeout_s)
    try:
        gen = WarmGenerator(device=dev, mesh=_world_mesh(mesh_spec), **kwargs)
        ops = {"load": 0, "serve": 0, "generate": 0}
        ready_s = time.perf_counter() - t0
        while True:
            try:
                conn.recv_bytes()  # the doorbell
            except (EOFError, OSError):
                return
            op, arg, path = _read_header(dev)
            if op == _STOP:
                conn.send(dict(rank=rank, ops=ops, launches=_launch_counts(), ready_s=ready_s))
                return
            try:
                if op == _LOAD:
                    gen._trainer = gen._load(path)
                    ops["load"] += 1
                elif op == _SERVE:
                    gen._serve_fn(gen._trainer, arg)
                    ops["serve"] += 1
                elif op == _GENERATE:
                    gen._generate_on(gen._trainer, bool(arg), UnwrittenRunFiles(gen.workdir))
                    ops["generate"] += 1
            except Exception:
                # rank 0 runs the same calls on the same inputs and raised at
                # the same point; anything else times out there
                traceback.print_exc()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class WarmWorld:
    """Rank 0's side of a warm server on n ranks: starts the n − 1
    followers (``torch.multiprocessing``, spawn; follower r on card r),
    joins the world with them (``parallel.mesh.init_world`` on a free
    localhost port, the launcher's variables set for the call), makes the
    mesh (``mesh``) and tells the followers each device operation
    (``tell``).  ``close`` (also at interpreter exit) sends "stop", joins
    the followers and ends the world."""

    def __init__(self, n: int, device, mesh_spec, kwargs: dict,
                 timeout_s: float = WORLD_TIMEOUT_S):
        import torch.multiprocessing as mp

        from image_generation_tpu_torch.parallel.mesh import init_world

        self.n, self.error, self.reports = n, None, None
        t0 = time.perf_counter()
        port = _free_port()
        ctx = mp.get_context("spawn")
        self.procs, self.conns = [], []
        for r in range(1, n):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_follower, name=f"warm-follower-{r}", daemon=True,
                            args=(r, n, port, str(device), mesh_spec, kwargs, timeout_s,
                                  theirs))
            p.start()
            theirs.close()
            self.procs.append(p)
            self.conns.append(ours)
        t1 = time.perf_counter()
        saved = {k: os.environ.get(k) for k in _WORLD_VARS}
        os.environ.update(_world_env(0, n, port))
        try:
            self.device = init_world(device, timeout_s)
        finally:  # the server's jobs must not see a launcher
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        t2 = time.perf_counter()
        self.mesh = _world_mesh(mesh_spec)
        # seconds spent starting the followers, joining the world (rank 0
        # waits there for every follower to start) and making the mesh
        self.start_s = dict(spawn=t1 - t0, world=t2 - t1, mesh=time.perf_counter() - t2)
        atexit.register(self.close)

    @property
    def pids(self) -> list:
        return [p.pid for p in self.procs]

    def check(self) -> None:
        """Raise if the world is stopped or out of step, or a follower is
        gone."""
        if self.error is None:
            gone = [(r, p.exitcode) for r, p in enumerate(self.procs, 1) if not p.is_alive()]
            if gone:
                self.error = (f"rank(s) {', '.join(str(r) for r, _ in gone)} gone (exit "
                              f"code(s) {', '.join(str(c) for _, c in gone)})")
        if self.error is not None:
            raise RuntimeError(f"warm serving on {self.n} ranks: {self.error}; the server "
                               "does not serve on fewer cards")

    def failed(self, e: BaseException) -> None:
        """After a dispatch raised: a follower gone or a collective's error
        leaves the world out of step for good."""
        import torch.distributed as dist

        if self.error is None and isinstance(e, dist.DistError):
            self.error = f"a collective failed ({type(e).__name__}: {e})"
        try:
            self.check()
        except RuntimeError:
            pass

    def tell(self, op: int, arg: int = 0, path: Optional[str] = None) -> None:
        """Ring every follower's doorbell and broadcast the header (and a
        model path); every rank then runs the operation."""
        import torch.distributed as dist

        self.check()
        try:
            for c in self.conns:
                c.send_bytes(b"\0")
            # held until the next header: the broadcast may still read it
            self._header = torch.tensor([op, arg], dtype=torch.int64, device=self.device)
            dist.broadcast(self._header, src=0)
            if path is not None:
                dist.broadcast_object_list([path], src=0)
        except Exception as e:
            self.error = self.error or f"telling the followers failed ({type(e).__name__}: {e})"
            raise

    def close(self, timeout_s: float = 60.0) -> list:
        """Send "stop", collect each follower's report (``reports``), end
        this rank's world while the followers end theirs, and join them;
        idempotent.  A follower that has not ended within ``timeout_s`` is
        killed."""
        import torch.distributed as dist

        if self.reports is not None:
            return self.reports
        self.reports = []
        if self.error is None:
            try:
                self.tell(_STOP)
                for c in self.conns:
                    if c.poll(timeout_s):
                        self.reports.append(c.recv())
            except Exception:
                traceback.print_exc()
        for c in self.conns:  # a follower still at its doorbell ends
            c.close()
        # under NCCL a rank's destroy_process_group waits for the other
        # ranks' (each follower's ends it after "stop"): end this rank's
        # world beside them, not after joining them
        ender = threading.Thread(target=dist.destroy_process_group, daemon=True)
        if dist.is_initialized():
            ender.start()
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        if ender.is_alive():
            ender.join(timeout_s)
        self.error = self.error or "stopped"
        atexit.unregister(self.close)
        return self.reports


def make_warm_generator(workdir, device="cuda", mesh="auto", **kwargs) -> WarmGenerator:
    """The server's ``WarmGenerator`` for a ``--mesh`` value: on one rank
    (``parallel.mesh.local_world_size`` 1, or inside a launched world) the
    generator as it always was; on n > 1 this process becomes rank 0 of a
    world of n (``WarmWorld``) and the generator serves on every rank."""
    from image_generation_tpu_torch.app.cli import parse_mesh
    from image_generation_tpu_torch.parallel.mesh import launched, local_world_size

    n = 1 if launched() else local_world_size(mesh, device)
    if n == 1:
        return WarmGenerator(workdir, device=device, mesh=parse_mesh(mesh), **kwargs)
    world = WarmWorld(n, device, mesh, dict(kwargs, workdir=workdir))
    return WarmGenerator(workdir, device=world.device, mesh=world.mesh, world=world, **kwargs)
