"""One command on every local device, on the CPU: the port's rank count for
a ``--mesh`` value against the JAX package's mesh, the CLI starting its own
ranks, a web-app job's cancel stopping every rank, and the warm server as
rank 0 with a follower.

The JAX package is single-controller: ``--mesh auto`` shards over every
local device from one process.  The port runs one process a rank, so its
entry points start the ranks themselves (``parallel.mesh.local_world_size``
ranks; ``cli.main`` through ``torch.distributed.run``'s API, the warm
server through ``app.warm.WarmWorld``).  Here the ranks are gloo processes
at ``tests/test_torch_launch.py``'s tiny size, with the images from a
small MNIST file made from a seed (``MNIST_DATA_DIR``) so that no process
pays for a larger data source.  The self-launched CLI is held bit for bit
against the same training by ``Trainer(mesh=...)`` on threaded ranks
(``torch_launch_rank.threaded_reference``, the reference the launched run
of ``tests/test_torch_launch.py`` is held against), and the warm server's
dispatch against ``WarmGenerator._serve_fn`` on threaded ranks.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from image_generation_tpu.app import cli as jcli
from image_generation_tpu.parallel import mesh as jmesh
from image_generation_tpu_torch.app import cli, server
from image_generation_tpu_torch.app.warm import WarmGenerator
from image_generation_tpu_torch.parallel import mesh as tmesh
from torch_launch_rank import threaded_reference
from torch_ranks import run_ranks

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--dataset-size", "64", "--batch-size", "16", "--latents", "32", "--sweeps", "2",
        "--qpu", "Advantage2_prototype", "--platform", "cpu"]
TINY_CONFIG = dict(DATASET_SIZE=64, BATCH_SIZE=16, N_LATENTS=32, GIBBS_SWEEPS=2,
                   QPU="Advantage2_prototype")
SERVE = dict(NUM_READS=16, GIBBS_SWEEPS=2, GIBBS_BURN_IN=2)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_env(tmp_path_factory):
    """A 64-image MNIST file from a seed for every process of the module
    (the ranks inherit the environment), one intra-op thread a process and
    no launcher's variables."""
    d = tmp_path_factory.mktemp("mnist")
    rng = np.random.default_rng(0)
    np.savez(d / "mnist.npz", x_train=rng.integers(0, 256, (64, 28, 28), dtype=np.uint8),
             y_train=np.zeros(64, np.int64))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MNIST_DATA_DIR", str(d))
        for k, v in ONE_THREAD.items():
            mp.setenv(k, v)
        for k in tmesh.LAUNCHER_VARS:
            mp.delenv(k, raising=False)
        yield


@pytest.fixture(scope="module")
def reference(data_env, tmp_path_factory):
    """The tiny one-epoch run on (2, 1) threaded ranks, and its saved model."""
    model = tmp_path_factory.mktemp("ref") / "models" / "m"
    return threaded_reference(TINY_CONFIG, (2, 1), save_to=model), model


# ------------------------------------------------- (i) the rank count, no processes

@pytest.mark.parametrize("spec", ["off", "auto", "4", "2x2", "1x4", "8"])
def test_rank_count_and_shape_equal_jax_on_8_devices(monkeypatch, spec):
    """On 8 cards the port starts as many ranks, in the same (data, chain)
    shape, as the JAX ``parse_mesh`` mesh has on the 8 host devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    jm = jcli.parse_mesh(spec)
    jm = jmesh.auto_mesh() if jm == "auto" else jm
    j_ranks, j_shape = (1, None) if jm is None else (jm.size, tuple(jm.devices.shape))
    n = tmesh.local_world_size(spec, "cuda")
    shape = tmesh.spec_shape(spec) or (tmesh.default_shape(n) if n > 1 else None)
    assert (n, shape) == (j_ranks, j_shape)


def test_rank_count_refusals_and_the_cpu(monkeypatch):
    """Above the cards the port raises with both counts (JAX cannot build
    the mesh either); 'auto' on the CPU is one rank, a count is that many;
    a bad value raises as ``parse_mesh`` does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for spec in ("16", "4x4"):
        with pytest.raises(RuntimeError, match="asks for 16 ranks.* 8 card"):
            tmesh.local_world_size(spec, "cuda")
        with pytest.raises(SystemExit):
            jcli.parse_mesh(spec)
    assert tmesh.local_world_size("auto", "cpu") == 1
    assert tmesh.local_world_size("2x1", "cpu") == 2 and tmesh.local_world_size("3", "cpu") == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tmesh.local_world_size("auto", "cuda") == 1  # the card path then says no card
    for bad in ("0", "2x0", "two"):
        with pytest.raises(ValueError):
            tmesh.spec_shape(bad)


def test_main_starts_ranks_only_outside_a_launcher(monkeypatch):
    """``cli.main`` starts ``local_world_size`` ranks with the same argv
    (none for one rank) and returns their code; a launched rank never
    starts ranks; more ranks than cards exits with both counts."""
    calls = []
    monkeypatch.setattr(cli, "launch_ranks", lambda argv, n: calls.append((argv, n)) or 0)
    for k in tmesh.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    argv = ["train", "--name", "m", "--epochs", "1", "--mesh", "2x1", *TINY]
    assert cli.main(argv) == 0 and calls == [(argv, 2)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    card = ["generate", "--model", "m"]
    assert cli.main(card) == 0 and calls[-1] == (card, 4)  # auto: every card
    with pytest.raises(SystemExit, match="asks for 8 ranks.* 4 card"):
        cli.main(card + ["--mesh", "8"])
    calls.clear()
    monkeypatch.setattr(cli, "launch_ranks", lambda argv, n: 3)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 3
    # a launched rank: its world of one cannot hold (2, 1), and nothing relaunches
    monkeypatch.setattr(cli, "launch_ranks", lambda argv, n: calls.append((argv, n)) or 0)
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    assert tmesh.launched()
    try:
        with pytest.raises(SystemExit, match=r"\(2, 1\) != 1 ranks"):
            cli.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert calls == []


# ------------------------------------------------- (ii) the repair: --mesh 2x1, no launcher

def test_cli_mesh_2x1_without_a_launcher_starts_two_ranks(reference, tmp_path, monkeypatch,
                                                          capfd):
    """``main(["train", "--mesh", "2x1", ...])`` with no launcher (before:
    "torch.distributed is not initialised"): two gloo ranks, the files once,
    each rank's per-step losses and parameters bit-equal to the threaded
    ranks'."""
    work, out = tmp_path / "w", tmp_path / "ranks"
    out.mkdir()
    monkeypatch.setattr(cli, "RANK_ENTRY", (str(ROOT / "tests" / "torch_launch_rank.py"),
                                            str(out)))
    assert cli.main(["--workdir", str(work), "train", "--name", "m", "--epochs", "1",
                     "--mesh", "2x1", *TINY]) == 0
    said = capfd.readouterr().out
    assert not dist.is_initialized()  # this process joined no world
    ranks = [json.loads((out / f"rank_{r}.json").read_text()) for r in range(2)]
    ref, _ = reference
    for r, (losses, dig) in zip(ranks, ref):
        assert r["device"] == "cpu" and r["mesh"] == [2, 1] and r["backend"] == "gloo"
        assert len(r["losses"]["mse_losses"]) == 4
        assert r["losses"] == losses == ref[0][0] and r["digest"] == dig == ref[0][1]
    assert sorted(p.name for p in (work / "models").iterdir()) == ["m"]
    metrics = (work / "generated_json" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["event"] for x in metrics] == ["epoch"]
    assert said.count("training: ") == 1 and said.count("saved: ") == 1


# ------------------------------------------------- (iii) cancel stops every rank

def _ranks_of(pid: int) -> list:
    """The processes below ``pid`` that a launcher started as ranks."""
    out = []
    for p in server._descendants(pid):
        try:
            env = Path(f"/proc/{p}/environ").read_bytes().split(b"\0")
        except OSError:
            continue
        if any(e.startswith(b"LOCAL_RANK=") for e in env) and server._alive(p):
            out.append(p)
    return out


def test_cancel_leaves_no_rank_process(data_env, tmp_path):
    """A web-app job ``train --mesh 2x1`` (its own ranks, each in a session
    of its own): once both ranks run, ``cancel`` leaves no process of the
    job within 10 s."""
    jobs = server.JobManager(tmp_path)
    assert jobs.start("train", ["train", "--name", "c", "--epochs", "1000", "--mesh", "2x1",
                                *TINY])
    deadline = time.monotonic() + 60
    while len(_ranks_of(jobs.proc.pid)) < 2:
        assert jobs.running() and time.monotonic() < deadline, "the ranks did not start"
        time.sleep(0.1)
    procs = [jobs.proc.pid] + server._descendants(jobs.proc.pid)
    assert jobs.cancel()
    deadline = time.monotonic() + 10
    while any(server._alive(p) for p in procs) and time.monotonic() < deadline:
        time.sleep(0.1)
    jobs.proc.poll()
    assert [p for p in procs if server._alive(p)] == []
    assert jobs.status()["state"] == "failed"


# ------------------------------------------------- (iv) the warm leader and a follower

def test_warm_leader_and_follower_equal_threaded_ranks(reference, tmp_path):
    """The warm server as rank 0 of 2 gloo ranks (in a subprocess, so this
    process starts no world): a dispatch of 2 requests equals
    ``_serve_fn`` on two threaded ranks bit for bit; "stop" ends the
    follower after one load and one dispatch; a server whose follower is
    gone fails that dispatch and the next."""
    _, model = reference
    work = model.parents[1]
    out = tmp_path / "leader"
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_warm_leader.py"), str(out), str(work),
         str(model), json.dumps(SERVE), "--mesh", "2x1", *TINY],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads((out / "leader.json").read_text())
    assert got["world"] == dict(backend="gloo", size=2, rank=0, mesh=[2, 1], device="cpu")
    ready = [r.pop("ready_s") for r in got["reports"]]
    assert got["reports"] == [dict(rank=1, ops=dict(load=1, serve=1, generate=0),
                                   launches={})]  # the CPU runs the plain sweeps
    assert all(s > 0 for s in ready)
    assert got["launches"] == {} and got["stop_s"] < 30.0
    assert not any(server._alive(p) for p in got["pids"] + got["killed"])
    assert all(e is not None and "rank(s) 1 gone" in e for e in got["errors"])
    assert not got["after"]
    images = np.load(out / "images.npy")

    overrides = dict(cli._config_overrides(cli.parse_serving_args(["--mesh", "2x1", *TINY])),
                     **SERVE)  # the server's own

    def rank(mesh):
        w = WarmGenerator(work, config_overrides=overrides, device="cpu", mesh=mesh)
        return w._serve_fn(w._trainer_for(model), 2)

    want = run_ranks(2, rank, (2, 1))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 32, 32, 1)
    for w in want:
        assert np.array_equal(images, w)
