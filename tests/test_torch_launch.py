"""The port on a launched world, on the CPU: ``parallel.mesh.init_world``,
``Mesh.reduce_scatter``, the collectives' clock, and the CLI under
``python -m torch.distributed.run``.

``init_world`` reads the launcher's variables (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``): gloo on the CPU, a
refusal for a ``LOCAL_RANK`` beyond the visible cards (the card count
monkeypatched), nothing without the variables, and a world of one leaves
``auto_mesh`` None.  ``Mesh.reduce_scatter`` on threaded ranks
(``torch_ranks.run_ranks``) at (1, 2) and (1, 4), f32 and int32, equals the
all-reduce sliced to the rank's window bit for bit (integer-valued
inputs: every order of the sum is exact).

The CLI ``train`` at ``tests/test_torch_cli.py``'s tiny size runs in two
launched CPU processes over gloo (``--mesh 2x1``): the workdir's files are
written once (rank 0), both ranks' per-step losses and parameters are
equal bit for bit, and they equal the same training run by
``Trainer(mesh=...)`` on two threaded ranks, whose data-parallel steps
``tests/test_torch_data_axis.py`` holds against the one-process step and
JAX on the same draws.  An unfed mesh run is not the one-process run: its
chain-sharded sampler draws each rank's rows from its own stream (JAX's
``fold_in``), and every later draw follows.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.parallel import mesh as tmesh
from image_generation_tpu_torch.training.trainer import Trainer
from torch_launch_rank import threaded_reference
from torch_ranks import run_ranks

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--dataset-size", "64", "--batch-size", "16", "--latents", "32", "--sweeps", "2",
        "--qpu", "Advantage2_prototype", "--platform", "cpu"]
TINY_CONFIG = dict(DATASET_SIZE=64, BATCH_SIZE=16, N_LATENTS=32, GIBBS_SWEEPS=2,
                   QPU="Advantage2_prototype")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def launcher_env(monkeypatch):
    """A launcher's variables for rank 0 of a world of one."""
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_init_world_starts_gloo_on_the_cpu(launcher_env):
    """The launcher's world of one on the CPU: gloo, rank 0, no mesh from
    ``auto_mesh`` (JAX on one device), and a Trainer's "auto" mesh None; a
    second call leaves the world as it is."""
    assert not dist.is_initialized()
    assert tmesh.init_world("cpu") == torch.device("cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
    assert tmesh.auto_mesh() is None
    assert Trainer(TrainingConfig(), device="cpu", mesh="auto").mesh is None
    assert tmesh.init_world("cpu") is None


def test_init_world_without_a_launcher_does_nothing(monkeypatch):
    for k in tmesh.LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_world("cpu") is None and not dist.is_initialized()


@pytest.mark.parametrize("cards", [0, 2])
def test_init_world_refuses_a_rank_beyond_the_cards(monkeypatch, launcher_env, cards):
    """LOCAL_RANK 2 with 0 or 2 cards visible raises, naming both counts,
    before any world starts: ranks never share a card or fall back to
    gloo."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK 2 .* {cards} card"):
        tmesh.init_world("cuda")
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("ranks", [2, 4])
def test_reduce_scatter_equals_the_sliced_all_reduce(ranks, dtype):
    """Each rank's window of the sum, along the last dim of a (3, 5, 8·P)
    tensor and the first of a (4·P, 6) one, equals the all-reduce's slice;
    the collectives are counted and timed on the host clock (gloo)."""
    def rank(mesh):
        g = torch.Generator().manual_seed(mesh.graph_index)
        out = []
        for shape, dim in (((3, 5, 8 * ranks), -1), ((4 * ranks, 6), 0)):
            t = torch.randint(-50, 50, shape, generator=g).to(dtype)
            whole = mesh.all_reduce(t.clone())
            lo, hi = (mesh.graph_index * shape[dim] // ranks,
                      (mesh.graph_index + 1) * shape[dim] // ranks)
            mesh.comm_seconds, calls = 0.0, mesh.comm_calls
            got = mesh.reduce_scatter(t, dim=dim)
            out.append((got, whole.narrow(dim, lo, hi - lo), mesh.comm_calls - calls,
                        mesh.comm_seconds))
        return out

    for res in run_ranks(ranks, rank):
        for got, ref, calls, seconds in res:
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.equal(got, ref)
            assert calls == 1 and seconds > 0.0


def test_reduce_scatter_refuses_an_untiled_dim():
    def rank(mesh):
        with pytest.raises(ValueError, match="does not split"):
            mesh.reduce_scatter(torch.zeros(2, 5), dim=-1)
        return mesh.reduce_scatter(torch.ones(2, 6), dim=-1)

    for out in run_ranks(2, rank):
        assert torch.equal(out, torch.full((2, 3), 2.0))


def test_cli_train_under_the_launcher(tmp_path):
    """``train --mesh 2x1`` in two launched processes: the files once, the
    ranks equal, and equal to the Trainer on two threaded ranks."""
    work, out = tmp_path / "w", tmp_path / "ranks"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k not in tmesh.LAUNCHER_VARS}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
         str(ROOT / "tests" / "torch_launch_rank.py"), str(out),
         "--workdir", str(work), "train", "--name", "m", "--epochs", "1", "--mesh", "2x1",
         *TINY],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ranks = [json.loads((out / f"rank_{r}.json").read_text()) for r in range(2)]
    for r in ranks:
        assert r["device"] == "cpu" and r["mesh"] == [2, 1] and r["backend"] == "gloo"
        assert len(r["losses"]["mse_losses"]) == 4  # 64 images, batch 16
        assert r["losses"] == ranks[0]["losses"] and r["digest"] == ranks[0]["digest"]
    # rank 0 alone wrote and printed: one model, one metrics record, one banner
    assert sorted(p.name for p in (work / "models").iterdir()) == ["m"]
    assert json.loads((work / "models" / "m" / "losses.json").read_text()) == ranks[0]["losses"]
    metrics = (work / "generated_json" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["event"] for x in metrics] == ["epoch"]
    assert (work / "generated_json" / "generated_epoch_0.json").exists()
    assert proc.stdout.count("training: ") == 1 and proc.stdout.count("saved: ") == 1
    assert proc.stdout.count("epoch 1/1:") == 1

    for losses, dig in threaded_reference(TINY_CONFIG, (2, 1)):
        assert losses == ranks[0]["losses"] and dig == ranks[0]["digest"]


def test_model_diagram_on_a_mesh_with_a_sharded_layer(tmp_path, monkeypatch):
    """The diagram pass on a (2, 1) mesh whose decoder layer is
    column-sharded (the sharding size lowered to 4,096): every rank runs it
    (its draw and the layer's gather), rank 0 writes the assets, the other
    writes nothing."""
    from image_generation_tpu_torch.app.diagram import generate_model_diagram
    from image_generation_tpu_torch.parallel.dense import ColumnShardedLinear
    from image_generation_tpu_torch.training import step as tstep

    monkeypatch.setattr(tstep, "DENSE_MIN_ELEMS", 4096)

    def rank(mesh):
        t = Trainer(TrainingConfig(**TINY_CONFIG), device="cpu", mesh=mesh)
        t.train_init(1)
        assert isinstance(t.dvae._decoder.increase_latent_dim, ColumnShardedLinear)
        out = tmp_path / "assets" if mesh.rank == 0 else None
        return generate_model_diagram(t, t.images[0], out)

    written, other = run_ranks(2, rank, (2, 1))
    assert other == {} and sorted(p.name for p in (tmp_path / "assets").iterdir()) == [
        "latent_encoded.json", "step_1_input.png", "step_2_encode.png", "step_4_decode.png",
        "step_5_output.png"]
    assert sorted(written) == ["latent_encoded", "step_1", "step_2", "step_4", "step_5"]
