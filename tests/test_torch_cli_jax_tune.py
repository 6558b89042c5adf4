"""Port parity: ``tune`` through both packages' CLIs, on a model the port
trained.

As tests/test_torch_cli_jax_chain.py: each package's ``cli.main`` runs
``tune`` on a copy of one tiny model (32 latents on
Advantage2_prototype, dataset 64, batch 16, 2 sweeps) trained and saved
by the port's Trainer as the port CLI's ``train`` saves it.  The two
workdirs then hold the same files, and the tuned models the same
parameters, the old loss history first and histories of the same length.
(The JAX CLI's ``tune`` compiles op by op for ~45 s on the CPU.)
"""

import json
import shutil

import jax  # noqa: F401  (tests/conftest.py has set the CPU platform)
import numpy as np
import pytest
import torch

from image_generation_tpu.app import cli as jcli
from image_generation_tpu_torch.app import cli
from image_generation_tpu_torch.config import TrainingConfig
from image_generation_tpu_torch.training.trainer import Trainer

FLAGS = ["--dataset-size", "64", "--batch-size", "16", "--latents", "32", "--sweeps", "2",
         "--qpu", "Advantage2_prototype", "--mesh", "off"]
DRAWN = {"Mean Squared Error Loss"}  # problem_details.json fields a draw decides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(w):
    return {str(p.relative_to(w)) for p in w.rglob("*") if p.is_file()}


def _json(path):
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory):
    """(JAX workdir, port workdir), each holding a copy of the port-trained
    model as models/m."""
    base = tmp_path_factory.mktemp("trained")
    # what the port CLI's train saves, without its figures (and on fewer chains)
    t = Trainer(TrainingConfig(QPU="Advantage2_prototype", N_LATENTS=32, DATASET_SIZE=64,
                               BATCH_SIZE=16, GIBBS_SWEEPS=2, NUM_READS=32, GIBBS_BURN_IN=2),
                device="cpu")
    t.train(1)
    t.save(base / "models" / "m", n_epochs=1)
    out = []
    for side in ("jax", "port"):
        w = tmp_path_factory.mktemp(side)
        shutil.copytree(base / "models" / "m", w / "models" / "m")
        out.append(w)
    return tuple(out)


def _both(workdirs, capsys, *argv, flags=True):
    """Run one command through each CLI; returns (JAX stdout, port stdout)."""
    jw, tw = workdirs
    jcli.main(["--workdir", str(jw), *argv] + (FLAGS if flags else []))
    jout = capsys.readouterr().out
    cli.main(["--workdir", str(tw), *argv] + (FLAGS + ["--platform", "cpu"] if flags else []))
    tout = capsys.readouterr().out
    assert _tree(tw) == _tree(jw), argv[0]
    return jout, tout


def _details_agree(workdirs):
    jd, td = (_json(w / "generated_json" / "problem_details.json") for w in workdirs)
    assert list(td) == list(jd)
    assert {k: v for k, v in td.items() if k not in DRAWN} == {
        k: v for k, v in jd.items() if k not in DRAWN}


def test_tune_writes_what_jax_writes(workdirs, capsys):
    jw, tw = workdirs
    _both(workdirs, capsys, "tune", "--model", "m", "--epochs", "1")
    _details_agree(workdirs)
    name = "models/m_tuned_1_epochs"
    assert _json(tw / name / "parameters.json") == _json(jw / name / "parameters.json")
    jl, tl = (_json(w / name / "losses.json") for w in workdirs)
    assert {k: len(v) for k, v in tl.items()} == {k: len(v) for k, v in jl.items()}
    m_losses = _json(tw / "models" / "m" / "losses.json")
    assert tl["mse_losses"][:4] == jl["mse_losses"][:4] == m_losses["mse_losses"]
