"""Port parity: ``generate``, ``refresh``, ``tune-pt`` and ``models``
through both packages' CLIs, on a model the port's CLI trained.

The port's CLI trains a tiny model (32 latents on Advantage2_prototype,
dataset 64, batch 16, 2 sweeps); then each package's ``cli.main`` runs
``generate --sharpen`` → ``refresh`` → ``tune-pt`` → ``models`` on it,
each in a workdir of its own holding a copy of the model.  After every
command the two workdirs hold the same files, ``problem_details.json``
the same keys and the same values where no draw decides them;
``refresh`` and ``models`` print the same lines; the tuned ladder has
the same fields, rung count and ends (its inner rungs come from draws).
So a model trained by the port's CLI is generated from by the JAX CLI.
(The JAX CLI's first command on a loaded model compiles op by op for
~35 s on the CPU: tests/test_torch_cli_jax_tune.py holds ``tune``.)
"""

import json
import shutil

import jax  # noqa: F401  (tests/conftest.py has set the CPU platform)
import numpy as np
import pytest
import torch

from image_generation_tpu.app import cli as jcli
from image_generation_tpu_torch.app import cli

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
    cli.main(["--workdir", str(base), "train", "--name", "m", "--epochs", "1"] + FLAGS
             + ["--platform", "cpu"])
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


def test_generate_refresh_tune_pt_and_models_write_what_jax_writes(workdirs, capsys):
    jw, tw = workdirs
    jout, tout = _both(workdirs, capsys, "generate", "--model", "m", "--sharpen",
                       "--num-reads", "64")
    assert tout.split("→")[0] == jout.split("→")[0] == "generated 64 images "
    _details_agree(workdirs)
    for name in ("generated_epoch_0.json", "reconstructed_epoch_0.json",
                 "loss_mse_epoch_0.json"):
        j, t = (_json(w / "generated_json" / name) for w in workdirs)
        assert np.shape(t["data"][0].get("z", [])) == np.shape(j["data"][0].get("z", []))
        assert t["layout"] == j["layout"]
    j, t = (_json(w / "generated_json" / "loss_mse_epoch_0.json") for w in workdirs)
    assert t["data"][0]["y"] == j["data"][0]["y"]  # the loaded history, no draw
    jz, tz = (np.asarray(_json(w / "generated_json" / "generated_epoch_0.json")["data"][0]["z"])
              for w in workdirs)
    for z in (tz, jz):  # sharpened: dark → 0, bright → 255, the mid-range [0.4, 0.6] kept
        assert ((z == 0) | (z == 255) | ((z >= 102) & (z <= 153))).all()

    for w in workdirs:
        shutil.rmtree(w / "assets")
    jout, tout = _both(workdirs, capsys, "refresh", "--model", "m")
    assert tout == jout
    _details_agree(workdirs)

    _both(workdirs, capsys, "tune-pt", "--model", "m", "--iters", "1", "--chains", "8")
    jp, tp = (_json(w / "models" / "m" / "pt_betas.json") for w in workdirs)
    assert list(tp) == list(jp)
    assert len(tp["betas"]) == len(jp["betas"]) and tp["betas"][-1] == jp["betas"][-1] == 1.0
    assert tp["betas"][0] == pytest.approx(jp["betas"][0])
    assert {k: len(v) for k, v in tp.items() if isinstance(v, list)} == {
        k: len(v) for k, v in jp.items() if isinstance(v, list)}

    jout, tout = _both(workdirs, capsys, "models", flags=False)
    assert tout == jout == "m: qpu=Advantage2_prototype latents=32 epochs=1\n"
