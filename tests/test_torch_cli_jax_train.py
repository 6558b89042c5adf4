"""Port parity: ``train`` through both packages' CLIs, and each package's
``generate`` on the model the other trained.

The port's ``cli.main(... --platform cpu)`` and the JAX package's
``cli.main`` train the same tiny model (32 latents on
Advantage2_prototype, dataset 64, batch 16, 2 sweeps, one device).  The
random streams differ (torch generators against JAX keys), so the two
agree on every file and on every field no draw decides, never on sampled
pixels or losses.  (The JAX CLI's first ``train`` compiles op by op for
~45 s on the CPU: this file holds it alone; tests/test_torch_cli_jax_chain.py
holds the rest of the chain.)
"""

import json

import jax  # noqa: F401  (tests/conftest.py has set the CPU platform)
import numpy as np
import pytest
import torch

from image_generation_tpu.app import cli as jcli
from image_generation_tpu_torch.app import cli

FLAGS = ["--dataset-size", "64", "--batch-size", "16", "--latents", "32", "--sweeps", "2",
         "--qpu", "Advantage2_prototype", "--mesh", "off"]
# problem_details.json fields a draw decides
DRAWN = {"Mean Squared Error Loss"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(w):
    """{relative path: None} of every file under a workdir."""
    return {str(p.relative_to(w)) for p in w.rglob("*") if p.is_file()}


def _json(path):
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jw, tw = tmp_path_factory.mktemp("jax_cli"), tmp_path_factory.mktemp("port_cli")
    jcli.main(["--workdir", str(jw), "train", "--name", "m", "--epochs", "1"] + FLAGS)
    cli.main(["--workdir", str(tw), "train", "--name", "m", "--epochs", "1"] + FLAGS
             + ["--platform", "cpu"])
    return jw, tw


def test_train_writes_the_same_files(trained):
    jw, tw = trained
    assert _tree(tw) == _tree(jw)
    jd, td = (_json(w / "generated_json" / "problem_details.json") for w in trained)
    assert list(td) == list(jd)
    assert {k: v for k, v in td.items() if k not in DRAWN} == {
        k: v for k, v in jd.items() if k not in DRAWN}
    # the model directory: the same parameters, the same loss-history shape
    assert _json(tw / "models" / "m" / "parameters.json") == _json(
        jw / "models" / "m" / "parameters.json")
    jl, tl = (_json(w / "models" / "m" / "losses.json") for w in trained)
    assert {k: len(v) for k, v in tl.items()} == {k: len(v) for k, v in jl.items()}
    jm, tm = ([json.loads(x) for x in (w / "generated_json" / "metrics.jsonl").read_text()
               .splitlines()] for w in trained)
    assert [set(r) for r in tm] == [set(r) for r in jm]
    for name in ("generated_epoch_0.json", "reconstructed_epoch_0.json"):
        j, t = (_json(w / "generated_json" / name) for w in trained)
        assert np.shape(t["data"][0]["z"]) == np.shape(j["data"][0]["z"])
        assert t["layout"] == j["layout"]


def test_port_generates_from_the_jax_model(trained, tmp_path):
    """The port's ``generate`` on the JAX CLI's model writes what ``train``
    wrote for the JAX package's last epoch, less the training-only files
    (tests/test_torch_cli_jax_chain.py runs the JAX ``generate`` on a model
    the port trained)."""
    jw, _ = trained
    cli.main(["--workdir", str(tmp_path), "generate", "--model", str(jw / "models" / "m"),
              "--num-reads", "32"] + FLAGS + ["--platform", "cpu"])
    training_only = {"generated_json/metrics.jsonl", "generated_json/progress.json"}
    assert _tree(tmp_path) == {f for f in _tree(jw) if not f.startswith("models/")} - training_only
    z = np.asarray(_json(tmp_path / "generated_json" / "generated_epoch_0.json")["data"][0]["z"])
    assert z.shape == (2 * 34 + 2, 16 * 34 + 2) and 0 <= z.min() and z.max() <= 255
    details = _json(tmp_path / "generated_json" / "problem_details.json")
    assert (details["QPU"], details["Latents"], details["Sampler"]) == (
        "Advantage2_prototype", 32, "gibbs")
