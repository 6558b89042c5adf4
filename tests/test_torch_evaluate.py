"""Port parity: checkpoint evaluation (``app/evaluate.py``) and
``mnist_pool_size``, on the CPU.

``evaluate_checkpoint(runs/models/tpu_digits_40_epochs, dataset_size=512,
num_reads=128, image_rounds=2)`` runs in both packages:

  * the same keys; ``n_latents``, ``n_edges``, ``data_source`` and
    ``sampler_matmul_dtype`` equal;
  * ``image_mmd_noise`` within 1e-4 relative and ``image_mmd_floor`` within
    1e-3 relative: the same numpy draws on pools that differ in 9 of
    524,288 binarised pixels (the two packages' bilinear upsampling of the
    digits differs by ≤ 3e-7 before rounding); measured 2.8e-5 and 2.9e-4;
  * ``recon_mse`` within 2 % (the spins are stochastic in both; measured
    0.3 %);
  * ``image_mmd`` and ``latent_mmd`` within three times the spread (max −
    min) of the JAX run over seeds 0, 1 and 2: image_mmd 1.12948 / 1.12542
    / 1.1221, latent_mmd 0.04539 / 0.04504 / 0.04363 (the JAX package on the
    CPU), so bands of 0.0221 and 0.0053;
  * the DVAE's ``state_dict`` bit-identical before and after evaluation,
    the module back in eval mode, and the global torch RNG not drawn from
    after the load (the training-mode pass draws from the evaluation's
    generator).

The JAX run's ``init`` (whose state ``load`` overwrites) is jitted inside
this test only: eager, it compiles op by op for ~15 s.
"""

import json
import struct

import jax
import numpy as np
import pytest
import torch

from image_generation_tpu.app import evaluate as jeval
from image_generation_tpu.training import trainer as jtrainer
from image_generation_tpu.utils import data as jdata
from image_generation_tpu_torch.app import evaluate
from image_generation_tpu_torch.training.trainer import Trainer
from image_generation_tpu_torch.utils import data as tdata
from test_torch_topology_figure import MODELS

MODEL = MODELS / "tpu_digits_40_epochs"
KW = dict(dataset_size=512, num_reads=128, image_rounds=2)
JAX_SPREAD = {"image_mmd": (1.12948, 1.12542, 1.1221), "latent_mmd": (0.04539, 0.04504, 0.04363)}


@pytest.fixture(scope="module")
def evaluated():
    """Both packages' results, and the port's trainer with the DVAE's
    state dict as loaded."""
    seen = {}
    load = Trainer.load

    def recording_load(self, *a, **kw):
        load(self, *a, **kw)
        seen["trainer"] = self
        seen["state"] = {k: v.clone() for k, v in self.dvae.state_dict().items()}
        seen["rng"] = torch.get_rng_state()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    Trainer.load = recording_load
    try:
        port = evaluate.evaluate_checkpoint(MODEL, device="cpu", **KW)
        seen["global_rng_kept"] = torch.equal(seen["rng"], torch.get_rng_state())
    finally:
        Trainer.load = load
        torch.set_num_threads(n)

    make = jtrainer.make_train_fns

    def jitted_init(*a, **kw):
        fns = make(*a, **kw)
        fns.init = jax.jit(fns.init)
        return fns

    jtrainer.make_train_fns = jitted_init
    try:
        want = jeval.evaluate_checkpoint(MODEL, **KW)
    finally:
        jtrainer.make_train_fns = make
    return want, port, seen


def test_same_keys_and_exact_fields(evaluated):
    want, got, _ = evaluated
    assert set(got) == set(want)
    for k in ("model", "n_latents", "n_edges", "data_source", "sampler_matmul_dtype",
              "image_rounds"):
        assert got[k] == want[k], k
    assert all(np.isfinite(v) for v in got.values() if isinstance(v, float))


def test_floor_and_noise_from_the_same_draws(evaluated):
    want, got, _ = evaluated
    assert got["image_mmd_noise"] == pytest.approx(want["image_mmd_noise"], rel=1e-4)
    assert got["image_mmd_floor"] == pytest.approx(want["image_mmd_floor"], rel=1e-3)
    assert got["image_mmd_floor"] < got["image_mmd_noise"]


def test_stochastic_metrics_within_their_bands(evaluated):
    want, got, _ = evaluated
    assert got["recon_mse"] == pytest.approx(want["recon_mse"], rel=0.02)
    for key, seeds in JAX_SPREAD.items():
        band = 3 * (max(seeds) - min(seeds))
        assert abs(got[key] - want[key]) <= band, (key, got[key], want[key], band)


def test_evaluation_leaves_the_model_unchanged(evaluated):
    _, _, seen = evaluated
    dvae = seen["trainer"].dvae
    assert not dvae.training
    after = dvae.state_dict()
    assert set(after) == set(seen["state"])
    for k, v in seen["state"].items():
        assert torch.equal(v, after[k]), k
    assert seen["global_rng_kept"]


def test_image_space_metrics_needs_distinct_images(evaluated):
    _, _, seen = evaluated
    t = seen["trainer"]
    with pytest.raises(ValueError, match="distinct data"):
        evaluate.image_space_metrics(t, num_reads=300, n_rounds=1)

    class Tiled:  # the pool presented twice, as load_mnist's tile-up does
        fns, dvae, device = t.fns, t.dvae, t.device
        images = torch.cat([t.images, t.images])
        data_source = tdata.DataSource(t.data_source.images, t.data_source.labels,
                                       t.data_source.origin + "-tiled2")

        @staticmethod
        def sample_spins(n):
            return t.sample_spins(n)

    with pytest.raises(ValueError, match="distinct data"):
        evaluate.image_space_metrics(Tiled(), num_reads=300, n_rounds=1)  # 1,024 rows, 512 unique
    m = evaluate.image_space_metrics(Tiled(), num_reads=16, n_rounds=1, seed=5)
    assert np.isfinite(m["image_mmd_floor"]) and m["image_rounds"] == 1


def test_mnist_pool_size_equals_jax(tmp_path, monkeypatch):
    assert tdata.mnist_pool_size() == jdata.mnist_pool_size() == len(tdata.load_mnist(None).images)
    n = 60000
    (tmp_path / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 0x00000803, n, 28, 28))  # the header alone
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path))
    assert tdata.mnist_pool_size() == jdata.mnist_pool_size() == n


def test_main_writes_out(tmp_path):
    root = tmp_path / "models"
    root.mkdir()
    (root / "m").symlink_to(MODEL)
    (root / "not_a_model").mkdir()
    out = tmp_path / "eval.json"
    results = evaluate.main(["--models", str(root), "--platform", "cpu", "--dataset-size", "64",
                             "--num-reads", "16", "--image-rounds", "1", "--out", str(out),
                             "--sampler-matmul-dtype", "float32"])
    assert json.loads(out.read_text()) == results
    assert [r["model"] for r in results] == ["m"]
    assert results[0]["sampler_matmul_dtype"] == "float32" and results[0]["image_rounds"] == 1
