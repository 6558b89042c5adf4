"""Checkpoint evaluation: recon-MSE, latent-MMD and image-space MMD.

Port of ``image_generation_tpu/app/evaluate.py``.  For each saved model
directory: reconstruct the eval set through the DVAE, sample the GRBM
(through the sampler backends, and on the card through the K1 gather
kernel) and report

  * ``recon_mse``            — mean squared reconstruction error in eval
                               mode (BatchNorm running statistics, no
                               dropout);
  * ``recon_mse_train_mode`` — the same in training mode (batch statistics,
                               Dropout2d, ``N_REPLICAS`` replicas), as the
                               loss history records it.  The pass leaves
                               the model as it found it: BatchNorm's running
                               statistics are restored, dropout draws from
                               the evaluation's own generator, and the
                               module goes back to eval mode;
  * ``latent_mmd``           — the training MMD between encoded data spins
                               and sampler spins;
  * ``sample_energy_mean``   — the mean scaled-model energy of the samples;
  * ``image_mmd``            — MMD² between decoded generated images and
                               held-out data images, beside its
                               same-distribution floor (two disjoint data
                               batches) and a uniform-noise reference point.

Cross-model comparisons hold on the same data pool only: the card's
machine has no scikit-learn and evaluates against synthetic digits.

Usage:
  python -m image_generation_tpu_torch.app.evaluate --models runs/models [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["image_space_metrics", "evaluate_checkpoint", "main"]


def image_space_metrics(trainer, num_reads: int = 256, n_rounds: int = 4, seed: int = 1) -> dict:
    """Image-space generation quality of a loaded ``Trainer``.

    ``n_rounds`` rounds of: sample ``num_reads`` fresh GRBM chains
    (``trainer.sample_spins``, the serving math), decode them in eval mode
    and take the biased MMD² (``ops/mmd.py``) against a held-out data batch
    of the same size; each round also measures the floor, MMD² of two
    disjoint data batches, and MMD² of uniform noise against the data.
    Returns means and standard deviations over the rounds.  Needs
    ≥ 2·num_reads distinct data images (a tiled offline pool counts its
    distinct rows only)."""
    from image_generation_tpu_torch.ops.mmd import GaussianKernel, mmd_loss

    kern = GaussianKernel(7)
    dvae = trainer.dvae
    dev = trainer.device
    data = np.asarray(torch.as_tensor(trainer.images).cpu(), dtype=np.float32)
    flat = data.reshape(data.shape[0], -1)
    if "-tiled" in trainer.data_source.origin:
        # a tiled pool repeats every image: copies of one image in both
        # "disjoint" floor halves would bias the floor low
        flat = np.unique(flat, axis=0)
    if flat.shape[0] < 2 * num_reads:
        raise ValueError(
            f"image_space_metrics needs >= {2 * num_reads} distinct data "
            f"images for disjoint floor batches, have {flat.shape[0]}"
        )
    rng = np.random.default_rng(seed)
    gen_v, floor_v, noise_v = [], [], []
    for _ in range(n_rounds):
        idx = rng.permutation(flat.shape[0])
        a = torch.from_numpy(flat[idx[:num_reads]]).to(dev)
        b = torch.from_numpy(flat[idx[num_reads: 2 * num_reads]]).to(dev)
        spins = trainer.sample_spins(num_reads)
        with torch.inference_mode():
            imgs = dvae.eval().decode(spins[:, None, :].float())[:, 0]
            g = torch.clamp(imgs, 0.0, 1.0).reshape(num_reads, -1)
            gen_v.append(float(mmd_loss(g, a, kern)))
            floor_v.append(float(mmd_loss(b, a, kern)))
            noise = torch.from_numpy(rng.random((num_reads, flat.shape[1]), dtype=np.float32))
            noise_v.append(float(mmd_loss(noise.to(dev), a, kern)))
    return {
        "image_mmd": round(float(np.mean(gen_v)), 5),
        "image_mmd_std": round(float(np.std(gen_v)), 5),
        "image_mmd_floor": round(float(np.mean(floor_v)), 5),
        "image_mmd_floor_std": round(float(np.std(floor_v)), 5),
        "image_mmd_noise": round(float(np.mean(noise_v)), 5),
        "image_rounds": n_rounds,
    }


def _train_mode_recon(dvae, batch: torch.Tensor, n_replicas: int,
                      generator: torch.Generator) -> torch.Tensor:
    """The DVAE's training-mode reconstruction of ``batch`` (batch
    statistics, dropout drawn from ``generator``), leaving the module as
    it was: its buffers (BatchNorm's running statistics) restored and eval
    mode back on."""
    saved = [b.detach().clone() for b in dvae.buffers()]
    try:
        with torch.no_grad():
            _, _, recon = dvae.train()(batch, n_replicas, generator)
    finally:
        with torch.no_grad():
            for buf, old in zip(dvae.buffers(), saved):
                buf.copy_(old)
        dvae.eval()
    return recon


def evaluate_checkpoint(
    model_dir,
    dataset_size: int = 2048,
    num_reads: int = 256,
    batch_size: int = 256,
    seed: int = 0,
    image_rounds: int = 4,
    config_overrides: Optional[dict] = None,
    device="cuda",
) -> dict:
    """The metrics of one model directory (module docstring), evaluated on
    ``device`` (the card unless ``"cpu"``)."""
    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.ops.mmd import GaussianKernel, mmd_loss
    from image_generation_tpu_torch.training.trainer import Trainer

    batch_size = min(batch_size, dataset_size)  # a small eval set keeps one batch
    kw = {"DATASET_SIZE": dataset_size, "BATCH_SIZE": batch_size}
    kw.update(config_overrides or {})  # an explicit override wins
    trainer = Trainer(config=TrainingConfig(**kw), device=device)
    trainer.load(model_dir)
    dvae = trainer.dvae
    g = torch.Generator(device=trainer.device)
    g.manual_seed(seed)

    # recon_mse (eval mode) is the deployment metric; recon_mse_train_mode
    # is computed as the loss history's entries are
    mses, mses_train, all_spins = [], [], []
    n = int(trainer.images.shape[0])
    n_replicas = trainer.config.N_REPLICAS
    for i in range(0, n - batch_size + 1, batch_size):
        batch = trainer.images[i: i + batch_size]
        with torch.inference_mode():
            _, spins, recon = dvae.eval()(batch, 1, g)
            mses.append(float(torch.mean(torch.square(recon[:, 0] - batch))))
            all_spins.append(spins[:, 0].float())
        recon_t = _train_mode_recon(dvae, batch, n_replicas, g)
        mses_train.append(float(torch.mean(torch.square(recon_t - batch[:, None]))))
    data_spins = torch.cat(all_spins, dim=0)

    # generation and latent MMD, through the sampler backend (the SampleSet
    # carries the scaled model's energies)
    sample_set = trainer.sample_sampleset(num_reads=num_reads)
    samples = torch.as_tensor(sample_set.spins, dtype=torch.float32, device=trainer.device)
    with torch.inference_mode():
        mmd = float(mmd_loss(data_spins[: 4 * num_reads], samples, GaussianKernel(7)))
    out = {
        "model": str(Path(model_dir).name),
        "n_latents": trainer.n_latents,
        "n_edges": trainer.graph.n_edges,
        "recon_mse": round(float(np.mean(mses)), 5),
        "recon_mse_train_mode": round(float(np.mean(mses_train)), 5),
        "latent_mmd": round(mmd, 5),
        "sample_energy_mean": round(float(np.mean(sample_set.energies)), 4),
        "data_source": trainer.data_source.origin,
        "sampler_matmul_dtype": trainer.config.SAMPLER_MATMUL_DTYPE,
    }
    if image_rounds > 0:
        out.update(image_space_metrics(trainer, num_reads, image_rounds, seed + 1))
    return out


def main(argv=None):
    from image_generation_tpu_torch.app.cli import _device

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--models", action="append", default=None,
        help="checkpoint root(s), repeatable; every subdirectory holding a dvae.pth is "
        "evaluated (default: runs/models)",
    )
    ap.add_argument(
        "--dataset-size", type=int, default=None,
        help="eval-set size (default: min(2048, the untiled data pool))",
    )
    ap.add_argument("--num-reads", type=int, default=256)
    ap.add_argument(
        "--image-rounds", type=int, default=4,
        help="sampling rounds for the image-space MMD (0 disables)",
    )
    ap.add_argument(
        "--sampler-matmul-dtype", default=None,
        choices=("auto", "float32", "bfloat16", "int8"),
        help="SAMPLER_MATMUL_DTYPE override for every evaluation (int8 = the quantized "
        "sampler)",
    )
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--platform", default=None,
                    help="'cpu' runs on the CPU; the default is the CUDA card")
    args = ap.parse_args(argv)
    device = _device(args)
    if args.dataset_size is None:
        from image_generation_tpu_torch.utils.data import mnist_pool_size

        args.dataset_size = min(2048, mnist_pool_size())
    overrides = (
        {"SAMPLER_MATMUL_DTYPE": args.sampler_matmul_dtype}
        if args.sampler_matmul_dtype
        else None
    )

    results = []
    for root in args.models or ["runs/models"]:
        dirs = sorted(d for d in Path(root).iterdir() if (d / "dvae.pth").exists())
        for d in dirs:
            r = evaluate_checkpoint(
                d, args.dataset_size, args.num_reads,
                image_rounds=args.image_rounds,
                config_overrides=overrides, device=device,
            )
            results.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
