"""One rank of the port's CLI under the launcher, for the CPU tests.

``python -m torch.distributed.run --nproc-per-node N tests/torch_launch_rank.py
OUT_DIR <cli args>`` runs ``image_generation_tpu_torch.app.cli.main(<cli
args>)`` in every rank, as ``-m image_generation_tpu_torch.app.cli`` would,
then writes ``OUT_DIR/rank_<RANK>.json``: the rank's device, mesh shape and
backend, its per-step losses and a digest of its DVAE and GRBM parameters.
The CLI's own ranks run it too where a test sets ``cli.RANK_ENTRY`` to this
script and ``OUT_DIR``.  ``threaded_reference`` is the run those ranks are
held against: the same training by ``Trainer(mesh=...)`` on threaded ranks.
"""

import hashlib
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from image_generation_tpu_torch.app import cli  # noqa: E402


def digest(trainer) -> str:
    """sha256 over the DVAE's state dict and the GRBM's parameters, keys in
    order: equal digests, equal parameters bit for bit."""
    h = hashlib.sha256()
    tensors = dict(trainer.dvae.state_dict())
    tensors["grbm.linear"] = trainer.grbm_params.linear
    tensors["grbm.quadratic"] = trainer.grbm_params.quadratic
    for k in sorted(tensors):
        t = tensors[k].detach().cpu().contiguous()
        h.update(f"{k}{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def threaded_reference(config: dict, shape, epochs: int = 1, save_to=None) -> list:
    """``train --epochs epochs`` of the CLI at ``config`` (TrainingConfig
    fields) by ``Trainer(mesh=...)`` on threaded ranks of a ``shape`` mesh
    (``torch_ranks.run_ranks``), four progress chunks an epoch as the
    CLI's; rank 0 saves the model to ``save_to`` when given.  Returns each
    rank's (losses, digest)."""
    from torch_ranks import run_ranks

    from image_generation_tpu_torch.config import TrainingConfig
    from image_generation_tpu_torch.training.trainer import Trainer

    def rank(mesh):
        t = Trainer(TrainingConfig(**config), device="cpu", mesh=mesh)
        t.train_init(epochs)
        t.train(epochs, batch_cb=lambda *_: None, epoch_chunks=4)
        if save_to is not None:
            t.save(save_to, n_epochs=epochs)
        return t.losses, digest(t)

    return run_ranks(shape[0] * shape[1], rank, shape)


if __name__ == "__main__":
    out_dir = Path(sys.argv[1])
    trainer = cli.main(sys.argv[2:])
    mesh = trainer.mesh
    (out_dir / f"rank_{os.environ.get('RANK', '0')}.json").write_text(json.dumps(dict(
        device=str(trainer.device), losses=trainer.losses, digest=digest(trainer),
        mesh=list(mesh.shape) if mesh is not None else None,
        backend=mesh.backend if mesh is not None else None)))
