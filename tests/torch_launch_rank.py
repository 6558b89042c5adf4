"""One rank of the port's CLI under the launcher, for the CPU tests.

``python -m torch.distributed.run --nproc-per-node N tests/torch_launch_rank.py
OUT_DIR <cli args>`` runs ``image_generation_tpu_torch.app.cli.main(<cli
args>)`` in every rank, as ``-m image_generation_tpu_torch.app.cli`` would,
then writes ``OUT_DIR/rank_<RANK>.json``: the rank's device, mesh shape and
backend, its per-step losses and a digest of its DVAE and GRBM parameters.
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


if __name__ == "__main__":
    out_dir = Path(sys.argv[1])
    trainer = cli.main(sys.argv[2:])
    mesh = trainer.mesh
    (out_dir / f"rank_{os.environ.get('RANK', '0')}.json").write_text(json.dumps(dict(
        device=str(trainer.device), losses=trainer.losses, digest=digest(trainer),
        mesh=list(mesh.shape) if mesh is not None else None,
        backend=mesh.backend if mesh is not None else None)))
