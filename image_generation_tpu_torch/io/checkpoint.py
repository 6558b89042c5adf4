"""Named-model checkpoint directories in the reference's on-disk format.

Port of ``image_generation_tpu/io/checkpoint.py``.  A model directory
holds ``dvae.pth`` and ``grbm.pth`` (torch state dicts), ``parameters.json``
(run metadata; the reference's misspelled ``dateset_size`` key is kept)
and ``losses.json``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from image_generation_tpu_torch.io.torch_pth import (
    dvae_state_dict,
    grbm_from_state_dict,
    grbm_state_dict,
    load_state_dict,
    save_state_dict,
)
from image_generation_tpu_torch.models.grbm import GRBMGraph, GRBMParams

__all__ = [
    "save_model_dir", "make_parameters_json", "load_model_dir", "read_parameters",
    "read_losses",
]


def save_model_dir(path, dvae: torch.nn.Module, grbm_params: GRBMParams,
                   graph: GRBMGraph, parameters: dict, losses: dict) -> Path:
    """Write a model directory in the reference's format."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_state_dict(path / "dvae.pth", dvae_state_dict(dvae))
    save_state_dict(path / "grbm.pth", grbm_state_dict(grbm_params, graph))
    (path / "parameters.json").write_text(json.dumps(parameters))
    (path / "losses.json").write_text(json.dumps(losses))
    return path


def make_parameters_json(n_latents: int, n_epochs: int, prefactor: float, qpu: str,
                         num_reads: int, loss_function: str, image_size: int,
                         batch_size: int, dataset_size: Optional[int],
                         random_seed: int) -> dict:
    """The reference's parameters.json schema, misspelling included."""
    return {
        "n_latents": n_latents,
        "n_epochs": n_epochs,
        "prefactor": prefactor,
        "qpu": qpu,
        "num_read": num_reads,
        "loss_function": loss_function,
        "image_size": image_size,
        "batch_size": batch_size,
        "dateset_size": dataset_size,  # sic: the reference's key
        "random_seed": random_seed,
    }


def load_model_dir(
    path, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], GRBMParams, GRBMGraph, dict, dict]:
    """Load (dvae state dict, grbm_params, graph, parameters, losses); the
    GRBM parameters land on ``device``, the state dict on the CPU."""
    path = Path(path)
    dvae_sd = load_state_dict(path / "dvae.pth")
    grbm_params, graph = grbm_from_state_dict(load_state_dict(path / "grbm.pth"), device)
    return dvae_sd, grbm_params, graph, read_parameters(path), read_losses(path)


def read_parameters(path) -> dict:
    p = Path(path) / "parameters.json"
    return json.loads(p.read_text()) if p.exists() else {}


def read_losses(path) -> dict:
    p = Path(path) / "losses.json"
    if p.exists():
        return json.loads(p.read_text())
    return {"mse_losses": [], "dvae_losses": []}
