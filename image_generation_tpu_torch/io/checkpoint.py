"""Named-model checkpoint directories in the reference's on-disk format.

Port of the reading half of ``image_generation_tpu/io/checkpoint.py``.  A
model directory holds ``dvae.pth`` and ``grbm.pth`` (torch state dicts),
``parameters.json`` (run metadata) and ``losses.json``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import torch

from image_generation_tpu_torch.io.torch_pth import grbm_from_state_dict, load_state_dict
from image_generation_tpu_torch.models.grbm import GRBMGraph, GRBMParams

__all__ = ["load_model_dir", "read_parameters", "read_losses"]


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
