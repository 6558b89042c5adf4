"""Native checkpoints: exact training resume.

Port of ``image_generation_tpu/io/native_ckpt.py``.  The reference format
(``io/checkpoint.py``) holds weights only, so a run cannot resume with its
optimizer state, LR position, random streams or sampler chains.  This
module writes the non-derivable ``TrainState``: the DVAE (parameters and
BatchNorm statistics), the GRBM parameters, both Adam states, the
persistent chains with their carried ladder energies, the live PT ladder
``pt_betas``, ``opt_step`` and the state's generator, plus whatever the
caller adds (the trainer's own seed stream).

The JAX package serializes with orbax into a directory per step; the port
writes one ``torch.save`` file per step, ``step_<k:08d>.pt``, under a
schema tag.  As there, the cached sampler model (``sampler_h``,
``sampler_coupling``: the state's largest buffer, a deterministic function
of the GRBM parameters) is not written; ``restore_train_state`` rebuilds
it with the step functions' ``rebuild_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

__all__ = ["SCHEMA", "save_train_state", "restore_train_state", "restore_payload",
           "load_payload", "latest_step"]

SCHEMA = "image_generation_tpu_torch/train_state/v1"
# tensors restored into the template's, whose shapes they must match
_TENSORS = ("grbm_linear", "grbm_quadratic", "chains", "chain_energies", "pt_betas")


def _path(directory, step: int) -> Path:
    return Path(directory) / f"step_{int(step):08d}.pt"


def save_train_state(directory, state, step: Optional[int] = None,
                     extra: Optional[dict] = None) -> Path:
    """Write the non-derivable ``state`` to ``directory/step_<k>.pt``
    (``k`` = ``state.opt_step`` unless ``step``); ``extra`` is stored
    beside it under its own keys.  Written to a temporary file first, so a
    run killed while saving leaves the earlier checkpoints whole."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = _path(directory, state.opt_step if step is None else step)
    payload = {
        "schema": SCHEMA,
        "dvae": state.dvae.state_dict(),
        "grbm_linear": state.grbm_params.linear.detach(),
        "grbm_quadratic": state.grbm_params.quadratic.detach(),
        "dvae_opt": state.dvae_opt.state_dict(),
        "grbm_opt": state.grbm_opt.state_dict(),
        "chains": state.chains,
        "chain_energies": state.chain_energies,
        "pt_betas": state.pt_betas,
        "opt_step": int(state.opt_step),
        "generator": state.generator.get_state(),
        "extra": dict(extra or {}),
    }
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory) -> Optional[int]:
    """The highest step saved under ``directory`` (None when there is none)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.stem.split("_")[1]) for p in directory.glob("step_*.pt"))
    return steps[-1] if steps else None


def load_payload(directory, step: Optional[int] = None, map_location=None) -> dict:
    """The raw checkpoint dict of ``step`` (the latest by default); raises
    ``FileNotFoundError`` without one and ``ValueError`` on another
    schema."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _path(directory, step)
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if not isinstance(payload, dict) or payload.get("schema") != SCHEMA:
        found = payload.get("schema") if isinstance(payload, dict) else type(payload).__name__
        raise ValueError(f"checkpoint {path} has schema {found!r}, this build reads {SCHEMA!r}")
    return payload


def restore_train_state(directory, template, step: Optional[int] = None, rebuild_cache=None):
    """Restore the checkpoint of ``step`` (the latest by default) into
    ``template``, a state built by the same step functions (``fns.init`` or
    ``state_from``), in place, and return it (``restore_payload``)."""
    payload = load_payload(directory, step, map_location=template.chains.device)
    return restore_payload(payload, template, rebuild_cache)


def restore_payload(payload: dict, template, rebuild_cache=None):
    """Restore a ``load_payload`` dict into ``template`` in place.

    Every tensor must have the template's shape: a checkpoint written under
    another configuration (another sampler mode, ladder or graph) raises
    ``ValueError`` naming the field instead of restoring part of it.
    ``rebuild_cache`` (``TrainStepFns.rebuild_cache``) recomputes the
    sampler cache from the restored GRBM parameters; without it the cache
    is left as the template's, which the caller must rebuild."""
    current = {"grbm_linear": template.grbm_params.linear,
               "grbm_quadratic": template.grbm_params.quadratic,
               "chains": template.chains, "chain_energies": template.chain_energies,
               "pt_betas": template.pt_betas}
    for name in _TENSORS:
        got, want = payload[name], current[name]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint field {name!r} has shape {tuple(got.shape)}, the current state "
                f"{tuple(want.shape)}: it was written under another configuration (sampler "
                f"mode, ladder size, chain count or graph)"
            )
    try:
        template.dvae.load_state_dict(payload["dvae"])
        template.dvae_opt.load_state_dict(payload["dvae_opt"])
        template.grbm_opt.load_state_dict(payload["grbm_opt"])
    except (RuntimeError, ValueError, KeyError) as e:
        raise ValueError(f"checkpoint does not match the current model or optimizers: {e}") from e
    with torch.no_grad():
        template.grbm_params.linear.copy_(payload["grbm_linear"])
        template.grbm_params.quadratic.copy_(payload["grbm_quadratic"])
    dev = template.chains.device
    template.chains = payload["chains"].to(dev, copy=True)
    template.chain_energies = payload["chain_energies"].to(dev, copy=True)
    template.pt_betas = payload["pt_betas"].to(dev, copy=True)
    template.opt_step = int(payload["opt_step"])
    template.generator.set_state(payload["generator"].cpu())
    if rebuild_cache is not None:
        template = rebuild_cache(template)
    return template
