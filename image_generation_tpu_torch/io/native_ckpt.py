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

The file is topology-independent, as the JAX package's: on a mesh
(``fns`` given, ``fns.mesh`` set) ``save_train_state`` gathers the global
state, every rank taking part, and rank 0 writes it in the one-device
schema: the whole chains and ladder energies (``fns.unlocal``: the
ranks' rows, and under graph sharding their column windows), the whole
column-sharded dense layers and their moments (``parallel/dense.py``),
the rest as it is (replicated).  ``restore_payload`` with ``fns`` cuts
such a file to this rank's part by the same rules, so a state saved on
one mesh restores on another or on one device, and the other way round.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from image_generation_tpu_torch.parallel.dense import (
    cut_optimizer_state,
    gather_large_dense,
    gather_optimizer_state,
)

__all__ = ["SCHEMA", "save_train_state", "restore_train_state", "restore_payload",
           "load_payload", "latest_step", "global_payload", "local_payload"]

SCHEMA = "image_generation_tpu_torch/train_state/v1"
# tensors restored into the template's, whose shapes they must match
_TENSORS = ("grbm_linear", "grbm_quadratic", "chains", "chain_energies", "pt_betas")


def _path(directory, step: int) -> Path:
    return Path(directory) / f"step_{int(step):08d}.pt"


def _mesh(fns):
    return getattr(fns, "mesh", None)


def global_payload(state, fns=None, extra: Optional[dict] = None) -> dict:
    """The checkpoint dict of ``state``: on a mesh (``fns.mesh``) the
    global state gathered from every rank's part (collective), on every
    rank."""
    mesh = _mesh(fns)
    chains, energies = state.chains, state.chain_energies
    if mesh is not None:
        chains = fns.unlocal(chains)
        if energies.numel():
            energies = fns.unlocal(energies, columns=False)
    return {
        "schema": SCHEMA,
        "dvae": gather_large_dense(state.dvae),
        "grbm_linear": state.grbm_params.linear.detach(),
        "grbm_quadratic": state.grbm_params.quadratic.detach(),
        "dvae_opt": gather_optimizer_state(state.dvae_opt),
        "grbm_opt": state.grbm_opt.state_dict(),
        "chains": chains,
        "chain_energies": energies,
        "pt_betas": state.pt_betas,
        "opt_step": int(state.opt_step),
        "generator": state.generator.get_state(),
        "extra": dict(extra or {}),
    }


def save_train_state(directory, state, step: Optional[int] = None,
                     extra: Optional[dict] = None, fns=None) -> Path:
    """Write the non-derivable ``state`` to ``directory/step_<k>.pt``
    (``k`` = ``state.opt_step`` unless ``step``); ``extra`` is stored
    beside it under its own keys.  Written to a temporary file first, so a
    run killed while saving leaves the earlier checkpoints whole.  On a
    mesh (``fns.mesh``) every rank calls it: the global state is gathered
    (``global_payload``), rank 0 writes it, and every rank waits for the
    file."""
    directory = Path(directory)
    path = _path(directory, state.opt_step if step is None else step)
    payload = global_payload(state, fns, extra)
    mesh = _mesh(fns)
    if mesh is None or mesh.rank == 0:
        directory.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()
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


def restore_train_state(directory, template, step: Optional[int] = None, rebuild_cache=None,
                        fns=None):
    """Restore the checkpoint of ``step`` (the latest by default) into
    ``template``, a state built by the same step functions (``fns.init`` or
    ``state_from``), in place, and return it (``restore_payload``)."""
    payload = load_payload(directory, step, map_location=template.chains.device)
    return restore_payload(payload, template, rebuild_cache, fns)


def local_payload(payload: dict, template, fns) -> dict:
    """A global checkpoint dict cut to this rank's part of the mesh
    (``fns.mesh``): the chains and ladder energies by ``fns.local``, the
    column-sharded layers' moments by ``parallel.dense.cut_optimizer_state``
    (their weights are cut as they load)."""
    out = dict(payload)
    if _mesh(fns) is None:
        return out
    out["chains"] = fns.local(payload["chains"])
    if payload["chain_energies"].numel():
        out["chain_energies"] = fns.local(payload["chain_energies"][..., None])[..., 0]
    out["dvae_opt"] = cut_optimizer_state(template.dvae_opt, payload["dvae_opt"])
    return out


def restore_payload(payload: dict, template, rebuild_cache=None, fns=None):
    """Restore a ``load_payload`` dict into ``template`` in place.

    Every tensor must have the template's shape: a checkpoint written under
    another configuration (another sampler mode, ladder or graph) raises
    ``ValueError`` naming the field instead of restoring part of it.
    ``rebuild_cache`` (``TrainStepFns.rebuild_cache``) recomputes the
    sampler cache from the restored GRBM parameters; without it the cache
    is left as the template's, which the caller must rebuild.  On a mesh
    (``fns.mesh``) the global dict is cut to this rank's part first
    (``local_payload``)."""
    payload = local_payload(payload, template, fns)
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
