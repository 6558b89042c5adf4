"""Faults planted in the program, each one the comparison must catch.

Each entry patches the program (through pytest's ``monkeypatch`` or a
``Patches``) until the patch is undone.  Training: a step that leaves
its state unchanged and a step that trains on half its batch.  Serving:
a sampler that returns its start unchanged, a dispatch that samples half
its requests' chains and hands the rest copies, and an answer altered where
it is produced.  ``portbench/readings.py`` plants the same faults on the
card.
"""

from __future__ import annotations

import numpy as np
import torch


def _train_state_unchanged(mp):
    from image_generation_tpu_torch.training import step

    inner = step.TrainStepFns._step

    def _step(self, state, images, epoch, feed, dp):
        keep = (state.chains.clone(), state.chain_energies.clone(),
                {k: v.detach().clone() for k, v in state.dvae.state_dict().items()},
                state.grbm_params.linear.detach().clone(),
                state.grbm_params.quadratic.detach().clone())
        out = inner(self, state, images, epoch, feed, dp)
        with torch.no_grad():
            state.chains, state.chain_energies = keep[0], keep[1]
            state.dvae.load_state_dict(keep[2])
            state.grbm_params.linear.copy_(keep[3])
            state.grbm_params.quadratic.copy_(keep[4])
        return out

    mp.setattr(step.TrainStepFns, "_step", _step)


def _train_half_batch(mp):
    from image_generation_tpu_torch.training import step

    inner = step.TrainStepFns._step

    def _step(self, state, images, epoch, feed, dp):
        return inner(self, state, images[: images.shape[0] // 2], epoch, feed, dp)

    mp.setattr(step.TrainStepFns, "_step", _step)


def _serve_state_unchanged(mp):
    from image_generation_tpu_torch.training import step

    def sweeps_fn(self, generator, hp, coupling_p, chains, n_sweeps, *a, **kw):
        return chains.clone()

    mp.setattr(step.SampleFns, "sweeps_fn", sweeps_fn)


def _serve_half_batch(mp):
    from image_generation_tpu_torch.app import warm

    inner = warm.WarmGenerator._serve_fn

    def _serve_fn(self, trainer, k):
        half = inner(self, trainer, max(1, k // 2))
        return np.concatenate([half] * (-(-k // half.shape[0])))[:k]

    mp.setattr(warm.WarmGenerator, "_serve_fn", _serve_fn)


def _serve_answer_altered(mp):
    from image_generation_tpu_torch.app import warm

    inner = warm.WarmGenerator._serve_fn

    def _serve_fn(self, trainer, k):
        out = inner(self, trainer, k)
        out[:, :, 0, 0, 0] = 255 - out[:, :, 0, 0, 0]
        return out

    mp.setattr(warm.WarmGenerator, "_serve_fn", _serve_fn)


# by traffic driver: the faults a cell of that driver can have
FAULTS = {
    "train_epochs": {"state_unchanged": _train_state_unchanged,
                     "half_batch": _train_half_batch},
    "serve_closed_loop": {"state_unchanged": _serve_state_unchanged,
                          "half_batch": _serve_half_batch,
                          "answer_altered": _serve_answer_altered},
}


class Patches:
    """``monkeypatch``'s ``setattr`` outside pytest, undone by ``undo``."""

    def __init__(self):
        self._undo = []

    def setattr(self, target, name, value):
        self._undo.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self._undo:
            target, name, value = self._undo.pop()
            setattr(target, name, value)
