"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``"cuda"`` device with no card visible is an error, never a quiet move to
the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when none is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    return dev
