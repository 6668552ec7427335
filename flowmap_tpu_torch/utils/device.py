"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, refusing CUDA when there is no card.

    Entry points default to "cuda"; a caller without a card has to ask for
    the CPU explicitly (the tests do), so a missing card never silently
    turns a GPU run into a CPU run.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device
