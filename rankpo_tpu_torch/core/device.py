"""Device resolution shared by the port's entry points: the card unless the
caller asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; a CUDA request without a card raises
    instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False: no CUDA card is visible (pass --device cpu to run the "
            "plain PyTorch path on the CPU)"
        )
    return device
