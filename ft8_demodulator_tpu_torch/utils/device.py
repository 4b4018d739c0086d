"""The device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["entry_device"]


def entry_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without a
    card raises (the entry points run on the card unless the caller asks
    for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available: pass "
            "device='cpu' to run on the CPU")
    return device
