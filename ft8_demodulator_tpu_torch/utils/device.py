"""The device an entry point runs on."""

from __future__ import annotations

import os

import torch

__all__ = ["entry_device", "platform_device"]


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


def platform_device() -> torch.device:
    """The device of the command-line front ends: ``FT8_PLATFORM=cpu``
    (the JAX package's switch) routes them to the CPU; otherwise they run
    on the card, and without one this raises."""
    if os.environ.get("FT8_PLATFORM", "").strip().lower() == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: set FT8_PLATFORM=cpu "
                           "to run on the CPU")
    return torch.device("cuda")
