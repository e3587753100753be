"""Device resolution shared by the port's entry points.

Every entry point takes a ``device`` and defaults to ``cuda``.  A CUDA
request on a machine without a card raises: the port never carries on
quietly on the CPU, which is reached only by asking for it
(``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "synchronize"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
