"""The device an entry point runs on.

Every public entry point of the port takes ``device="cuda"`` by default:
it runs on the card unless the caller asks for the CPU.  A CUDA request on
a host without CUDA raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and this
    host has none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not available")
    return device
