"""Device resolution: explicit, defaulting to the CUDA card.

Nothing in the port picks the CPU on its own.  A caller that wants the CPU
says ``device="cpu"``; a CUDA request on a host without a card raises."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:   # name the card, so threads can select it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for all work queued on ``device`` (no-op off CUDA)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
