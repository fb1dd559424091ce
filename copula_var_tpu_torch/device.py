"""Device resolution: the caller names the device, nothing is guessed."""

from __future__ import annotations

import torch


def resolve_device(device="cpu") -> torch.device:
    """`torch.device` for a user's request. Only "cpu" and "cuda[:k]" are
    served; asking for CUDA on a machine without a GPU is an error, never
    a quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda'")
