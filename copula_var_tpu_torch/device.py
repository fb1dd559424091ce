"""Device resolution: the card by default; the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for a user's request, the card unless the caller
    asks for "cpu". Only "cpu" and "cuda[:k]" are served; asking for CUDA
    (the default) on a machine without a GPU is an error, never a quiet
    fall back to the CPU."""
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


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a
    host clock read after it covers the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(seed, device="cuda") -> torch.Generator:
    """A `torch.Generator` for a simulator: `seed` as it is when it is
    one already (its device then rules), else a new one on `device`
    seeded with the integer `seed`."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
