"""Device choice for the port's entry points.

Every entry point takes `device=None`, which means the CUDA card. Running
on the CPU is something the caller asks for (`device="cpu"`, as the tests
do); a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for an entry point's `device` argument: None -> cuda.
    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present, or when `cuda:N` names a card past the
    machine's count."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is not None:
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise RuntimeError(
                f"{dev} asked for, but this machine has {count} CUDA "
                f"device(s)"
            )
    return dev


def on_device(dev: torch.device):
    """A scope that makes `dev` the current CUDA device (so a stream, an
    event or an allocation that names no device lands on it); nothing
    for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
