"""Device choice for the port's entry points.

Every entry point takes `device=None`, which means the CUDA card. Running
on the CPU is something the caller asks for (`device="cpu"`, as the tests
do); a missing card is an error, never a silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for an entry point's `device` argument: None -> cuda.
    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
