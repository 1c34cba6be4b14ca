"""Conflict-set backend selection for the port.

`make_conflict_set` is the port's one construction point:

  gpu     the block-sparse conflict set on the CUDA card (gpu.py); pass
          device="cpu" to run its plain torch version on the CPU.
  oracle  the pure-Python step function (cpu.py), the differential
          reference.

Unknown names raise: a typo must not silently construct another backend.
"""

from __future__ import annotations

KNOWN_CONFLICT_SET_IMPLS = ("gpu", "oracle")


def make_conflict_set(init_version: int = 0, impl: str = "gpu",
                      device=None, **kw):
    """Construct the named conflict set at `init_version`; extra keyword
    arguments go to ConflictSetGPU (capacity and key-width sizing)."""
    name = str(impl).lower()
    if name == "gpu":
        from .gpu import ConflictSetGPU

        return ConflictSetGPU(init_version, device=device, **kw)
    if name == "oracle":
        from .cpu import ConflictSetCPU

        return ConflictSetCPU(init_version)
    raise ValueError(
        f"unknown conflict set implementation {impl!r}; known: "
        + "|".join(KNOWN_CONFLICT_SET_IMPLS)
    )
