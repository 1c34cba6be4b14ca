"""Conflict-set backend selection for the port.

`make_conflict_set` is the port's one recruitment point, driven by
SERVER_KNOBS.CONFLICT_SET_IMPL (the port's counterpart of
foundationdb_tpu/resolver/factory.py):

  gpu     the block-sparse conflict set on the CUDA card (gpu.py); pass
          device="cpu" to run its plain torch version on the CPU. The
          default: the port's entry points run on the card unless asked.
  oracle  the pure-Python step function (cpu.py), the differential
          reference.

The JAX package's "native" and "tpu" are not port backends. Unknown names
raise with the known list: a typo must not silently recruit another
backend, and nothing falls back from the card to the CPU.
"""

from __future__ import annotations

KNOWN_CONFLICT_SET_IMPLS = ("gpu", "oracle")


def validate_conflict_set_impl(name: str | None = None) -> str:
    """The lower-cased CONFLICT_SET_IMPL (`name`, or the knob's value);
    raises ValueError with the known implementations for any other."""
    if name is None:
        from ..core.knobs import SERVER_KNOBS

        name = SERVER_KNOBS.CONFLICT_SET_IMPL
    low = str(name).lower()
    if low not in KNOWN_CONFLICT_SET_IMPLS:
        raise ValueError(
            f"unknown CONFLICT_SET_IMPL {name!r}; known implementations: "
            + "|".join(KNOWN_CONFLICT_SET_IMPLS)
        )
    return low


def make_conflict_set(init_version: int = 0, impl: str | None = None,
                      device=None, **kw):
    """Construct the knob-selected conflict set at `init_version`.

    `impl` overrides SERVER_KNOBS.CONFLICT_SET_IMPL. Extra keyword
    arguments go to ConflictSetGPU (capacity and key-width sizing), which
    runs on `device` (None: the CUDA card, which must be present)."""
    name = validate_conflict_set_impl(impl)
    if name == "gpu":
        from .gpu import ConflictSetGPU

        return ConflictSetGPU(init_version, device=device, **kw)
    from .cpu import ConflictSetCPU

    return ConflictSetCPU(init_version)
