"""MVCC-window backend selection for the port.

`make_mvcc_window` is the port's one construction point for the storage
server's versioned read window:

  gpu     KeyValueStoreGPU (gpu_engine.py), the device-resident window
          answering batched point and range reads in one fused dispatch;
          pass device="cpu" to run its plain torch version on the CPU.
  memory  kv/versioned_map.VersionedMap, the host window and the
          differential oracle.

Unknown names raise: a typo must not silently construct another backend.
"""

from __future__ import annotations

KNOWN_MVCC_WINDOW_IMPLS = ("gpu", "memory")


def make_mvcc_window(impl: str = "gpu", device=None, **kw):
    """Construct the named MVCC window; extra keyword arguments go to
    KeyValueStoreGPU (key-width and block sizing)."""
    name = str(impl).lower()
    if name == "gpu":
        from .gpu_engine import KeyValueStoreGPU

        return KeyValueStoreGPU(device=device, **kw)
    if name == "memory":
        from ..kv.versioned_map import VersionedMap

        return VersionedMap()
    raise ValueError(
        f"unknown MVCC window implementation {impl!r}; known: "
        + "|".join(KNOWN_MVCC_WINDOW_IMPLS)
    )
