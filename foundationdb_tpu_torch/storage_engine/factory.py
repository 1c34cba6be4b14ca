"""MVCC-window backend selection for the port.

`make_mvcc_window` is the port's one construction point for the storage
server's versioned read window, driven by SERVER_KNOBS.STORAGE_ENGINE_IMPL
(cluster/storage.StorageServer recruits through it) unless the caller
names the implementation:

  gpu     KeyValueStoreGPU (gpu_engine.py), the device-resident window
          answering batched point and range reads in one fused dispatch;
          the default. Pass device="cpu" to run its plain torch version
          on the CPU.
  memory  kv/versioned_map.VersionedMap, the host window and the
          differential oracle.

Unknown names raise, the JAX package's "tpu" among them: a typo must not
silently construct another backend.
"""

from __future__ import annotations

KNOWN_MVCC_WINDOW_IMPLS = ("gpu", "memory")


def validate_storage_engine_impl(name: str | None = None) -> str:
    """The lower-cased implementation name, `name` or else the
    STORAGE_ENGINE_IMPL knob; raises ValueError for an unknown one."""
    if name is None:
        from ..core.knobs import SERVER_KNOBS

        name = SERVER_KNOBS.STORAGE_ENGINE_IMPL
    low = str(name).lower()
    if low not in KNOWN_MVCC_WINDOW_IMPLS:
        raise ValueError(
            f"unknown MVCC window implementation {name!r}; known: "
            + "|".join(KNOWN_MVCC_WINDOW_IMPLS)
        )
    return low


def make_mvcc_window(impl: str | None = None, device=None, **kw):
    """Construct the MVCC window `impl` names (None: the knob's). `device`
    and extra keyword arguments (key-width and block sizing) go to
    KeyValueStoreGPU."""
    name = validate_storage_engine_impl(impl)
    if name == "gpu":
        from .gpu_engine import KeyValueStoreGPU

        return KeyValueStoreGPU(device=device, **kw)
    from ..kv.versioned_map import VersionedMap

    return VersionedMap()
