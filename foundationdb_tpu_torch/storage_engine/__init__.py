"""The storage server's MVCC read window on the CUDA card.

- `KeyValueStoreGPU` (gpu_engine.py): the device-resident window, the port
  of foundationdb_tpu.storage_engine.tpu_engine.KeyValueStoreTPU; its base
  rank probe is the hand-written CUDA kernel of resolver/probe.py.
- `make_mvcc_window` (factory.py) constructs it or the host
  VersionedMap by name.
"""

from .factory import make_mvcc_window  # noqa: F401
