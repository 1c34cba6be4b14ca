"""The storage server's MVCC read window on the CUDA card, and the
durable local storage tier (ref: fdbserver/IKeyValueStore.h engines).

- `KeyValueStoreGPU` (gpu_engine.py): the device-resident window, the port
  of foundationdb_tpu.storage_engine.tpu_engine.KeyValueStoreTPU; its base
  rank probe is the hand-written CUDA kernel of resolver/probe.py.
- `make_mvcc_window` (factory.py) constructs it or the host
  VersionedMap by name.
- `DiskQueue` (diskqueue.py): page-checksummed two-file durable FIFO (the
  native C++ fsync path of native/diskqueue.cpp, ctypes-bound and built at
  first use, with a format-identical pure-Python twin for simulated
  disks) — ref fdbserver/DiskQueue.actor.cpp.
- `KeyValueStoreMemory` (memory_engine.py): ordered in-memory map made
  durable as an operation log + periodic snapshot on the DiskQueue — ref
  fdbserver/KeyValueStoreMemory.actor.cpp:258-375. The "ssd" engine,
  `KeyValueStoreSSD` (ssd_engine.py), is a native B+tree.

The durable engine kind (memory | ssd) is orthogonal to the MVCC window's
(gpu | memory): a storage server restores its window from its engine.
"""

from .diskqueue import DiskQueue  # noqa: F401
from .factory import make_mvcc_window  # noqa: F401
from .memory_engine import KeyValueStoreMemory  # noqa: F401
