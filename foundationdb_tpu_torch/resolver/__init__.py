"""Optimistic conflict resolution on the CUDA card.

- `ConflictSetGPU` (gpu.py): the block-sparse conflict set, the port of
  foundationdb_tpu.resolver.tpu.ConflictSetTPU; its rank probe is the
  hand-written CUDA kernel of probe.py / csrc/probe.cu.
- `ConflictSetCPU` (cpu.py): the exact step-function oracle.

`make_conflict_set` (factory.py) constructs either by name.
"""

from .types import (  # noqa: F401
    COMMITTED,
    CONFLICT,
    TOO_OLD,
    ConflictBatchResult,
    TxnConflictInfo,
)
from .cpu import ConflictSetCPU  # noqa: F401
from .factory import make_conflict_set  # noqa: F401
