"""Optimistic conflict resolution on the CUDA card.

- `ConflictSetGPU` (gpu.py): the block-sparse conflict set, the port of
  foundationdb_tpu.resolver.tpu.ConflictSetTPU; its rank probe is the
  hand-written CUDA kernel of probe.py / csrc/probe.cu.
- `ConflictSetCPU` (cpu.py): the exact step-function oracle.
- `ShardedConflictSetGPU` (sharded.py): S resolver shards over a key-space
  partition, stacked on one device (BASELINE config 4), the port of
  foundationdb_tpu.resolver.sharded.ShardedConflictSetTPU;
  `ShardedConflictSetCPU` is its oracle, `shard_key_ranges` and
  `clip_txns_to_shard` the partition helpers both share.

- `ConflictSetRankFed` (rankfed.py): the rank-fed set, whose keys stay in
  a sorted host mirror and whose device state is one version vector, the
  port of foundationdb_tpu.resolver.rankfed.ConflictSetRankFed.

Recruitment goes through `make_conflict_set` (factory.py), driven by
SERVER_KNOBS.CONFLICT_SET_IMPL ("gpu" | "native" | "oracle");
`ConflictSetNativeCPU` (native_cpu.py) is the C++ conflict detector on
the host.
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
from .rankfed import ConflictSetRankFed  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedConflictSetCPU,
    ShardedConflictSetGPU,
    clip_txns_to_shard,
    shard_key_ranges,
)
