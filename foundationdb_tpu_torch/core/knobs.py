"""The port's server knobs.

The port's own copy of the conflict-set and storage-window knobs of
foundationdb_tpu/core/knobs.py (same names, same defaults); the port reads
nothing of the JAX package. Values are plain attributes: a deployment or a
test sets them directly (`SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 4`).

There is no probe-implementation knob: the device of the state tensors
picks the probe (the hand-written CUDA kernel on the card, its plain torch
version on the CPU), see resolver/probe.py. Nor is there a storage-engine
knob: the caller names the MVCC window's implementation
(storage_engine/factory.py).
"""

from __future__ import annotations


class ServerKnobs:
    def __init__(self) -> None:
        # Versions: the MVCC read window a storage server keeps (5 s).
        self.VERSIONS_PER_SECOND = 1_000_000
        self.MAX_READ_TRANSACTION_LIFE_VERSIONS = 5 * 1_000_000
        # Batch-size buckets a deployment warms ahead of time (warmup()).
        self.TPU_BATCH_BUCKETS = (256, 1024, 4096, 16384, 65536)
        # Chunk caps: one submit is split into chunks of at most this many
        # transactions / total conflict ranges (resolver/gpu.py _chunks).
        self.TPU_MAX_CHUNK_TXNS = 65536
        self.TPU_MAX_CHUNK_RANGES = 1 << 19
        # Batches per sticky-cap decay epoch (packing.StickyCaps).
        self.TPU_STICKY_DECAY_BATCHES = 64
        # Block-sparse state: slots per block (pow2; fill target is half)
        # and fast resolves between amortized compaction passes.
        self.TPU_BLOCK_SLOTS = 32
        self.TPU_COMPACT_EVERY_BATCHES = 16
        # Cap on the touched-block gather bucket K; a batch spraying more
        # blocks takes the compaction pass instead.
        self.TPU_MAX_TOUCHED_BLOCKS = 1 << 17
        # Batches a caller may keep in flight between submit and verdicts.
        self.TPU_PIPELINE_DEPTH = 4
        # Storage read window (storage_engine/gpu_engine.py): delta
        # (memtable) entries before the window compacts, and the widest
        # range span one dispatch gathers (a wider range is answered by
        # the host oracle).
        self.STORAGE_TPU_DELTA_SLOTS = 2048
        self.STORAGE_TPU_SPAN_CAP = 256
        # Storage read batcher: requests per fused dispatch, and batches
        # in flight between submit_reads and read_verdicts.
        self.STORAGE_READ_BATCH_MAX = 128
        self.STORAGE_READ_PIPELINE_DEPTH = 2


class ClientKnobs:
    def __init__(self) -> None:
        # Largest admitted key (bounds the resolver's packed key width).
        self.KEY_SIZE_LIMIT = 10_000


SERVER_KNOBS = ServerKnobs()
CLIENT_KNOBS = ClientKnobs()
