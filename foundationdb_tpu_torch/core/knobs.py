"""The port's resolver knobs.

The port's own copy of the conflict-set knobs of
foundationdb_tpu/core/knobs.py (same names, same defaults); the port reads
nothing of the JAX package. Values are plain attributes: a deployment or a
test sets them directly (`SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 4`).

There is no probe-implementation knob: the device of the state tensors
picks the probe (the hand-written CUDA kernel on the card, its plain torch
version on the CPU), see resolver/probe.py.
"""

from __future__ import annotations


class ServerKnobs:
    def __init__(self) -> None:
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


class ClientKnobs:
    def __init__(self) -> None:
        # Largest admitted key (bounds the resolver's packed key width).
        self.KEY_SIZE_LIMIT = 10_000


SERVER_KNOBS = ServerKnobs()
CLIENT_KNOBS = ClientKnobs()
