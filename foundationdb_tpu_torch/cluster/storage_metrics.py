"""Per-range storage metrics via byte sampling (ref:
fdbserver/StorageMetrics.actor.h; sampling at
fdbserver/storageserver.actor.cpp:2870 byteSampleApplySet/Clear).

The reference cannot afford to count bytes per arbitrary range exactly, so
each storage server keeps a BYTE SAMPLE: every key is included with
probability proportional to its entry size, carrying weight size/p — an
unbiased estimator whose per-range sums answer `waitMetrics` (shard size
for DD) and `splitMetrics` (split points for shard splitting) in O(sample
size). Inclusion here is decided by a stable hash of the key, so a sim
run's estimates replay deterministically and set/clear of the same key
agree about its sampledness.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_left, insort
from typing import Optional

from ..core.knobs import SERVER_KNOBS
from ..core.stats import Smoother
from ..kv.keys import KeyRange


def _hash01(key: bytes) -> float:
    h = hashlib.md5(key).digest()
    return int.from_bytes(h[:8], "little") / 2**64


class ByteSample:
    """Sorted key -> weight estimator (ref: StorageServerMetrics.byteSample)."""

    def __init__(self):
        self._keys: list[bytes] = []
        self._weights: dict[bytes, float] = {}
        self.total = 0.0

    @staticmethod
    def _probability(kv_bytes: int) -> float:
        overhead = SERVER_KNOBS.BYTE_SAMPLING_OVERHEAD
        factor = SERVER_KNOBS.BYTE_SAMPLING_FACTOR
        return min(1.0, (kv_bytes + overhead) / (factor * overhead))

    def entry_set(self, key: bytes, kv_bytes: int) -> None:
        self.entry_clear_key(key)
        p = self._probability(kv_bytes)
        if _hash01(key) < p:
            w = (kv_bytes + SERVER_KNOBS.BYTE_SAMPLING_OVERHEAD) / p
            self._weights[key] = w
            insort(self._keys, key)
            self.total += w

    def entry_clear_key(self, key: bytes) -> None:
        w = self._weights.pop(key, None)
        if w is not None:
            i = bisect_left(self._keys, key)
            del self._keys[i]
            self.total -= w

    def entry_clear_range(self, begin: bytes, end: bytes) -> None:
        lo = bisect_left(self._keys, begin)
        hi = bisect_left(self._keys, end)
        for k in self._keys[lo:hi]:
            self.total -= self._weights.pop(k)
        del self._keys[lo:hi]

    def bytes_in_range(self, r: KeyRange) -> float:
        lo = bisect_left(self._keys, r.begin)
        hi = bisect_left(self._keys, r.end)
        return sum(self._weights[k] for k in self._keys[lo:hi])

    def split_points(self, r: KeyRange, chunk_bytes: float) -> list[bytes]:
        """Keys splitting r into chunks of ~chunk_bytes (ref: splitMetrics,
        StorageMetrics.actor.h — walks the sample accumulating until the
        target, emitting a boundary)."""
        out: list[bytes] = []
        acc = 0.0
        lo = bisect_left(self._keys, r.begin)
        hi = bisect_left(self._keys, r.end)
        for k in self._keys[lo:hi]:
            acc += self._weights[k]
            if acc >= chunk_bytes:
                out.append(k)
                acc = 0.0
        return out


class StorageServerMetrics:
    """One storage server's metrics surface (ref: StorageServerMetrics:
    byteSample + bandwidth/iops ContinuousSamples + waitMetrics)."""

    def __init__(self):
        self.byte_sample = ByteSample()
        self.bytes_input = Smoother(e_folding_time=10.0)   # write bandwidth
        self.bytes_durable = Smoother(e_folding_time=10.0)
        self.ops_read = Smoother(e_folding_time=10.0)

    # -- ingestion hooks (called by StorageServer._apply) --
    def on_set(self, key: bytes, value: bytes) -> None:
        self.byte_sample.entry_set(key, len(key) + len(value))
        self.bytes_input.add_delta(len(key) + len(value))

    def on_clear_key(self, key: bytes) -> None:
        self.byte_sample.entry_clear_key(key)

    def on_clear_range(self, begin: bytes, end: bytes) -> None:
        self.byte_sample.entry_clear_range(begin, end)

    def on_read(self) -> None:
        self.ops_read.add_delta(1)

    # -- query surface (ref: waitMetrics/splitMetrics/getShardSize) --
    def shard_bytes(self, r: KeyRange) -> float:
        return self.byte_sample.bytes_in_range(r)

    def split_points(self, r: KeyRange, chunk_bytes: Optional[float] = None
                     ) -> list[bytes]:
        if chunk_bytes is None:
            chunk_bytes = SERVER_KNOBS.DD_SHARD_SIZE_GRANULARITY
        return self.byte_sample.split_points(r, chunk_bytes)

    def write_bandwidth(self) -> float:
        return self.bytes_input.smooth_rate()
