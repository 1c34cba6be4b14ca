"""Exact CPU reference conflict set — the oracle.

The port's own copy of foundationdb_tpu.resolver.cpu (the port imports nothing
of the JAX package); the byte and buffer formats are identical. One
departure: phase 2 keeps the union of the batch's committed writes as
disjoint intervals instead of scanning every committed write per read
(same verdicts; tests/test_torch_oracle.py holds it to the JAX copy), so
that a BASELINE-size batch of 65,536 txns resolves in seconds; phase 1
takes the maximum over a read that spans many entries from a sparse table
of the versions, built once per batch, instead of scanning them (same
verdicts); and phase 3 sets the batch version over the union of the
committed writes in one merge pass over the history, instead of one list
splice per write range, which costs the whole history each (the same
step function, so the same entries() once the GC pass coalesces).

Semantics are a faithful re-derivation of the reference's versioned-skip-list
ConflictSet (fdbserver/SkipList.cpp), restated as a *step function*
version(x) over the key space:

- An entry (key_i, v_i) means: every key in [key_i, key_{i+1}) was last
  written at version v_i (skip-list nodes store exactly this,
  SkipList.cpp:309-352 + addConflictRanges :511-523).
- Read check (SkipList::CheckMax, :755-837): read range [b, e) at snapshot s
  conflicts iff max(version at b, versions of entries in (b, e)) > s.
- tooOld (ConflictBatch::addTransaction, :979-987): read_snapshot <
  oldestVersion and the txn has read ranges; such txns take no further part.
- Intra-batch (checkIntraBatchConflicts, :1133-1158): sequential in batch
  order; a txn's reads are checked against the accumulated writes of earlier
  *non-conflicting* txns in the same batch; only non-conflicting txns add
  their writes.
- Merge (mergeWriteConflictRanges, :1260+): committed txns' write ranges are
  set to the batch version in the step function.
- GC (removeBefore, :665-702): entries below the oldest version may be
  collapsed; observable answers are preserved because any live read has
  snapshot >= oldestVersion (we clamp stale versions to 0 and coalesce,
  which is equivalent for every reachable query).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Sequence

import numpy as np

from ..kv.keys import KeyRange
from .types import COMMITTED, CONFLICT, TOO_OLD, ConflictBatchResult, TxnConflictInfo


SCAN_SPAN = 64  # reads over more entries use the sparse table


def sparse_max_table(vers: Sequence[int]) -> list[np.ndarray]:
    """table[k][i] = max(vers[i : i + 2**k]): the maximum over [lo, hi) is
    that of table[k][lo] and table[k][hi - 2**k], k = floor(log2(hi -
    lo))."""
    table = [np.asarray(vers, dtype=np.int64)]
    while 2 << (len(table) - 1) <= len(vers):
        prev, h = table[-1], 1 << (len(table) - 1)
        table.append(np.maximum(prev[:-h], prev[h:]))
    return table


class ConflictSetCPU:
    """Step-function conflict history over byte-string keys."""

    max_key_bytes: int | None = None  # unlimited (the TPU twin has a width)

    def __init__(self, init_version: int = 0):
        # Parallel arrays, keys sorted ascending; keys[0] == b"" always.
        # versions[i] applies to [keys[i], keys[i+1]) (last segment unbounded).
        self._keys: list[bytes] = [b""]
        self._vers: list[int] = [init_version]
        self.oldest_version: int = 0

    # -- introspection (tests) --
    def entries(self) -> list[tuple[bytes, int]]:
        return list(zip(self._keys, self._vers))

    def version_at(self, key: bytes) -> int:
        i = bisect_right(self._keys, key) - 1
        return self._vers[i]

    def max_version_in(self, r: KeyRange) -> int:
        """max version over [begin, end): segment at begin plus entries in
        (begin, end)."""
        lo = bisect_right(self._keys, r.begin) - 1  # segment containing begin
        hi = bisect_left(self._keys, r.end)  # entries strictly < end
        return max(self._vers[lo:hi])

    # -- the ConflictBatch contract --
    def resolve(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        n = len(txns)
        statuses = [COMMITTED] * n

        # Phase 0: tooOld (checked against the *pre-batch* oldestVersion).
        too_old = [
            t.read_snapshot < self.oldest_version and len(t.read_ranges) > 0 for t in txns
        ]

        # Phase 1: read-vs-history (max_version_in, inlined). A read over
        # more than SCAN_SPAN entries takes its maximum from a sparse table
        # of the versions, built at most once per batch: phase 1 does not
        # change the history.
        keys, vers, table = self._keys, self._vers, None
        for i, t in enumerate(txns):
            if too_old[i]:
                statuses[i] = TOO_OLD
                continue
            for r in t.read_ranges:
                if r.is_empty():
                    continue
                lo = bisect_right(keys, r.begin) - 1
                hi = bisect_left(keys, r.end)
                if hi - lo <= SCAN_SPAN:
                    m = max(vers[lo:hi])
                else:
                    if table is None:
                        table = sparse_max_table(vers)
                    k = (hi - lo).bit_length() - 1
                    m = int(max(table[k][lo], table[k][hi - (1 << k)]))
                if m > t.read_snapshot:
                    statuses[i] = CONFLICT
                    break

        # Phase 2: intra-batch, sequential in batch order. Reads of txn i are
        # checked against writes of earlier txns that are (so far) committed.
        # Only their union matters (a read conflicts iff it overlaps some
        # committed write iff it overlaps the union), kept as sorted
        # disjoint intervals [ub[j], ue[j]): both lists are sorted, so the
        # last interval beginning before a read's end has the largest end
        # among those that could overlap it. O(log n) per range, where a
        # scan of the committed writes is O(n) and makes a 64K-txn batch
        # take minutes.
        ub: list[bytes] = []
        ue: list[bytes] = []
        for i, t in enumerate(txns):
            if statuses[i] != COMMITTED:
                continue
            conflict = False
            for r in t.read_ranges:
                if r.is_empty():
                    continue
                j = bisect_left(ub, r.end) - 1
                if j >= 0 and ue[j] > r.begin:
                    conflict = True
                    break
            if conflict:
                statuses[i] = CONFLICT
            else:
                for w in t.write_ranges:
                    if w.is_empty():
                        continue
                    # Intervals overlapping or touching [begin, end) merge.
                    lo = bisect_left(ue, w.begin)
                    hi = bisect_right(ub, w.end)
                    b, e = w.begin, w.end
                    if lo < hi:
                        b, e = min(b, ub[lo]), max(e, ue[hi - 1])
                    ub[lo:hi] = [b]
                    ue[lo:hi] = [e]

        # Phase 3: merge committed write ranges at the batch version.
        self._set_ranges(sorted(
            (w.begin, w.end)
            for i, t in enumerate(txns) if statuses[i] == COMMITTED
            for w in t.write_ranges if not w.is_empty()
        ), version)

        # Phase 4: GC. The clamp/coalesce runs every batch (a no-op beyond
        # the <= boundary when the horizon does not advance), keeping the
        # step function bit-identical to the TPU kernel's, which always
        # clamps during its merge pass.
        self.oldest_version = max(self.oldest_version, new_oldest_version)
        self._gc()

        return ConflictBatchResult(statuses)

    # -- step-function mutation --
    def _set_ranges(self, spans, version: int) -> None:
        """Set `version` over every [begin, end) of the sorted `spans`,
        preserving the value at each end (ref: SkipList::addConflictRanges
        — insert end with prior value, remove interior, insert begin at the
        new version), in one pass over the history: overlapping and
        touching spans merge first, since they all take one version."""
        keys, vers = self._keys, self._vers
        out_k: list[bytes] = []
        out_v: list[int] = []
        i = k = 0  # the first history entry not yet copied; the next span
        while k < len(spans):
            b, e = spans[k]
            k += 1
            while k < len(spans) and spans[k][0] <= e:
                e = max(e, spans[k][1])
                k += 1
            lo = bisect_left(keys, b, i)
            hi = bisect_left(keys, e, lo)
            out_k += keys[i:lo]
            out_v += vers[i:lo]
            out_k.append(b)
            out_v.append(version)
            if hi >= len(keys) or keys[hi] != e:
                out_k.append(e)
                out_v.append(vers[hi - 1])  # the value at e (keys[0] = b"")
            i = hi
        self._keys = out_k + keys[i:]
        self._vers = out_v + vers[i:]

    def _gc(self) -> None:
        """Clamp versions at-or-below the horizon to 0 and coalesce equal
        neighbours. The clamp is `<=` (not `<`): an entry at exactly
        oldest_version can never conflict either (every live snapshot is
        >= oldest_version >= it), and the inclusive clamp gives 0 a unique
        meaning — "at or below the horizon" — shared bit-for-bit with the
        TPU kernel's int32-offset representation."""
        keys, vers = self._keys, self._vers
        out_k: list[bytes] = []
        out_v: list[int] = []
        for k, v in zip(keys, vers):
            if v <= self.oldest_version:
                v = 0
            if out_v and out_v[-1] == v:
                continue
            out_k.append(k)
            out_v.append(v)
        self._keys, self._vers = out_k, out_v

    def __len__(self) -> int:
        return len(self._keys)
