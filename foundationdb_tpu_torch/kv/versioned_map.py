"""Multi-version ordered map — the storage server's in-memory MVCC window.

The port's own copy of foundationdb_tpu.kv.versioned_map (the port imports
nothing of the JAX package); the contract and the canonical entries() form
are identical. It is the host oracle of storage_engine/gpu_engine.py. One
departure: it indexes the keys whose chain forget_before can change (more
than one entry, or a tombstone), so that moving the window visits those
instead of every key (the same map after it).

The reference uses a persistent treap with path copying (PTree,
fdbclient/VersionedMap.h:38-63) so every version is a full immutable tree.
For this framework's single-process storage node the same contract —
read-at-version over a sliding window, apply-in-version-order, forget old
versions — is provided by a sorted key index plus per-key version chains:

    key -> [(version_0, value_0|None), (version_1, value_1|None), ...]

Reads at version v take the latest entry <= v; None is a tombstone. This is
O(log n) bisect per op and trivially correct for ordered range reads; the
path-copying trick exists in the reference to share structure across
versions under heavy concurrency, which a cooperative single-threaded node
does not need. clear_range(v) writes tombstones for the keys live at v in
the range — later inserts at v' > v are unaffected, which is exactly the
step semantics of a range clear applied at v.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from typing import Iterable, Optional


def canonical_chain(chain, oldest):
    """Normalize one ascending (version, value|None) chain to the
    canonical window form shared by VersionedMap.entries() and the device
    engine's reconstruction (storage_engine/gpu_engine.entries): keep the
    last entry <= oldest as the base, drop older; drop a tombstone base
    outright (absence answers every read >= oldest identically, and
    forget_before may already have erased it — so keeping it would make
    canonicalization depend on WHEN the window was trimmed, not just on
    its readable content)."""
    i = 0
    while i + 1 < len(chain) and chain[i + 1][0] <= oldest:
        i += 1
    chain = chain[i:]
    if chain and chain[0][0] <= oldest and chain[0][1] is None:
        chain = chain[1:]
    return chain


class VersionedMap:
    def __init__(self):
        self._keys: list[bytes] = []          # sorted live-or-dead key index
        self._chains: dict[bytes, list[tuple[int, Optional[bytes]]]] = {}
        self.oldest_version = 0               # reads below this are invalid
        self.latest_version = 0
        # keys whose chain forget_before may change: more than one entry,
        # or a tombstone (a superset; reindex() rebuilds it)
        self._trim: set[bytes] = set()

    def reindex(self) -> None:
        """Rebuild the forget_before index from _chains (after _chains was
        assigned from outside, as a hand-over does)."""
        self._trim = {k for k, c in self._chains.items()
                      if len(c) > 1 or any(val is None for _, val in c)}

    def _chain(self, key: bytes) -> list[tuple[int, Optional[bytes]]]:
        c = self._chains.get(key)
        if c is None:
            c = self._chains[key] = []
            insort(self._keys, key)
        return c

    # -- writes (must be applied in non-decreasing PER-KEY version order;
    #    cross-key order may interleave, e.g. a fetched shard replaying
    #    its buffered updates while other shards already advanced) --
    def set(self, key: bytes, value: bytes, version: int) -> None:
        c = self._chain(key)
        assert not c or version >= c[-1][0], "per-key version order"
        self.latest_version = max(self.latest_version, version)
        if c and c[-1][0] == version:
            c[-1] = (version, value)
        else:
            c.append((version, value))
        if len(c) > 1 or value is None:
            self._trim.add(key)

    def clear(self, key: bytes, version: int) -> None:
        c = self._chain(key)
        assert not c or version >= c[-1][0], "per-key version order"
        self.latest_version = max(self.latest_version, version)
        if c and c[-1][0] == version:
            c[-1] = (version, None)
        else:
            c.append((version, None))
        self._trim.add(key)

    def clear_range(self, begin: bytes, end: bytes, version: int) -> None:
        for key in self.keys_in_range(begin, end):
            self.clear(key, version)

    def set_snapshot(self, key: bytes, value: bytes, version: int) -> None:
        """Out-of-order base insert for shard fetches (ref: fetchKeys
        applying a snapshot BENEATH live updates, storageserver.actor.cpp
        :1761 AddingShard): `value` becomes the authoritative state at
        `version`, superseding any same-key entries at versions <= it
        (stream applies the fetch already covers), while entries above it
        are untouched."""
        c = self._chain(key)
        pos = 0
        while pos < len(c) and c[pos][0] <= version:
            pos += 1
        c[:pos] = [(version, value)]
        if len(c) > 1 or value is None:
            self._trim.add(key)
        self.latest_version = max(self.latest_version, version)

    # -- reads --
    def get(self, key: bytes, version: int) -> Optional[bytes]:
        assert version >= self.oldest_version, "read below MVCC window"
        c = self._chains.get(key)
        if not c:
            return None
        # latest entry with version <= `version`
        lo, hi = 0, len(c)
        while lo < hi:
            mid = (lo + hi) // 2
            if c[mid][0] <= version:
                lo = mid + 1
            else:
                hi = mid
        if lo == 0:
            return None
        return c[lo - 1][1]

    def keys_in_range(self, begin: bytes, end: bytes) -> list[bytes]:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        return self._keys[i:j]

    def get_range(
        self, begin: bytes, end: bytes, version: int,
        limit: int = 0, reverse: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        keys = self.keys_in_range(begin, end)
        if reverse:
            keys = list(reversed(keys))
        out: list[tuple[bytes, bytes]] = []
        for k in keys:
            v = self.get(k, version)
            if v is not None:
                out.append((k, v))
                if limit and len(out) >= limit:
                    break
        return out

    def rollback_above(self, version: int) -> None:
        """Discard every write with version > `version` (ref: the storage
        rollback after an epoch end — mutations above the recovery version
        never happened). O(keys) — recovery path, not the hot path."""
        dead: list[bytes] = []
        for key, c in self._chains.items():
            while c and c[-1][0] > version:
                c.pop()
            if not c:
                dead.append(key)
        for key in dead:
            del self._chains[key]
            self._trim.discard(key)
            i = bisect_left(self._keys, key)
            del self._keys[i]
        self.latest_version = min(self.latest_version, version)

    # -- window maintenance (ref: storageserver MVCC window + PTree
    #    forgetVersionsBefore) --
    def forget_before(self, version: int) -> None:
        if version <= self.oldest_version:
            return
        self.oldest_version = version
        dead: list[bytes] = []
        settled: list[bytes] = []
        for key in self._trim:
            c = self._chains[key]
            # keep the last entry <= version as the base, drop older
            i = 0
            while i + 1 < len(c) and c[i + 1][0] <= version:
                i += 1
            if i:
                del c[:i]
            if len(c) == 1 and c[0][1] is None and c[0][0] <= version:
                dead.append(key)
            elif len(c) == 1 and c[0][1] is not None:
                settled.append(key)  # one value: nothing left to trim
        self._trim.difference_update(settled)
        self._trim.difference_update(dead)
        for key in dead:
            del self._chains[key]
            i = bisect_left(self._keys, key)
            del self._keys[i]

    def entries(self) -> list[tuple[bytes, int, Optional[bytes]]]:
        """Canonical (key, version, value|None) rows, key- then version-
        ordered — the differential surface the device-resident engine's
        reconstruction must match bit-for-bit, and its compaction's
        rebuild source."""
        out: list[tuple[bytes, int, Optional[bytes]]] = []
        oldest, chains = self.oldest_version, self._chains
        for key in self._keys:
            c = chains.get(key)
            if not c:
                continue
            if len(c) == 1:
                # canonical_chain of one entry: kept unless a tombstone
                # at or below the horizon
                v, val = c[0]
                if val is not None or v > oldest:
                    out.append((key, v, val))
                continue
            out.extend(
                (key, v, val) for v, val in canonical_chain(c, oldest)
            )
        return out

    def __len__(self) -> int:
        return sum(
            1 for c in self._chains.values() if c and c[-1][1] is not None
        )
