"""An in-memory model database for differential workloads (ref:
fdbserver/workloads/MemoryKeyValueStore.h — the oracle WriteDuringRead
and friends diff the real cluster against).

Two layers: the committed store, and a transaction overlay that models
READ-YOUR-WRITES semantics (uncommitted writes visible to the same
transaction's reads, snapshot reads bypassing them) so every API
interleaving has a predicted answer."""

from __future__ import annotations

from bisect import bisect_left, insort
from typing import Optional

from ..kv.atomic import MutationType, apply_atomic


class MemoryKeyValueStore:
    """Ordered committed-state model (ref: MemoryKeyValueStore.h)."""

    def __init__(self):
        self._keys: list[bytes] = []
        self._map: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        keys = self._keys[i:j]
        if reverse:
            keys = keys[::-1]
        if limit:
            keys = keys[:limit]
        return [(k, self._map[k]) for k in keys]

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            insort(self._keys, key)
        self._map[key] = value

    def clear(self, key: bytes) -> None:
        if key in self._map:
            del self._map[key]
            del self._keys[bisect_left(self._keys, key)]

    def clear_range(self, begin: bytes, end: bytes) -> None:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        for k in self._keys[i:j]:
            del self._map[k]
        del self._keys[i:j]

    def snapshot(self) -> "MemoryKeyValueStore":
        out = MemoryKeyValueStore()
        out._keys = list(self._keys)
        out._map = dict(self._map)
        return out


class ModelTransaction:
    """RYW overlay over a committed-model snapshot: predicts what every
    read inside an in-flight transaction must return (ref: the workload's
    use of MemoryKeyValueStore to mirror transaction effects)."""

    def __init__(self, base: MemoryKeyValueStore):
        self.base = base          # committed state at the snapshot
        self.overlay = base.snapshot()  # base + this txn's writes
        self.mutations: list = []

    # -- writes mirror into the overlay --
    def set(self, key: bytes, value: bytes) -> None:
        self.overlay.set(key, value)
        self.mutations.append(("set", key, value))

    def clear(self, key: bytes) -> None:
        self.overlay.clear(key)
        self.mutations.append(("clear", key, key + b"\x00"))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self.overlay.clear_range(begin, end)
        self.mutations.append(("clear", begin, end))

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        new = apply_atomic(op, self.overlay.get(key), param)
        if new is None:
            self.overlay.clear(key)
        else:
            self.overlay.set(key, new)
        self.mutations.append(("atomic", op, key, param))

    # -- predicted reads. Snapshot reads SEE the transaction's own writes
    #    (fdb's SNAPSHOT_RYW_ENABLE default: snapshot only skips read-
    #    conflict registration, not RYW visibility) — the workload that
    #    drives this model caught exactly that distinction. --
    def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        return self.overlay.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False, snapshot: bool = False):
        return self.overlay.get_range(begin, end, limit, reverse)

    def commit_into(self, store: MemoryKeyValueStore) -> None:
        """Replay this transaction's mutations (atomics included) onto
        the committed model, in order — the commit-succeeded path."""
        for m in self.mutations:
            if m[0] == "set":
                store.set(m[1], m[2])
            elif m[0] == "clear":
                store.clear_range(m[1], m[2])
            else:  # ("atomic", op, key, param)
                _, op, key, param = m
                new = apply_atomic(op, store.get(key), param)
                if new is None:
                    store.clear(key)
                else:
                    store.set(key, new)
