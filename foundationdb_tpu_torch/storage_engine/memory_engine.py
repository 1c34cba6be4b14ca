"""KeyValueStoreMemory: ordered in-memory map, durable via op-log +
snapshot on the DiskQueue (ref: fdbserver/KeyValueStoreMemory.actor.cpp —
op records OpSet/OpClear/OpSnapshot* :258-263, recovery replay :344-375).

Write path: set/clear/clear_range append ops in memory; commit() logs them
to the disk queue and fsyncs — after commit returns, the state survives a
crash. A snapshot (full ordered dump) is written every SNAPSHOT_OP_BYTES
of logged ops so recovery replay and queue length stay bounded; the log
prefix before the last COMPLETE snapshot is popped off the queue.

Recovery: scan the queue (DiskQueue recovers the committed suffix), find
the last complete snapshot, rebuild the map from it, then replay every op
after it. A crash mid-snapshot is safe: the snapshot is only trusted once
its END record is seen, and ops keep replaying from the previous one.

The port's copy of foundationdb_tpu/storage_engine/memory_engine.py.
"""

from __future__ import annotations

import struct
from bisect import bisect_left, insort
from typing import Optional

from .diskqueue import DiskQueue

OP_SET = 1
OP_CLEAR_RANGE = 2
OP_SNAP_START = 3
OP_SNAP_ITEM = 4
OP_SNAP_END = 5
# Durable-format stamp (core/serialize.DURABLE_FORMAT lattice): written
# at open and re-written after every snapshot (so the pop of the log
# prefix never erases it). Recovery lattice-checks every stamp; an
# unstamped stream is revision 1; a stamp newer than `current` refuses
# with IncompatibleProtocolVersion before the map is rebuilt.
OP_FORMAT = 6

_REC = struct.Struct("<BII")  # op, len1, len2

SNAPSHOT_OP_BYTES = 1 << 18


def _rec(op: int, a: bytes = b"", b: bytes = b"") -> bytes:
    return _REC.pack(op, len(a), len(b)) + a + b


def _unrec(data: bytes) -> tuple[int, bytes, bytes]:
    op, l1, l2 = _REC.unpack_from(data)
    a = data[_REC.size : _REC.size + l1]
    b = data[_REC.size + l1 : _REC.size + l1 + l2]
    return op, a, b


class KeyValueStoreMemory:
    def __init__(self, path_prefix: str, backend: Optional[str] = None,
                 os_layer=None):
        self.queue = DiskQueue(path_prefix, backend=backend,
                               os_layer=os_layer)
        self._keys: list[bytes] = []
        self._map: dict[bytes, bytes] = {}
        self._bytes_since_snapshot = 0
        self.format_version = 1
        self._recover()
        self._stamp_format()

    # -- IKeyValueStore-style API --
    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def get_range(
        self, begin: bytes, end: bytes, limit: int = 0
    ) -> list[tuple[bytes, bytes]]:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        keys = self._keys[i:j]
        if limit:
            keys = keys[:limit]
        return [(k, self._map[k]) for k in keys]

    def set(self, key: bytes, value: bytes) -> None:
        self._apply_set(key, value)
        self._log(_rec(OP_SET, key, value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._apply_clear_range(begin, end)
        self._log(_rec(OP_CLEAR_RANGE, begin, end))

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key + b"\x00")

    def commit(self) -> None:
        """Make everything logged so far durable (ref: the engine's commit
        = DiskQueue commit + fsync)."""
        self.queue.commit()
        if self._bytes_since_snapshot >= SNAPSHOT_OP_BYTES:
            self._write_snapshot()

    def close(self) -> None:
        self.queue.close()

    def __len__(self) -> int:
        return len(self._keys)

    # -- internals --
    def _apply_set(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            insort(self._keys, key)
        self._map[key] = value

    def _apply_clear_range(self, begin: bytes, end: bytes) -> None:
        i = bisect_left(self._keys, begin)
        j = bisect_left(self._keys, end)
        for k in self._keys[i:j]:
            del self._map[k]
        del self._keys[i:j]

    def _log(self, rec: bytes) -> None:
        self.queue.push(rec)
        self._bytes_since_snapshot += len(rec)

    def _stamp_format(self) -> None:
        from ..core.serialize import DURABLE_FORMAT

        if self.format_version != DURABLE_FORMAT.current:
            self._log(_rec(OP_FORMAT,
                           struct.pack("<I", DURABLE_FORMAT.stamp())))
            self.format_version = DURABLE_FORMAT.current

    def _write_snapshot(self) -> None:
        """Dump the full map between SNAP_START/END markers, commit, then
        pop the log prefix that the snapshot supersedes."""
        start_seq = self.queue.push(_rec(OP_SNAP_START))
        for k in self._keys:
            self.queue.push(_rec(OP_SNAP_ITEM, k, self._map[k]))
        self.queue.push(_rec(OP_SNAP_END))
        # Re-stamp AFTER the snapshot: the pop below releases the log
        # prefix that held the open-time stamp.
        from ..core.serialize import DURABLE_FORMAT

        self.queue.push(_rec(OP_FORMAT,
                             struct.pack("<I", DURABLE_FORMAT.stamp())))
        self.queue.commit()
        # Everything strictly before the snapshot start is superseded.
        self.queue.pop(start_seq)
        self._bytes_since_snapshot = 0

    def _recover(self) -> None:
        from ..core.serialize import DURABLE_FORMAT

        records = self.queue.recovered
        # Lattice-check every format stamp FIRST: refusal must precede
        # any rebuild (and an unstamped non-empty stream is revision 1).
        stamped = False
        for _seq, data in records:
            op, a, _ = _unrec(data)
            if op == OP_FORMAT:
                stamped = True
                self.format_version = DURABLE_FORMAT.check_durable(
                    struct.unpack("<I", a)[0], "memory engine log"
                )
        if records and not stamped:
            DURABLE_FORMAT.check_durable(1, "memory engine log")
        # Find the last COMPLETE snapshot (START..END with no gap).
        last_start = None
        last_complete = None
        for idx, (_seq, data) in enumerate(records):
            op, _, _ = _unrec(data)
            if op == OP_SNAP_START:
                last_start = idx
            elif op == OP_SNAP_END and last_start is not None:
                last_complete = (last_start, idx)
        replay_from = 0
        if last_complete is not None:
            s, e = last_complete
            for _seq, data in records[s + 1 : e]:
                op, k, v = _unrec(data)
                assert op == OP_SNAP_ITEM
                self._apply_set(k, v)
            replay_from = e + 1
        for _seq, data in records[replay_from:]:
            op, a, b = _unrec(data)
            if op == OP_SET:
                self._apply_set(a, b)
            elif op == OP_CLEAR_RANGE:
                self._apply_clear_range(a, b)
            # snapshot records inside the replay tail (an INCOMPLETE
            # trailing snapshot) are ignored: ops are logged alongside and
            # already cover them.
