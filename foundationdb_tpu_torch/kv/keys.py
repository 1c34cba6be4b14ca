"""Keys and key ranges.

The port's own copy of foundationdb_tpu.kv.keys (the port imports nothing
of the JAX package); the byte and buffer formats are identical.

Keys are arbitrary byte strings ordered lexicographically, exactly as in the
reference (fdbserver/SkipList.cpp:113-120 `compare`: memcmp then length).
Ranges are half-open [begin, end).
"""

from __future__ import annotations

from dataclasses import dataclass

def max_key_size() -> int:
    from ..core.knobs import CLIENT_KNOBS

    return CLIENT_KNOBS.KEY_SIZE_LIMIT


def key_after(key: bytes) -> bytes:
    """The first key strictly after `key` (ref: keyAfter = key + b'\\x00')."""
    return key + b"\x00"


def strinc(key: bytes) -> bytes:
    """The first key not prefixed by `key` (ref: flow strinc)."""
    key = key.rstrip(b"\xff")
    if not key:
        raise ValueError("strinc of empty or all-0xFF key")
    return key[:-1] + bytes([key[-1] + 1])


@dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open key range [begin, end). Empty iff begin >= end."""

    begin: bytes
    end: bytes

    def __post_init__(self):
        assert isinstance(self.begin, bytes) and isinstance(self.end, bytes)

    def is_empty(self) -> bool:
        return self.begin >= self.end

    def contains(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def intersects(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def intersection(self, other: "KeyRange") -> "KeyRange":
        return KeyRange(max(self.begin, other.begin), min(self.end, other.end))

    @staticmethod
    def single(key: bytes) -> "KeyRange":
        return KeyRange(key, key_after(key))


def empty_range() -> KeyRange:
    return KeyRange(b"", b"")


# Keyspace bounds (ref: allKeys/systemKeys, fdbclient/SystemData.cpp —
# normal keys live in [b"", b"\xff"), the system keyspace in
# [b"\xff", b"\xff\xff")).
ALL_KEYS = KeyRange(b"", b"\xff")
SYSTEM_KEYS = KeyRange(b"\xff", b"\xff\xff")
KEYSPACE_END = b"\xff\xff"
