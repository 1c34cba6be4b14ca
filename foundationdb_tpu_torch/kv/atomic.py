"""Atomic mutation operations (ref: fdbclient/CommitTransaction.h:31 mutation
types, apply logic in fdbclient/Atomic.h).

Each op combines an existing value (possibly absent) with a parameter and
yields the new value. Arithmetic is little-endian two's-complement over the
parameter's width, exactly like the reference (so bindings-level tests can
be ported 1:1 later).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Optional


class MutationType(IntEnum):
    # Values match the reference's MutationRef::Type order where shared
    # (fdbclient/CommitTransaction.h:31-44).
    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD_VALUE = 2
    AND = 6
    OR = 4
    XOR = 5
    APPEND_IF_FITS = 7
    MAX = 8
    MIN = 9
    BYTE_MIN = 12
    BYTE_MAX = 13
    # Substituted with (commit_version, batch_index) proxy-side before
    # resolution/logging (ref: SetVersionstampedKey/Value,
    # CommitTransaction.h:31; transformed in commitBatch phase 3).
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15


def _le_to_int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _int_to_le(x: int, width: int) -> bytes:
    return (x % (1 << (8 * width))).to_bytes(width, "little")


def _pad_to(b: bytes, width: int) -> bytes:
    return b[:width].ljust(width, b"\x00")


def apply_atomic(
    op: MutationType, existing: Optional[bytes], param: bytes,
    value_size_limit: int = 100_000,
) -> Optional[bytes]:
    """New value after applying `op` with `param` to `existing`.

    Width semantics follow the reference: the result width is the param's
    width; a shorter/absent existing value is zero-extended (fdbclient/
    Atomic.h doAdd/doAnd/...)."""
    if op == MutationType.SET_VALUE:
        return param
    w = len(param)
    old = _pad_to(existing or b"", w)
    if op == MutationType.ADD_VALUE:
        if existing is None:
            return param
        return _int_to_le(_le_to_int(old) + _le_to_int(param), w)
    if op == MutationType.AND:
        # doAndV2: absent operand behaves as zero-extended existing.
        if existing is None:
            return param
        return bytes(a & b for a, b in zip(old, param))
    if op == MutationType.OR:
        return bytes(a | b for a, b in zip(old, param))
    if op == MutationType.XOR:
        return bytes(a ^ b for a, b in zip(old, param))
    if op == MutationType.APPEND_IF_FITS:
        base = existing or b""
        if len(base) + len(param) <= value_size_limit:
            return base + param
        return base
    if op == MutationType.MAX:
        # doMaxV2: unsigned little-endian comparison at param width.
        if existing is None:
            return param
        return param if _le_to_int(param) > _le_to_int(old) else old
    if op == MutationType.MIN:
        if existing is None:
            return param
        return param if _le_to_int(param) < _le_to_int(old) else old
    if op == MutationType.BYTE_MIN:
        if existing is None:
            return param
        return min(existing, param)
    if op == MutationType.BYTE_MAX:
        if existing is None:
            return param
        return max(existing, param)
    raise ValueError(f"unknown atomic op {op}")


# -- versionstamps (ref: fdbclient/Atomic.h placeVersionstamp /
#    transformVersionstampMutation) --

VERSIONSTAMP_BYTES = 10  # 8-byte big-endian version + 2-byte batch index


def pack_versionstamp(version: int, batch_index: int) -> bytes:
    import struct

    return struct.pack(">QH", version, batch_index)


def place_versionstamp(param: bytes, stamp: bytes) -> bytes:
    """Splice `stamp` into `param` at the position named by its 4-byte
    little-endian offset suffix (the bindings' versionstamp convention,
    api version >= 520), returning param without the suffix."""
    import struct

    if len(param) < 4:
        raise ValueError("versionstamped parameter lacks offset suffix")
    (offset,) = struct.unpack("<I", param[-4:])
    body = param[:-4]
    if offset + VERSIONSTAMP_BYTES > len(body):
        raise ValueError(
            f"versionstamp offset {offset} out of range for {len(body)}-byte parameter"
        )
    return body[:offset] + stamp + body[offset + VERSIONSTAMP_BYTES:]


def transform_versionstamp_mutation(m, stamp: bytes):
    """SET_VERSIONSTAMPED_* -> plain SET_VALUE with the stamp spliced in
    (ref: the proxy's transformation before resolution/logging)."""
    if m.type == MutationType.SET_VERSIONSTAMPED_KEY:
        return type(m)(MutationType.SET_VALUE,
                       place_versionstamp(m.param1, stamp), m.param2)
    if m.type == MutationType.SET_VERSIONSTAMPED_VALUE:
        return type(m)(MutationType.SET_VALUE, m.param1,
                       place_versionstamp(m.param2, stamp))
    return m
