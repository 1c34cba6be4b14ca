"""Order-preserving tuple encoding (ref: design/tuple.md — the cross-
binding spec; fdbclient/Tuple.cpp; bindings/python/fdb/tuple.py).

The defining property: pack(a) < pack(b) as byte strings iff a < b under
the tuple ordering (element-wise, by type rank then value). That is what
makes tuples usable as ordered keys: range reads over a prefix enumerate
tuples in semantic order.

Type codes (subset of the spec covering the types this framework's tests
and layers use):

    0x00        null
    0x01        byte string   (0x00 escaped as 0x00 0xFF, 0x00 terminator)
    0x02        unicode       (same escaping, UTF-8)
    0x05        nested tuple  (nulls inside escaped as 0x00 0xFF)
    0x0B/0x1D   negative/positive big integers (length-prefixed)
    0x0C..0x13  negative integers by byte length 8..1 (one's complement)
    0x14        integer zero
    0x15..0x1C  positive integers by byte length 1..8
    0x21        double (big-endian IEEE 754 with sign-fold transform)
    0x26/0x27   false/true
"""

from __future__ import annotations

import struct
from typing import Any, Iterable

NULL = 0x00
BYTES = 0x01
STRING = 0x02
NESTED = 0x05
NEG_INT_START = 0x0B
INT_ZERO = 0x14
POS_INT_END = 0x1D
DOUBLE = 0x21
FALSE = 0x26
TRUE = 0x27


def _find_terminator(b: bytes, pos: int) -> int:
    while True:
        i = b.index(b"\x00", pos)
        if i + 1 >= len(b) or b[i + 1] != 0xFF:
            return i
        pos = i + 2


def _encode(value: Any, nested: bool = False) -> bytes:
    if value is None:
        # Inside a nested tuple, null must not look like the terminator.
        return b"\x00\xff" if nested else b"\x00"
    if value is True:
        return bytes([TRUE])
    if value is False:
        return bytes([FALSE])
    if isinstance(value, bytes):
        return bytes([BYTES]) + value.replace(b"\x00", b"\x00\xff") + b"\x00"
    if isinstance(value, str):
        return (
            bytes([STRING])
            + value.encode("utf-8").replace(b"\x00", b"\x00\xff")
            + b"\x00"
        )
    if isinstance(value, int):
        return _encode_int(value)
    if isinstance(value, float):
        return bytes([DOUBLE]) + _encode_double(value)
    if isinstance(value, (tuple, list)):
        out = bytearray([NESTED])
        for item in value:
            out += _encode(item, nested=True)
        out.append(0x00)
        return bytes(out)
    raise TypeError(f"tuple layer cannot encode {type(value).__name__}")


def _encode_int(v: int) -> bytes:
    if v == 0:
        return bytes([INT_ZERO])
    if v > 0:
        n = (v.bit_length() + 7) // 8
        if n <= 8:
            return bytes([INT_ZERO + n]) + v.to_bytes(n, "big")
        # Arbitrary precision: length byte then magnitude.
        return bytes([POS_INT_END, n]) + v.to_bytes(n, "big")
    m = -v
    n = (m.bit_length() + 7) // 8
    ones = (1 << (8 * n)) - 1 - m  # one's complement keeps byte order
    if n <= 8:
        return bytes([INT_ZERO - n]) + ones.to_bytes(n, "big")
    return bytes([NEG_INT_START, n ^ 0xFF]) + ones.to_bytes(n, "big")


def _encode_double(v: float) -> bytes:
    raw = bytearray(struct.pack(">d", v))
    # Sign-fold: negatives get all bits flipped, positives the sign bit —
    # total order of the transformed bytes equals numeric order.
    if raw[0] & 0x80:
        for i in range(8):
            raw[i] ^= 0xFF
    else:
        raw[0] ^= 0x80
    return bytes(raw)


def _decode_double(b: bytes) -> float:
    raw = bytearray(b)
    if raw[0] & 0x80:
        raw[0] ^= 0x80
    else:
        for i in range(8):
            raw[i] ^= 0xFF
    return struct.unpack(">d", bytes(raw))[0]


def _decode(b: bytes, pos: int, nested: bool = False):
    code = b[pos]
    if code == NULL:
        if nested and pos + 1 < len(b) and b[pos + 1] == 0xFF:
            return None, pos + 2
        return None, pos + 1
    if code == BYTES or code == STRING:
        end = _find_terminator(b, pos + 1)
        raw = b[pos + 1 : end].replace(b"\x00\xff", b"\x00")
        return (raw if code == BYTES else raw.decode("utf-8")), end + 1
    if code == NESTED:
        out = []
        p = pos + 1
        while True:
            if b[p] == 0x00 and (p + 1 >= len(b) or b[p + 1] != 0xFF):
                return tuple(out), p + 1
            item, p = _decode(b, p, nested=True)
            out.append(item)
    if code == INT_ZERO:
        return 0, pos + 1
    if INT_ZERO < code <= INT_ZERO + 8:
        n = code - INT_ZERO
        return int.from_bytes(b[pos + 1 : pos + 1 + n], "big"), pos + 1 + n
    if INT_ZERO - 8 <= code < INT_ZERO:
        n = INT_ZERO - code
        ones = int.from_bytes(b[pos + 1 : pos + 1 + n], "big")
        return ones - ((1 << (8 * n)) - 1), pos + 1 + n
    if code == POS_INT_END:
        n = b[pos + 1]
        return int.from_bytes(b[pos + 2 : pos + 2 + n], "big"), pos + 2 + n
    if code == NEG_INT_START:
        n = b[pos + 1] ^ 0xFF
        ones = int.from_bytes(b[pos + 2 : pos + 2 + n], "big")
        return ones - ((1 << (8 * n)) - 1), pos + 2 + n
    if code == DOUBLE:
        return _decode_double(b[pos + 1 : pos + 9]), pos + 9
    if code == FALSE:
        return False, pos + 1
    if code == TRUE:
        return True, pos + 1
    raise ValueError(f"unknown tuple type code 0x{code:02x} at {pos}")


def pack(t: Iterable[Any]) -> bytes:
    out = bytearray()
    for item in t:
        out += _encode(item)
    return bytes(out)


def unpack(b: bytes) -> tuple:
    out = []
    pos = 0
    while pos < len(b):
        item, pos = _decode(b, pos)
        out.append(item)
    return tuple(out)


def range_of(t: Iterable[Any]) -> tuple[bytes, bytes]:
    """[begin, end) spanning every tuple that extends `t` (ref:
    fdb.tuple.range)."""
    p = pack(t)
    return p + b"\x00", p + b"\xff"
