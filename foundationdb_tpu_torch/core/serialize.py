"""Versioned binary serialization (ref: flow/serialize.h — BinaryWriter/
BinaryReader with IncludeVersion; fdbrpc/crc32c.cpp for the checksum).

The reference serializes every RPC message with a fixed byte-order-stable
layout plus a protocol version stamped at the head of each stream
(flow/serialize.h:195-210 IncludeVersion, :188 currentProtocolVersion);
incompatible peers are rejected at connect time. This module provides the
same three pieces, Python-native:

- `BinaryWriter` / `BinaryReader`: little-endian primitives + length-
  prefixed byte strings, with `write_protocol_version` /
  `check_protocol_version`;
- a self-describing value codec (`encode_value` / `decode_value`) covering
  the framework's message field types — ints, bytes, str, float, bool,
  None, list/tuple/dict, IntEnum, registered dataclasses, and FdbError —
  used by the transport to put whole request/reply dataclasses on the
  wire (the reference generates per-type serializers at compile time; a
  tagged codec is the idiomatic runtime-typed equivalent);
- `crc32c`: the Castagnoli CRC the reference frames every packet with
  (fdbrpc/FlowTransport.actor.cpp:463-523 scanPackets).

Messages register with `register_message`; a `reply` field (a Promise) is
never serialized — the transport replaces it with a reply endpoint token,
exactly the reference's networkSender arrangement (fdbrpc/fdbrpc.h:146).
"""

from __future__ import annotations

import dataclasses
import struct
from enum import IntEnum
from typing import Any

# Protocol version LATTICE: `current` is bumped on any wire-format
# change; `min_compatible` names the oldest revision this binary still
# reads (ref: currentProtocolVersion + minCompatibleProtocolVersion,
# flow/serialize.h:188-195 and ProtocolVersion.h). High bits spell the
# project; low byte is the revision. Rev 0002 added the format lattice
# itself (durable format stamps + the versioned ConnectPacket); rev 0001
# streams are still accepted.
PROTOCOL_VERSION = 0x0FDB_70_0002
MIN_COMPATIBLE_PROTOCOL_VERSION = 0x0FDB_70_0001


class FormatLattice:
    """A `current`/`min_compatible` version pair with stamp/check.

    Two instances govern the two format families:

    - WIRE_FORMAT: what `write_protocol_version` stamps at the head of
      every message/connection; readers accept same-major peers whose
      revision is at least `min_compatible` (a NEWER same-major peer is
      accepted — it promises read-compat down to its own min, exactly
      the reference's same-release compatibility window).
    - DURABLE_FORMAT: small-integer revision stamped into durable
      streams (DiskQueue record streams of the tlog and memory engine,
      snapshot containers). Readers accept [min_compatible, current]
      ONLY: a stamp NEWER than `current` is a downgrade and must refuse
      cleanly — an older binary cannot know a future layout.
    """

    __slots__ = ("kind", "current", "min_compatible")

    def __init__(self, kind: str, current: int, min_compatible: int):
        self.kind = kind
        self.current = current
        self.min_compatible = min_compatible

    def stamp(self) -> int:
        return self.current

    def check_durable(self, v: int, where: str = "") -> int:
        if not (self.min_compatible <= v <= self.current):
            from .errors import IncompatibleProtocolVersion

            raise IncompatibleProtocolVersion(
                f"{where or self.kind} format {v:#x} outside "
                f"[{self.min_compatible:#x}, {self.current:#x}] "
                + ("(written by a newer binary: refuse, do not corrupt)"
                   if v > self.current else "(older than min_compatible)")
            )
        return v

    def check_wire(self, v: int, where: str = "") -> int:
        # Same major wire revision (all but the low byte), and not older
        # than the compatibility floor. Newer same-major peers pass.
        if (v >> 8) != (self.current >> 8) or v < self.min_compatible:
            from .errors import IncompatibleProtocolVersion

            raise IncompatibleProtocolVersion(
                f"peer protocol {v:#x} vs local {self.current:#x} "
                f"(min compatible {self.min_compatible:#x})"
                + (f" at {where}" if where else "")
            )
        return v


WIRE_FORMAT = FormatLattice(
    "wire", PROTOCOL_VERSION, MIN_COMPATIBLE_PROTOCOL_VERSION
)
# Durable layout revision (small integer, stamped into record streams and
# container headers — the DiskQueue PAGE layout itself is versioned by
# its magic). Rev 1 = unstamped legacy streams; rev 2 = stamped streams.
DURABLE_FORMAT = FormatLattice("durable", 2, 1)


def durable_format_override(version: int):
    """Run with the durable lattice at `version` (min_compatible follows
    one revision back — readers accept version-N-1 layouts). Returns an
    undo callable; the upgrade restart runner applies this per phase so
    phase 2 can boot 'a newer binary' (or, for the downgrade-refusal
    spec, an older one) over phase 1's durable state."""
    saved = (DURABLE_FORMAT.current, DURABLE_FORMAT.min_compatible)
    DURABLE_FORMAT.current = version
    DURABLE_FORMAT.min_compatible = max(1, version - 1)

    def undo():
        DURABLE_FORMAT.current, DURABLE_FORMAT.min_compatible = saved

    return undo


# -- crc32c (Castagnoli, reflected poly 0x82F63B78) --

def _make_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-python table CRC32C, the oracle of the native one (ref:
    hardware crc32c, fdbrpc/crc32c.cpp)."""
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_CRC = None


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of `data` by the native slice-by-8 code (native.py, built
    at first use; a failed build raises), the value of _crc32c_py."""
    global _CRC
    if _CRC is None:
        from ..native import crc32c as native_crc32c

        _CRC = native_crc32c
    return _CRC(data, crc)


class BinaryWriter:
    __slots__ = ("_parts",)

    def __init__(self):
        self._parts: list[bytes] = []

    def write_protocol_version(self) -> "BinaryWriter":
        """The ONE place wire streams are stamped (the fdblint
        wire-raw-protocol-version rule keeps every format on this
        negotiated path)."""
        return self.u64(WIRE_FORMAT.stamp())

    def write_durable_format(self) -> "BinaryWriter":
        """Stamp a durable record stream with the current durable-layout
        revision (ref: IncludeVersion on persisted state)."""
        return self.u32(DURABLE_FORMAT.stamp())

    def raw(self, b: bytes) -> "BinaryWriter":
        self._parts.append(b)
        return self

    def u8(self, v: int) -> "BinaryWriter":
        return self.raw(struct.pack("<B", v))

    def u32(self, v: int) -> "BinaryWriter":
        return self.raw(struct.pack("<I", v))

    def i64(self, v: int) -> "BinaryWriter":
        return self.raw(struct.pack("<q", v))

    def u64(self, v: int) -> "BinaryWriter":
        return self.raw(struct.pack("<Q", v))

    def f64(self, v: float) -> "BinaryWriter":
        return self.raw(struct.pack("<d", v))

    def bytes_(self, b: bytes) -> "BinaryWriter":
        self.u32(len(b))
        return self.raw(b)

    def string(self, s: str) -> "BinaryWriter":
        return self.bytes_(s.encode("utf-8"))

    def to_bytes(self) -> bytes:
        return b"".join(self._parts)


def _protocol_mismatch_alias():
    from .errors import IncompatibleProtocolVersion

    return IncompatibleProtocolVersion


# Back-compat name: the bare exception this module used to raise is now
# the typed FdbError (code 1109) so the codec, the transport and status
# json all speak the same error.
ProtocolVersionMismatch = _protocol_mismatch_alias()


class BinaryReader:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes):
        self._buf = buf
        self._pos = 0

    def check_protocol_version(self) -> int:
        """(ref: IncludeVersion, flow/serialize.h:195-210). Lattice rule:
        same major wire revision AND at least MIN_COMPATIBLE — raises the
        typed IncompatibleProtocolVersion (1109) otherwise."""
        return WIRE_FORMAT.check_wire(self.u64())

    def check_durable_format(self, where: str = "") -> int:
        """Read + lattice-check a durable stream stamp: accepts
        [min_compatible, current]; refuses newer stamps cleanly (the
        downgrade-refusal contract — never decode a future layout)."""
        return DURABLE_FORMAT.check_durable(self.u32(), where)

    def raw(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise ValueError("serialized data truncated")
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self.raw(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.raw(8))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.raw(8))[0]

    def bytes_(self) -> bytes:
        return self.raw(self.u32())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def empty(self) -> bool:
        return self._pos >= len(self._buf)


# -- self-describing value codec --

_MESSAGES: dict[str, type] = {}


def register_message(cls: type) -> type:
    """Register a dataclass for wire transport (decorator-friendly)."""
    _MESSAGES[cls.__name__] = cls
    return cls


_T_NONE, _T_TRUE, _T_FALSE = 0, 1, 2
_T_INT, _T_BIGINT, _T_FLOAT = 3, 4, 5
_T_BYTES, _T_STR = 6, 7
_T_LIST, _T_TUPLE, _T_DICT = 8, 9, 10
_T_ENUM, _T_OBJ, _T_ERROR = 11, 12, 13


def _encode_value_py(w: BinaryWriter, v: Any) -> None:
    from .runtime import Promise  # local import: avoid cycle

    if v is None:
        w.u8(_T_NONE)
    elif v is True:
        w.u8(_T_TRUE)
    elif v is False:
        w.u8(_T_FALSE)
    elif isinstance(v, IntEnum):
        w.u8(_T_ENUM).string(type(v).__name__).i64(int(v))
    elif isinstance(v, int):
        if -(2**63) <= v < 2**63:
            w.u8(_T_INT).i64(v)
        else:
            w.u8(_T_BIGINT).string(str(v))
    elif isinstance(v, float):
        w.u8(_T_FLOAT).f64(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        w.u8(_T_BYTES).bytes_(bytes(v))
    elif isinstance(v, str):
        w.u8(_T_STR).string(v)
    elif isinstance(v, list):
        w.u8(_T_LIST).u32(len(v))
        for x in v:
            _encode_value_py(w, x)
    elif isinstance(v, tuple):
        w.u8(_T_TUPLE).u32(len(v))
        for x in v:
            _encode_value_py(w, x)
    elif isinstance(v, dict):
        w.u8(_T_DICT).u32(len(v))
        for k, x in v.items():
            _encode_value_py(w, k)
            _encode_value_py(w, x)
    elif isinstance(v, BaseException):
        from .errors import FdbError

        code = v.code if isinstance(v, FdbError) else 1500
        w.u8(_T_ERROR).u32(code).string(str(v))
    elif dataclasses.is_dataclass(v):
        name = type(v).__name__
        if name not in _MESSAGES:
            raise TypeError(f"dataclass {name} not register_message()'d")
        fields = [
            f for f in dataclasses.fields(v)
            if f.name != "reply" and not isinstance(
                getattr(v, f.name, None), Promise
            )
        ]
        w.u8(_T_OBJ).string(name).u32(len(fields))
        for f in fields:
            w.string(f.name)
            _encode_value_py(w, getattr(v, f.name))
    else:
        raise TypeError(f"cannot serialize {type(v).__name__}: {v!r}")


_ENUMS: dict[str, type] = {}


def register_enum(cls: type) -> type:
    _ENUMS[cls.__name__] = cls
    return cls


def _decode_value_py(r: BinaryReader) -> Any:
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.i64()
    if tag == _T_BIGINT:
        return int(r.string())
    if tag == _T_FLOAT:
        return r.f64()
    if tag == _T_BYTES:
        return r.bytes_()
    if tag == _T_STR:
        return r.string()
    if tag == _T_LIST:
        return [_decode_value_py(r) for _ in range(r.u32())]
    if tag == _T_TUPLE:
        return tuple(_decode_value_py(r) for _ in range(r.u32()))
    if tag == _T_DICT:
        return {_decode_value_py(r): _decode_value_py(r)
                for _ in range(r.u32())}
    if tag == _T_ENUM:
        name, val = r.string(), r.i64()
        cls = _ENUMS.get(name)
        return cls(val) if cls is not None else val
    if tag == _T_ERROR:
        from .errors import error_for_code

        code, msg = r.u32(), r.string()
        return error_for_code(code)(msg)
    if tag == _T_OBJ:
        name = r.string()
        cls = _MESSAGES.get(name)
        if cls is None:
            raise TypeError(f"unknown wire message {name!r}")
        kwargs = {}
        for _ in range(r.u32()):
            fname = r.string()
            kwargs[fname] = _decode_value_py(r)
        return cls(**kwargs)
    raise ValueError(f"bad wire tag {tag}")


# -- native envelope --
#
# fdbtpu_envelope (native/envelope.cpp, a CPython extension built by
# storage_engine/_native.py) walks the same tagged grammar in C, byte for
# byte the functions above: the Python pair stays as the differential
# oracle (tests/test_torch_serialize_native.py). Initialization is lazy
# because the extension needs the live registries plus Promise/FdbError,
# whose modules import this one; native.prepare() runs it ahead of the
# first message. A failed build raises: nothing falls back to Python.

_ENV = None
_ENV_INIT = False


def _env_init():
    global _ENV, _ENV_INIT
    from ..native import load_envelope
    from .errors import FdbError, error_for_code
    from .runtime import Promise

    mod = load_envelope()
    mod.setup(_MESSAGES, _ENUMS, Promise, FdbError, error_for_code, IntEnum)
    _ENV, _ENV_INIT = mod, True
    return mod


def encode_value(w: BinaryWriter, v: Any) -> None:
    env = _ENV if _ENV_INIT else _env_init()
    if env is not None:
        w.raw(env.encode_value(v))
    else:
        _encode_value_py(w, v)


def decode_value(r: BinaryReader) -> Any:
    env = _ENV if _ENV_INIT else _env_init()
    # The C decoder wants a contiguous bytes buffer; readers over
    # memoryviews or bytearrays stay on the Python path.
    if env is not None and type(r._buf) is bytes:
        obj, r._pos = env.decode_value(r._buf, r._pos)
        return obj
    return _decode_value_py(r)


def encode_message(v: Any) -> bytes:
    w = BinaryWriter()
    w.write_protocol_version()
    encode_value(w, v)
    return w.to_bytes()


def decode_message(buf: bytes) -> Any:
    r = BinaryReader(buf)
    r.check_protocol_version()
    return decode_value(r)
