"""Native helpers of the wire path: `crc32c`, the slice-by-8 C version of
the Castagnoli CRC that frames every packet (native/crc32c.cpp, the same
value as core/serialize.py's table walk), and `load_envelope()`, the
CPython-extension codec of the self-describing message envelope
(native/envelope.cpp, byte for byte the Python encode_value/decode_value
of core/serialize.py).

The port's counterpart of foundationdb_tpu/native.py. Both come from
storage_engine/_native.py, which compiles them with g++ into build/native/
at first use; nothing is built at import. A failed build raises with
g++'s stderr: nothing falls back to the Python versions, which stay as
the differential oracle of the tests.
"""

from __future__ import annotations

from .storage_engine import _native

_crc = None


def crc32c(data: bytes, crc: int = 0) -> int:
    global _crc
    if _crc is None:
        _crc = _native.load_host().fdbtpu_crc32c
    return _crc(data, len(data), crc)


def load_envelope():
    """The fdbtpu_envelope module (the port's own file), built if needed."""
    return _native.load_envelope()


def prepare() -> None:
    """Build and load the native wire path before anything serializes: a
    first encode that ran g++ (seconds) inside a role host's RPC would
    outlast the controller's health probe. Builds the host tier and the
    envelope side by side, then sets the envelope's registries up."""
    from .core import serialize

    _native.build_host_tier()
    crc32c(b"")
    serialize._env_init()
