"""KeyValueStoreSSD: the "ssd" storage engine — a native copy-on-write
B+tree with checksummed pages (native/btree_kvs.cpp; role model
fdbserver/KeyValueStoreSQLite.actor.cpp, built fresh instead of vendoring
SQLite — see §2.6 of the survey).

Same IKeyValueStore-shaped surface as KeyValueStoreMemory: reads observe
uncommitted writes immediately; commit() makes everything durable (two
fsyncs: data pages, then the header flip). Crash anywhere leaves the
previous committed tree intact — verified by the kill-recover tests.

The port's copy of foundationdb_tpu/storage_engine/ssd_engine.py: the
native library is built from native/*.cpp at the first store
(storage_engine/_native.py), never at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ._native import load as _load_shared


_NATIVE: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The native library with the btree_* prototypes declared, built and
    loaded at the first call."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    lib = _load_shared()
    u32p = ctypes.POINTER(ctypes.c_uint32)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.btree_open.restype = ctypes.c_void_p
    lib.btree_open.argtypes = [ctypes.c_char_p]
    lib.btree_close.argtypes = [ctypes.c_void_p]
    lib.btree_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.btree_clear_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.btree_commit.restype = ctypes.c_int
    lib.btree_commit.argtypes = [ctypes.c_void_p]
    lib.btree_get.restype = ctypes.c_int
    lib.btree_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, vpp, u32p,
    ]
    lib.btree_read_range.restype = ctypes.c_void_p
    lib.btree_read_range.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.btree_range_next.restype = ctypes.c_int
    lib.btree_range_next.argtypes = [ctypes.c_void_p, vpp, u32p, vpp, u32p]
    lib.btree_range_close.argtypes = [ctypes.c_void_p]
    lib.btree_page_count.restype = ctypes.c_uint64
    lib.btree_page_count.argtypes = [ctypes.c_void_p]
    lib.btree_free_pages.restype = ctypes.c_uint64
    lib.btree_free_pages.argtypes = [ctypes.c_void_p]
    lib.btree_corrupt.restype = ctypes.c_int
    lib.btree_corrupt.argtypes = [ctypes.c_void_p]
    _NATIVE = lib
    return lib


class KeyValueStoreSSD:
    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.btree_open(path.encode())
        if not self._h:
            from ..core.errors import IoError

            raise IoError(f"btree_open({path}) failed")

    def _handle(self):
        if not self._h:
            from ..core.errors import IoError

            raise IoError("store is closed")
        return self._h

    def _check_corrupt(self) -> None:
        if self._lib.btree_corrupt(self._h):
            from ..core.errors import IoError

            raise IoError(
                "page checksum/structure failure (detected corruption)"
            )

    # -- IKeyValueStore-style API --
    def get(self, key: bytes) -> Optional[bytes]:
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint32()
        rc = self._lib.btree_get(
            self._handle(), key, len(key),
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc < 0:
            self._check_corrupt()
        if rc <= 0:
            return None
        return ctypes.string_at(out, out_len.value)

    def get_range(self, begin: bytes, end: bytes, limit: int = 0
                  ) -> list[tuple[bytes, bytes]]:
        rr = self._lib.btree_read_range(
            self._handle(), begin, len(begin), end, len(end), limit
        )
        out = []
        k = ctypes.c_void_p()
        klen = ctypes.c_uint32()
        v = ctypes.c_void_p()
        vlen = ctypes.c_uint32()
        try:
            while self._lib.btree_range_next(
                rr, ctypes.byref(k), ctypes.byref(klen),
                ctypes.byref(v), ctypes.byref(vlen),
            ):
                out.append((
                    ctypes.string_at(k, klen.value),
                    ctypes.string_at(v, vlen.value),
                ))
        finally:
            self._lib.btree_range_close(rr)
        self._check_corrupt()
        return out

    def set(self, key: bytes, value: bytes) -> None:
        self._lib.btree_set(self._handle(), key, len(key), value, len(value))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._lib.btree_clear_range(
            self._handle(), begin, len(begin), end, len(end)
        )

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key + b"\x00")

    def commit(self) -> None:
        if self._lib.btree_commit(self._handle()) != 0:
            from ..core.errors import IoError

            raise IoError("btree commit failed")

    def close(self) -> None:
        if self._h:
            self._lib.btree_close(self._h)
            self._h = None

    # -- diagnostics (springCleaning-style accounting) --
    def page_count(self) -> int:
        return self._lib.btree_page_count(self._handle())

    def free_pages(self) -> int:
        return self._lib.btree_free_pages(self._handle())
