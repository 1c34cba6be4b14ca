"""ConflictSetNativeCPU: the C++ conflict detector on the host
(native/conflict_set.cpp, ctypes-bound), the in-repo stand-in for the
reference's SkipList and the CPU baseline the benchmark divides by.

The port's copy of foundationdb_tpu/resolver/native_cpu.py, over the
port's own flatten_batch and types. Same contract as ConflictSetCPU:
resolve(version, new_oldest_version, txns) -> ConflictBatchResult and
entries(); the differential tests hold it to the oracle bit for bit.
Recruited as CONFLICT_SET_IMPL="native" (factory.py). The library is
built with g++ into build/native/ at the first set
(storage_engine/_native.py load_host); a failed build raises.

The batch crosses the ABI as columnar numpy arrays and one key blob;
`resolve_columnar` takes them directly, so a caller that already has
columnar data skips the per-object Python work.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..storage_engine import _native
from .packing import flatten_batch
from .types import ConflictBatchResult, TxnConflictInfo

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def _pack_keys_blob(keys: Sequence[bytes]):
    """Concatenate keys into one blob + (offsets, lengths) arrays."""
    n = len(keys)
    lens = np.fromiter(map(len, keys), dtype=np.int32, count=n)
    offs = np.zeros(n, dtype=np.int64)
    if n:
        np.cumsum(lens[:-1], out=offs[1:])
    blob = np.frombuffer(b"".join(keys), dtype=np.uint8) if n else np.zeros(
        1, dtype=np.uint8
    )
    return blob, offs, lens


class ConflictSetNativeCPU:
    """Native-backed conflict set with the ConflictSetCPU contract."""

    max_key_bytes = None  # unlimited, like the oracle

    def __init__(self, init_version: int = 0):
        self._lib = _native.load_host()
        self._h = self._lib.fdbcs_create(init_version)
        self.oldest_version = 0

    def __del__(self):  # pragma: no cover - interpreter teardown order
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.fdbcs_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.fdbcs_entry_count(self._h))

    def entries(self) -> list[tuple[bytes, int]]:
        n = int(self._lib.fdbcs_entry_count(self._h))
        cap = int(self._lib.fdbcs_arena_size(self._h)) + 1
        buf = np.zeros(cap, dtype=np.uint8)
        offs = np.zeros(n, dtype=np.int64)
        lens = np.zeros(n, dtype=np.int32)
        vers = np.zeros(n, dtype=np.int64)
        got = int(self._lib.fdbcs_entries(
            self._h, _ptr(buf, _u8p), _ptr(offs, _i64p), _ptr(lens, _i32p),
            _ptr(vers, _i64p), n,
        ))
        raw = buf.tobytes()
        return [
            (raw[offs[i]: offs[i] + lens[i]], int(vers[i]))
            for i in range(got)
        ]

    def resolve(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        (_too_old, r_begin, r_end, r_txn, _r_snap, w_begin, w_end, w_txn) = (
            flatten_batch(txns, self.oldest_version)
        )
        snapshots = np.fromiter(
            (t.read_snapshot for t in txns), dtype=np.int64, count=len(txns)
        )
        has_reads = np.fromiter(
            (len(t.read_ranges) > 0 for t in txns),
            dtype=np.uint8, count=len(txns),
        )
        rb_blob, rb_off, rb_len = _pack_keys_blob(r_begin)
        re_blob, re_off, re_len = _pack_keys_blob(r_end)
        wb_blob, wb_off, wb_len = _pack_keys_blob(w_begin)
        we_blob, we_off, we_len = _pack_keys_blob(w_end)
        # One shared blob (offsets shifted per segment).
        blob = np.concatenate([rb_blob, re_blob, wb_blob, we_blob])
        re_off = re_off + rb_blob.size
        wb_off = wb_off + rb_blob.size + re_blob.size
        we_off = we_off + rb_blob.size + re_blob.size + wb_blob.size
        return self.resolve_columnar(
            version, new_oldest_version, len(txns), snapshots, has_reads,
            blob,
            np.asarray(r_txn, dtype=np.int32), rb_off, rb_len, re_off, re_len,
            np.asarray(w_txn, dtype=np.int32), wb_off, wb_len, we_off, we_len,
        )

    def resolve_columnar(
        self, version: int, new_oldest_version: int, n_txns: int,
        snapshots: np.ndarray, has_reads: np.ndarray, blob: np.ndarray,
        r_txn: np.ndarray, rb_off, rb_len, re_off, re_len,
        w_txn: np.ndarray, wb_off, wb_len, we_off, we_len,
    ) -> ConflictBatchResult:
        """Columnar fast path. Caller contract: rows are flattened in txn
        order; ranges of tooOld txns (snapshot < oldest and has_reads) and
        empty ranges are already dropped; all arrays C-contiguous of the
        dtypes used above."""
        statuses = np.zeros(n_txns, dtype=np.uint8)
        rc = self._lib.fdbcs_resolve(
            self._h, version, new_oldest_version, n_txns,
            _ptr(snapshots, _i64p), _ptr(has_reads, _u8p), _ptr(blob, _u8p),
            len(r_txn), _ptr(r_txn, _i32p),
            _ptr(np.ascontiguousarray(rb_off, np.int64), _i64p),
            _ptr(np.ascontiguousarray(rb_len, np.int32), _i32p),
            _ptr(np.ascontiguousarray(re_off, np.int64), _i64p),
            _ptr(np.ascontiguousarray(re_len, np.int32), _i32p),
            len(w_txn), _ptr(w_txn, _i32p),
            _ptr(np.ascontiguousarray(wb_off, np.int64), _i64p),
            _ptr(np.ascontiguousarray(wb_len, np.int32), _i32p),
            _ptr(np.ascontiguousarray(we_off, np.int64), _i64p),
            _ptr(np.ascontiguousarray(we_len, np.int32), _i32p),
            _ptr(statuses, _u8p),
        )
        if rc != 0:  # pragma: no cover - the ABI currently always returns 0
            raise RuntimeError(f"fdbcs_resolve failed rc={rc}")
        self.oldest_version = max(self.oldest_version, new_oldest_version)
        assert self.oldest_version == int(self._lib.fdbcs_oldest(self._h))
        return ConflictBatchResult([int(s) for s in statuses])
