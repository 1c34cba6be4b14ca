"""DiskQueue: durable FIFO on two alternating page-checksummed files.

Two interchangeable backends over ONE on-disk format (4 KiB pages:
magic | u64 seq | u32 len | u32 crc32c header, zero-padded payload, CRC
over the whole page with the crc field zeroed):

- native: the C++ implementation in native/diskqueue.cpp via ctypes — the
  framework's real fsync path, mirroring the reference's native DiskQueue
  (fdbserver/DiskQueue.actor.cpp:112).
- python: a pure-Python mirror (files written by one backend recover
  under the other), the backend of a simulated disk (`os_layer`).

The port's copy of foundationdb_tpu/storage_engine/diskqueue.py, with the
JAX package's backend choice: "python" under an os_layer, else native.
The native library is built from native/*.cpp at the first native queue
(storage_engine/_native.py), never at import, and a library that will not
build raises: the port never turns a native queue into the Python twin.
The Python twin's CRC is core/serialize.crc32c's table walk (the same
CRC32C as the JAX copy's bit loop and the C++ table).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

# Page size is knob-declared (set --knob_disk_queue_page_bytes before the
# first import to change the on-disk layout; existing files only recover
# under the page size they were written with — like the reference's
# _PAGE_SIZE, fdbserver/DiskQueue.actor.cpp:112).
from ..core.knobs import SERVER_KNOBS
from ..core.serialize import crc32c as _crc32c

PAGE_SIZE = int(SERVER_KNOBS.DISK_QUEUE_PAGE_BYTES)
MAGIC = 0x46445154
HEADER = struct.Struct("<IQII")  # magic, seq, len, crc
PAYLOAD_MAX = PAGE_SIZE - HEADER.size
SEGMENT_BUDGET = 1 << 20

_NATIVE = None


def _native():
    """The native library with the dq_* prototypes declared, built and
    loaded at the first call."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    from ._native import load as _load_shared

    lib = _load_shared()
    lib.dq_open.restype = ctypes.c_void_p
    lib.dq_open.argtypes = [ctypes.c_char_p]
    lib.dq_push.restype = ctypes.c_int
    lib.dq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.dq_commit.restype = ctypes.c_int
    lib.dq_commit.argtypes = [ctypes.c_void_p]
    lib.dq_pop.restype = None
    lib.dq_pop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.dq_next_seq.restype = ctypes.c_uint64
    lib.dq_next_seq.argtypes = [ctypes.c_void_p]
    lib.dq_recover_count.restype = ctypes.c_int
    lib.dq_recover_count.argtypes = [ctypes.c_void_p]
    lib.dq_record.restype = ctypes.c_uint64
    lib.dq_record.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.dq_close.restype = None
    lib.dq_close.argtypes = [ctypes.c_void_p]
    _NATIVE = lib
    return lib


class _PythonQueue:
    """Pure-Python twin of native/diskqueue.cpp (same format, same
    two-file reclamation contract)."""

    def __init__(self, path_prefix: str, os_layer=None):
        # The os-shaped seam: the real os module in production, the sim's
        # NonDurableOS under fault-injection tests (ref: IAsyncFile's
        # real/sim split, fdbrpc/AsyncFileNonDurable.actor.cpp).
        self._os = os_layer if os_layer is not None else os
        self.paths = [path_prefix + ".q0", path_prefix + ".q1"]
        self.fds = [
            self._os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
            for p in self.paths
        ]
        self.active = 0
        self.file_pages = [0, 0]
        self.min_seq = [None, None]
        self.max_seq = [None, None]
        self.next_seq = 0
        self.popped_seq = 0
        self.pending: list[tuple[int, bytes]] = []
        self.recovered: list[tuple[int, bytes]] = []
        self._recover()

    def _scan(self, which: int, out: list):
        size = self._os.fstat(self.fds[which]).st_size
        pages = size // PAGE_SIZE
        self.file_pages[which] = pages
        for i in range(pages):
            page = self._os.pread(self.fds[which], PAGE_SIZE, i * PAGE_SIZE)
            if len(page) != PAGE_SIZE:
                break
            magic, seq, ln, crc = HEADER.unpack_from(page)
            if magic != MAGIC or ln > PAYLOAD_MAX:
                self.file_pages[which] = i
                break
            zeroed = HEADER.pack(magic, seq, ln, 0) + page[HEADER.size:]
            if _crc32c(zeroed) != crc:
                self.file_pages[which] = i
                break
            out.append((seq, page[HEADER.size : HEADER.size + ln]))
            if self.min_seq[which] is None or seq < self.min_seq[which]:
                self.min_seq[which] = seq
            if self.max_seq[which] is None or seq > self.max_seq[which]:
                self.max_seq[which] = seq

    def _recover(self):
        all_recs: list[tuple[int, bytes]] = []
        self._scan(0, all_recs)
        self._scan(1, all_recs)
        all_recs.sort(key=lambda r: r[0])
        start = 0
        for i in range(1, len(all_recs)):
            if all_recs[i][0] != all_recs[i - 1][0] + 1:
                start = i
        self.recovered = all_recs[start:]
        if self.recovered:
            self.next_seq = self.recovered[-1][0] + 1
            self.popped_seq = self.recovered[0][0]
        if (self.max_seq[1] or -1) > (self.max_seq[0] or -1) and self.file_pages[1]:
            self.active = 1

    def _maybe_swap(self):
        other = 1 - self.active
        active_full = self.file_pages[self.active] * PAGE_SIZE >= SEGMENT_BUDGET
        other_free = self.file_pages[other] == 0 or (
            self.max_seq[other] is not None
            and self.max_seq[other] < self.popped_seq
        )
        if active_full and other_free:
            self._os.ftruncate(self.fds[other], 0)
            self.file_pages[other] = 0
            self.min_seq[other] = None
            self.max_seq[other] = None
            self.active = other

    def push(self, data: bytes) -> int:
        assert len(data) <= PAYLOAD_MAX
        seq = self.next_seq
        self.next_seq += 1
        self.pending.append((seq, data))
        return seq

    def commit(self):
        for seq, data in self.pending:
            self._maybe_swap()
            body = HEADER.pack(MAGIC, seq, len(data), 0) + data
            body += b"\x00" * (PAGE_SIZE - len(body))
            crc = _crc32c(body)
            page = HEADER.pack(MAGIC, seq, len(data), crc) + body[HEADER.size:]
            self._os.pwrite(
                self.fds[self.active], page,
                self.file_pages[self.active] * PAGE_SIZE,
            )
            which = self.active
            self.file_pages[which] += 1
            if self.min_seq[which] is None:
                self.min_seq[which] = seq
            self.max_seq[which] = seq
        self.pending.clear()
        for fd in self.fds:
            self._os.fsync(fd)

    def pop(self, upto_seq: int):
        self.popped_seq = max(self.popped_seq, upto_seq)
        self._maybe_swap()

    def close(self):
        for fd in self.fds:
            self._os.close(fd)


class _NativeQueue:
    def __init__(self, path_prefix: str):
        _native()
        self._q = _NATIVE.dq_open(path_prefix.encode())
        if not self._q:
            raise IOError(f"dq_open failed for {path_prefix}")
        n = _NATIVE.dq_recover_count(self._q)
        self.recovered = []
        for i in range(n):
            data_p = ctypes.c_void_p()
            ln = ctypes.c_uint32()
            seq = _NATIVE.dq_record(self._q, i, ctypes.byref(data_p), ctypes.byref(ln))
            self.recovered.append(
                (seq, ctypes.string_at(data_p, ln.value))
            )

    @property
    def next_seq(self) -> int:
        return _NATIVE.dq_next_seq(self._q)

    def push(self, data: bytes) -> int:
        seq = self.next_seq
        if _NATIVE.dq_push(self._q, data, len(data)) != 0:
            raise IOError("dq_push failed (record too large?)")
        return seq

    def commit(self):
        if _NATIVE.dq_commit(self._q) != 0:
            raise IOError("dq_commit failed")

    def pop(self, upto_seq: int):
        _NATIVE.dq_pop(self._q, upto_seq)

    def close(self):
        if self._q:
            _NATIVE.dq_close(self._q)
            self._q = None


class DiskQueue:
    """Public facade: the native backend, or the Python twin under an
    os_layer or when asked for by name.

    API contract (ref DiskQueue.actor.cpp): push() assigns a sequence and
    buffers; commit() makes everything pushed durable (fsync) — a record
    survives a crash iff its commit returned; pop(upto) releases records
    with seq STRICTLY BELOW upto for space reclamation (reclamation is
    two-file-coarse: space frees when a whole file's records are popped);
    .recovered holds the committed suffix found at open (possibly
    including popped-but-not-yet-truncated records — callers' recovery
    logic must be insensitive to that, as the memory engine's is).
    """

    PAYLOAD_MAX = PAYLOAD_MAX

    def __init__(self, path_prefix: str, backend: Optional[str] = None,
                 os_layer=None):
        if os_layer is not None:
            backend = "python"  # simulated disks run the Python twin
        if backend is None:
            backend = "native"
        if backend == "native":
            self._impl = _NativeQueue(path_prefix)
        elif backend == "python":
            self._impl = _PythonQueue(path_prefix, os_layer=os_layer)
        else:
            raise ValueError(f"unknown DiskQueue backend {backend!r}")
        self.backend = backend
        self.recovered: list[tuple[int, bytes]] = list(self._impl.recovered)

    def push(self, data: bytes) -> int:
        return self._impl.push(data)

    def commit(self) -> None:
        self._impl.commit()

    def pop(self, upto_seq: int) -> None:
        self._impl.pop(upto_seq)

    @property
    def next_seq(self) -> int:
        return self._impl.next_seq

    def close(self) -> None:
        self._impl.close()
