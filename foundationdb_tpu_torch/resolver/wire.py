"""Columnar wire encoding of conflict batches + the vectorized packer.

The port's own copy of foundationdb_tpu.resolver.wire (the port imports nothing
of the JAX package); the byte and buffer formats are identical.

THE problem this file removes from the commit path: the legacy pack path
(packing.flatten_batch -> pack_keys) walks a 64K-transaction batch as
Python objects — ~120-150 ms of host time per batch, serialized behind
the resolver's version chain, which BENCH_r05 showed dominating the
device time of the batch-scaled kernel. The resolver's critical path must
never iterate transactions in Python.

The fix is the same one the reference applies to its commit path
(CommitTransactionRef rides flat serialized arenas end to end,
fdbclient/CommitTransaction.h): keep the batch COLUMNAR from the proxy
batcher onward. A WireBatch is a handful of numpy arrays —

    snaps      (T,)  int64   per-txn read snapshot
    r_counts   (T,)  int32   read ranges per txn
    w_counts   (T,)  int32   write ranges per txn
    rb/re/wb/we_off,_len     per-row offsets+lengths into `blob`
    blob       (B,)  uint8   every key's bytes, one concatenation

— built once at the proxy (or parsed zero-copy out of the RPC bytes via
np.frombuffer; `to_bytes`/`from_bytes` round-trip the columns with no
per-row work), and consumed by `pack_batch_wire`, which reproduces
packing.pack_batch BIT FOR BIT without ever materializing a
TxnConflictInfo: key words gather straight out of the blob with one
masked fancy-index per endpoint group, admission (tooOld txns shed their
ranges, empty ranges drop) happens as boolean masks over the packed
words (packing is order-preserving, so the packed-tuple compare IS the
byte compare), and the shared packing._pack_rows tail does the rest.
The legacy object path stays as the differential oracle
(tests/test_wire_packing.py packs every batch both ways).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .packing import KeyWidthError, StickyCaps, _pack_rows, pack_keys
from .types import TxnConflictInfo

_MAGIC = 0xFDB7_B47C
_VERSION = 1
_HEADER = struct.Struct("<IHHQQQ")  # magic, version, pad, n_txns, nr, nw


def _key_columns(keys: list) -> tuple[np.ndarray, bytes]:
    lens = np.fromiter(map(len, keys), dtype=np.int32, count=len(keys))
    return lens, b"".join(keys)


def pack_debug_column(dbg) -> bytes:
    """Sparse per-row debug-ID column (flight recorder): rows carrying a
    sampled transaction's ID encode as (count, int32 row indices, int32
    id lengths, ascii id blob). Empty -> b"", so unsampled batches add
    ZERO wire bytes — the column is a trailer after the key blob, whose
    length both formats re-derive from their length columns."""
    dbg = tuple(dbg or ())
    if not dbg:
        return b""
    ids = [str(d).encode("ascii") for _, d in dbg]
    idx = np.fromiter((i for i, _ in dbg), np.int32, count=len(dbg))
    lens = np.fromiter(map(len, ids), np.int32, count=len(ids))
    return b"".join([
        struct.pack("<I", len(dbg)), idx.tobytes(), lens.tobytes(),
        b"".join(ids),
    ])


def unpack_debug_column(data: bytes, offset: int = 0) -> tuple:
    """Inverse of pack_debug_column; ((row, id), ...) — empty input (an
    unsampled batch, or a peer that did not append the trailer) decodes
    to ()."""
    if offset >= len(data):
        return ()
    (n,) = struct.unpack_from("<I", data, offset)
    at = offset + 4
    idx = np.frombuffer(data, np.int32, n, at); at += 4 * n
    lens = np.frombuffer(data, np.int32, n, at); at += 4 * n
    out = []
    for i in range(n):
        ln = int(lens[i])
        out.append((int(idx[i]), data[at: at + ln].decode("ascii")))
        at += ln
    return tuple(out)


@dataclass
class WireBatch:
    """One conflict batch as columns (see module docstring). Offsets are
    absolute into `blob`; rows appear in txn order within each of the four
    endpoint groups (read begins, read ends, write begins, write ends)."""

    n_txns: int
    snaps: np.ndarray      # (T,)  int64
    r_counts: np.ndarray   # (T,)  int32
    w_counts: np.ndarray   # (T,)  int32
    rb_off: np.ndarray     # (nr,) int64
    rb_len: np.ndarray     # (nr,) int32
    re_off: np.ndarray
    re_len: np.ndarray
    wb_off: np.ndarray     # (nw,) int64
    wb_len: np.ndarray
    we_off: np.ndarray
    we_len: np.ndarray
    blob: np.ndarray       # (B,)  uint8
    # Flight recorder: sparse ((txn_row, debug_id), ...) of the sampled
    # transactions in this batch (empty for unsampled batches; never
    # touches the packing fast path).
    dbg: tuple = ()

    # -- construction --

    @classmethod
    def from_txns(cls, txns: Sequence[TxnConflictInfo],
                  debug_ids=()) -> "WireBatch":
        """Columnarize transaction objects (the proxy-side encoder; one
        linear pass, OFF the resolver's serialized commit path — many
        proxies columnarize concurrently, one resolver packs)."""
        n = len(txns)
        snaps = np.fromiter(
            (t.read_snapshot for t in txns), dtype=np.int64, count=n
        )
        r_counts = np.fromiter(
            (len(t.read_ranges) for t in txns), dtype=np.int32, count=n
        )
        w_counts = np.fromiter(
            (len(t.write_ranges) for t in txns), dtype=np.int32, count=n
        )
        rb = [r.begin for t in txns for r in t.read_ranges]
        re_ = [r.end for t in txns for r in t.read_ranges]
        wb = [w.begin for t in txns for w in t.write_ranges]
        we = [w.end for t in txns for w in t.write_ranges]
        lens, blobs = zip(*(_key_columns(k) for k in (rb, re_, wb, we)))
        sizes = np.array([int(l.sum()) for l in lens], dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(sizes)])
        offs = [
            base[i] + np.concatenate([[0], np.cumsum(lens[i][:-1])]).astype(
                np.int64
            )
            if len(lens[i]) else np.zeros(0, dtype=np.int64)
            for i in range(4)
        ]
        blob = np.frombuffer(b"".join(blobs), dtype=np.uint8)
        return cls(
            n_txns=n, snaps=snaps, r_counts=r_counts, w_counts=w_counts,
            rb_off=offs[0], rb_len=lens[0], re_off=offs[1], re_len=lens[1],
            wb_off=offs[2], wb_len=lens[2], we_off=offs[3], we_len=lens[3],
            blob=blob, dbg=tuple(debug_ids or ()),
        )

    # -- wire round trip --

    def to_bytes(self) -> bytes:
        """Serialize as one buffer: fixed header, the per-txn and per-row
        int columns, then the key blob re-packed into the canonical group
        order (rb ++ re ++ wb ++ we, row-major) so offsets need not ship —
        from_bytes re-derives them with two cumsums."""
        nr, nw = len(self.rb_len), len(self.wb_len)
        parts = [
            _HEADER.pack(_MAGIC, _VERSION, 0, self.n_txns, nr, nw),
            np.ascontiguousarray(self.snaps, dtype=np.int64).tobytes(),
            np.ascontiguousarray(self.r_counts, dtype=np.int32).tobytes(),
            np.ascontiguousarray(self.w_counts, dtype=np.int32).tobytes(),
        ]
        blob_parts = []
        for off, ln in ((self.rb_off, self.rb_len), (self.re_off, self.re_len),
                        (self.wb_off, self.wb_len), (self.we_off, self.we_len)):
            parts.append(
                np.ascontiguousarray(ln, dtype=np.int32).tobytes()
            )
            blob_parts.append(_gather_blob(self.blob, off, ln))
        parts.extend(blob_parts)
        # Sparse debug column rides AFTER the key blob (whose length
        # from_bytes re-derives from the length columns); unsampled
        # batches append nothing.
        parts.append(pack_debug_column(self.dbg))
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "WireBatch":
        """Zero-copy parse: every column is an np.frombuffer view on the
        RPC payload; no per-transaction Python work."""
        magic, version, _, n, nr, nw = _HEADER.unpack_from(data, 0)
        if magic != _MAGIC or version != _VERSION:
            raise ValueError("not a WireBatch payload")
        at = _HEADER.size
        def take(count, dtype):
            nonlocal at
            arr = np.frombuffer(data, dtype=dtype, count=count, offset=at)
            at += arr.nbytes
            return arr
        snaps = take(n, np.int64)
        r_counts = take(n, np.int32)
        w_counts = take(n, np.int32)
        rb_len = take(nr, np.int32)
        re_len = take(nr, np.int32)
        wb_len = take(nw, np.int32)
        we_len = take(nw, np.int32)
        lens = (rb_len, re_len, wb_len, we_len)
        sizes = np.array([int(l.sum()) for l in lens], dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(sizes)])
        offs = [
            base[i] + np.concatenate([[0], np.cumsum(lens[i][:-1])]).astype(
                np.int64
            )
            if len(lens[i]) else np.zeros(0, dtype=np.int64)
            for i in range(4)
        ]
        blob = np.frombuffer(data, dtype=np.uint8, count=int(sizes.sum()),
                             offset=at)
        dbg = unpack_debug_column(data, at + int(sizes.sum()))
        return cls(
            n_txns=n, snaps=snaps, r_counts=r_counts, w_counts=w_counts,
            rb_off=offs[0], rb_len=rb_len, re_off=offs[1], re_len=re_len,
            wb_off=offs[2], wb_len=wb_len, we_off=offs[3], we_len=we_len,
            blob=blob, dbg=dbg,
        )

    # -- views --

    def total_ranges(self) -> int:
        return int(self.r_counts.sum() + self.w_counts.sum())

    def slice(self, lo: int, hi: int) -> "WireBatch":
        """Txn subrange [lo, hi) as a view (chunking): per-row columns are
        sliced by the groups' row prefix sums; the blob is shared (offsets
        are absolute)."""
        r_pre = np.concatenate([[0], np.cumsum(self.r_counts)])
        w_pre = np.concatenate([[0], np.cumsum(self.w_counts)])
        r0, r1 = int(r_pre[lo]), int(r_pre[hi])
        w0, w1 = int(w_pre[lo]), int(w_pre[hi])
        return WireBatch(
            n_txns=hi - lo, snaps=self.snaps[lo:hi],
            r_counts=self.r_counts[lo:hi], w_counts=self.w_counts[lo:hi],
            rb_off=self.rb_off[r0:r1], rb_len=self.rb_len[r0:r1],
            re_off=self.re_off[r0:r1], re_len=self.re_len[r0:r1],
            wb_off=self.wb_off[w0:w1], wb_len=self.wb_len[w0:w1],
            we_off=self.we_off[w0:w1], we_len=self.we_len[w0:w1],
            blob=self.blob,
            dbg=tuple((i - lo, d) for i, d in self.dbg if lo <= i < hi),
        )

    def to_txns(self) -> list[TxnConflictInfo]:
        """Decode back into objects (the oracle/native backends' path —
        they take object batches; the TPU path never calls this). The
        columns are read as Python lists once: indexing numpy arrays
        element by element costs several times as much."""
        from ..kv.keys import KeyRange

        tob = self.blob.tobytes()

        def keys(off, lens):
            return [tob[o:o + n] for o, n in zip(off.tolist(), lens.tolist())]

        rb, re_ = keys(self.rb_off, self.rb_len), keys(self.re_off, self.re_len)
        wb, we = keys(self.wb_off, self.wb_len), keys(self.we_off, self.we_len)
        out = []
        r_at = w_at = 0
        for snap, nrr, nww in zip(self.snaps[: self.n_txns].tolist(),
                                  self.r_counts[: self.n_txns].tolist(),
                                  self.w_counts[: self.n_txns].tolist()):
            rr = [KeyRange(rb[j], re_[j]) for j in range(r_at, r_at + nrr)]
            wr = [KeyRange(wb[j], we[j]) for j in range(w_at, w_at + nww)]
            out.append(TxnConflictInfo(snap, rr, wr))
            r_at += nrr
            w_at += nww
        return out

    def max_key_len(self) -> int:
        """Longest key of any row of a non-tooOld-able txn — the width
        admission bound (conservative vs the object path: rows of empty
        ranges count too, which can only widen earlier, never pack
        differently at a given width)."""
        m = 0
        for l in (self.rb_len, self.re_len, self.wb_len, self.we_len):
            if len(l):
                m = max(m, int(l.max()))
        return m


def _gather_blob(blob: np.ndarray, off: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate rows blob[off_i : off_i+len_i] without a Python loop:
    one repeat + cumsum index construction, one fancy gather."""
    if len(lens) == 0:
        return b""
    total = int(lens.astype(np.int64).sum())
    # index k of the output maps to off[row(k)] + (k - start[row(k)])
    starts = np.concatenate([[0], np.cumsum(lens.astype(np.int64)[:-1])])
    row = np.repeat(np.arange(len(lens)), lens)
    k = np.arange(total, dtype=np.int64)
    return blob[off[row] + (k - starts[row])].tobytes()


def _pack_rows_from_blob(
    blob: np.ndarray, off: np.ndarray, lens: np.ndarray, n_words: int
) -> np.ndarray:
    """Packed biased-int32 big-endian words of each row's key, gathered
    straight from the blob (the wire twin of packing.pack_keys): ONE
    clipped fancy gather builds the (N, 4*n_words) byte image — rows
    shorter than the width read garbage past their end and a uint8 mask
    multiply zeroes it (measured ~3x cheaper than the boolean fancy-index
    on both sides, which extracts twice) — then the same view/bias dance
    as pack_keys."""
    from .packing import BIAS

    width = 4 * n_words
    n = len(lens)
    if n and int(lens.max()) > width:
        raise KeyWidthError(
            f"key of {int(lens.max())} bytes exceeds packed width {width}"
        )
    if (n and int(lens.min()) == width
            and bool((off[1:] - off[:-1] == width).all())):
        # Fixed-width contiguous rows (the canonical wire layout with
        # uniform keys — point-write commit planes are exactly this):
        # the byte image IS a blob slice, no gather at all.
        buf = blob[int(off[0]) : int(off[0]) + n * width].reshape(n, width)
    elif n:
        # int32 gather indices when the blob allows it (half the index
        # bytes the gather streams).
        odt = np.int32 if len(blob) < 2**31 - width else np.int64
        cols = np.arange(width, dtype=odt)[None, :]
        idx = off.astype(odt)[:, None] + cols
        np.clip(idx, 0, max(len(blob) - 1, 0), out=idx)
        buf = blob[idx] if len(blob) else np.zeros((n, width), np.uint8)
        buf *= cols < lens.astype(odt)[:, None]
    else:
        buf = np.zeros((n, width), dtype=np.uint8)
    words = (
        buf.reshape(n, n_words, 4).view(">u4")[..., 0].astype(np.uint32)
        ^ BIAS
    ).view(np.int32)
    return words


def _lex_lt(aw: np.ndarray, al: np.ndarray,
            bw: np.ndarray, bl: np.ndarray) -> np.ndarray:
    """(a_words, a_len) < (b_words, b_len) per row — equals byte order of
    the underlying keys (packing is order-preserving at admitted widths)."""
    # Decided at the first differing word: word j counts while every
    # word before it is equal (a fixed number of passes at any width).
    same = aw == bw
    before = np.concatenate(
        [np.ones((len(al), 1), dtype=bool),
         np.logical_and.accumulate(same, axis=1)], axis=1)[:, :-1]
    lt = ((aw < bw) & before).any(axis=1)
    return lt | (same.all(axis=1) & (al < bl))


def pack_batch_wire(
    wb: WireBatch,
    oldest_version: int,
    n_words: int,
    caps: tuple | None = None,
):
    """Vectorized twin of packing.pack_batch: WireBatch -> PackedBatch,
    bit-identical to packing the decoded objects (same admission rules,
    same row order, same _pack_rows tail). No per-transaction Python."""
    n = wb.n_txns
    too_old = (wb.snaps < oldest_version) & (wb.r_counts > 0)

    # Row -> txn maps; admission masks (tooOld txns shed every range,
    # empty ranges drop — flatten_batch's rules, as boolean masks).
    r_txn_all = np.repeat(
        np.arange(n, dtype=np.int64), wb.r_counts.astype(np.int64)
    )
    w_txn_all = np.repeat(
        np.arange(n, dtype=np.int64), wb.w_counts.astype(np.int64)
    )
    rb_w = _pack_rows_from_blob(wb.blob, wb.rb_off, wb.rb_len, n_words)
    re_w = _pack_rows_from_blob(wb.blob, wb.re_off, wb.re_len, n_words)
    wb_w = _pack_rows_from_blob(wb.blob, wb.wb_off, wb.wb_len, n_words)
    we_w = _pack_rows_from_blob(wb.blob, wb.we_off, wb.we_len, n_words)
    keep_r = (
        ~too_old[r_txn_all]
        & _lex_lt(rb_w, wb.rb_len, re_w, wb.re_len)
    )
    keep_w = (
        ~too_old[w_txn_all]
        & _lex_lt(wb_w, wb.wb_len, we_w, wb.we_len)
    )
    r_txn = r_txn_all[keep_r]
    w_txn = w_txn_all[keep_w]
    nr, nw = len(r_txn), len(w_txn)

    # The shared tail consumes the live rows' keys in the fixed
    # concatenation order r_end ++ w_end ++ w_begin ++ r_begin.
    words = np.concatenate(
        [re_w[keep_r], we_w[keep_w], wb_w[keep_w], rb_w[keep_r]]
    )
    lens = np.concatenate(
        [wb.re_len[keep_r], wb.we_len[keep_w],
         wb.wb_len[keep_w], wb.rb_len[keep_r]]
    ).astype(np.int32)
    return _pack_rows(
        words, lens, nr, nw, r_txn, w_txn,
        wb.snaps, too_old, n, oldest_version, n_words, caps,
    )


def pack_wire(
    wb: WireBatch, oldest_version: int, n_words: int, sticky: StickyCaps
):
    """pack_batch_wire under the sticky shape caps (the ConflictSetGPU.pack
    twin for wire batches)."""
    pb = pack_batch_wire(
        wb, oldest_version, n_words, caps=sticky.caps_for(wb.n_txns)
    )
    sticky.update(pb)
    return pb


def chunk_bounds(wb: WireBatch, max_txns: int, max_ranges: int) -> list[int]:
    """Txn split points honoring the chunk caps (the wire twin of
    ConflictSetGPU._chunks): O(#chunks) searchsorted hops, never a
    per-transaction scan. A single over-cap transaction still forms its
    own chunk, exactly like the object path."""
    n = wb.n_txns
    if n == 0:
        return [0]
    ranges = (wb.r_counts + wb.w_counts).astype(np.int64)
    pre = np.concatenate([[0], np.cumsum(ranges)])
    bounds = [0]
    at = 0
    while at < n:
        hi = min(at + max_txns, n)
        cut = int(np.searchsorted(pre, pre[at] + max_ranges, side="right")) - 1
        hi = min(hi, max(cut, at + 1))
        bounds.append(hi)
        at = hi
    return bounds


__all__ = [
    "WireBatch",
    "pack_batch_wire",
    "pack_wire",
    "chunk_bounds",
    "pack_keys",
    "pack_debug_column",
    "unpack_debug_column",
]
