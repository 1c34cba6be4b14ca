"""Columnar wire encoding of client commit batches.

The commit-plane twin of resolver/wire.py: where PR 7 made the
proxy->resolver hop ship ONE columnar buffer instead of N pickled txn
objects, this module does the same for the client->txn-host
CommitTransactionRequest path (ref: CommitTransactionRef riding flat
serialized arenas end to end, fdbclient/CommitTransaction.h). A client
process with hundreds of concurrent transactions coalesces their commits
into one CommitWireBatch — a handful of numpy columns over a single key/
value blob — so the cross-process hop serializes and deserializes per
BATCH, not per transaction. At 10K+ commits/s the per-object pickle walk
is exactly the host cost the commit plane cannot afford.

Layout (all little-endian, offsets derived by cumsum on parse — nothing
per-row ships):

    snaps     (T,)  int64   per-txn read snapshot
    r/w/m_counts (T,) int32 conflict-range / mutation counts per txn
    m_types   (M,)  uint8   mutation type codes
    rb/re/wb/we_len (R/W,) int32   conflict-range key lengths
    p1/p2_len (M,)  int32   mutation param lengths
    blob      (B,)  uint8   rb ++ re ++ wb ++ we ++ p1 ++ p2, row-major

`from_reqs`/`to_reqs` round-trip CommitTransactionRequest objects exactly
(tests/test_commit_plane.py packs every batch both ways); `to_bytes`/
`from_bytes` round-trip the columns with np.frombuffer views.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..core.runtime import Promise

_MAGIC = 0xFDB7_C377
_VERSION = 1
_HEADER = struct.Struct("<IHHQQQQ")  # magic, ver, pad, n_txns, nr, nw, nm


def _len_col(items: list) -> np.ndarray:
    return np.fromiter(map(len, items), dtype=np.int32, count=len(items))


@dataclass
class CommitWireBatch:
    """One client commit batch as columns (see module docstring)."""

    n_txns: int
    snaps: np.ndarray      # (T,)  int64
    r_counts: np.ndarray   # (T,)  int32
    w_counts: np.ndarray   # (T,)  int32
    m_counts: np.ndarray   # (T,)  int32
    m_types: np.ndarray    # (M,)  uint8
    rb_len: np.ndarray     # (R,)  int32
    re_len: np.ndarray
    wb_len: np.ndarray     # (W,)  int32
    we_len: np.ndarray
    p1_len: np.ndarray     # (M,)  int32
    p2_len: np.ndarray
    blob: bytes
    # Flight recorder: sparse ((txn_row, debug_id), ...) of the sampled
    # commits in this batch (resolver/wire.pack_debug_column trailer on
    # the wire; empty batches add zero bytes).
    dbg: tuple = ()

    @classmethod
    def from_reqs(cls, reqs: Sequence) -> "CommitWireBatch":
        """Columnarize CommitTransactionRequest objects (client-side
        encoder, one linear pass off the RPC path)."""
        n = len(reqs)
        snaps = np.fromiter(
            (r.read_snapshot for r in reqs), dtype=np.int64, count=n
        )
        r_counts = np.fromiter(
            (len(r.read_conflict_ranges) for r in reqs), np.int32, count=n
        )
        w_counts = np.fromiter(
            (len(r.write_conflict_ranges) for r in reqs), np.int32, count=n
        )
        m_counts = np.fromiter(
            (len(r.mutations) for r in reqs), np.int32, count=n
        )
        rb = [kr.begin for r in reqs for kr in r.read_conflict_ranges]
        re_ = [kr.end for r in reqs for kr in r.read_conflict_ranges]
        wb = [kr.begin for r in reqs for kr in r.write_conflict_ranges]
        we = [kr.end for r in reqs for kr in r.write_conflict_ranges]
        muts = [m for r in reqs for m in r.mutations]
        p1 = [m.param1 for m in muts]
        p2 = [m.param2 for m in muts]
        m_types = np.fromiter(
            (int(m.type) for m in muts), dtype=np.uint8, count=len(muts)
        )
        groups = (rb, re_, wb, we, p1, p2)
        lens = [_len_col(g) for g in groups]
        blob = b"".join(b"".join(g) for g in groups)
        dbg = tuple(
            (i, r.debug_id) for i, r in enumerate(reqs)
            if getattr(r, "debug_id", None)
        )
        return cls(
            n_txns=n, snaps=snaps, r_counts=r_counts, w_counts=w_counts,
            m_counts=m_counts, m_types=m_types,
            rb_len=lens[0], re_len=lens[1], wb_len=lens[2], we_len=lens[3],
            p1_len=lens[4], p2_len=lens[5], blob=blob, dbg=dbg,
        )

    def to_bytes(self) -> bytes:
        from ..resolver.wire import pack_debug_column

        nr, nw, nm = len(self.rb_len), len(self.wb_len), len(self.m_types)
        parts = [
            _HEADER.pack(_MAGIC, _VERSION, 0, self.n_txns, nr, nw, nm),
            np.ascontiguousarray(self.snaps, np.int64).tobytes(),
            np.ascontiguousarray(self.r_counts, np.int32).tobytes(),
            np.ascontiguousarray(self.w_counts, np.int32).tobytes(),
            np.ascontiguousarray(self.m_counts, np.int32).tobytes(),
            np.ascontiguousarray(self.m_types, np.uint8).tobytes(),
        ]
        for ln in (self.rb_len, self.re_len, self.wb_len, self.we_len,
                   self.p1_len, self.p2_len):
            parts.append(np.ascontiguousarray(ln, np.int32).tobytes())
        parts.append(self.blob)
        # Sparse debug column AFTER the blob (from_bytes re-derives the
        # blob length from the length columns; unsampled -> zero bytes).
        parts.append(pack_debug_column(self.dbg))
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CommitWireBatch":
        """Zero-copy parse: every column is an np.frombuffer view on the
        RPC payload; no per-transaction Python work."""
        magic, version, _, n, nr, nw, nm = _HEADER.unpack_from(data, 0)
        if magic != _MAGIC or version != _VERSION:
            raise ValueError("not a CommitWireBatch payload")
        at = _HEADER.size

        def take(count, dtype):
            nonlocal at
            arr = np.frombuffer(data, dtype=dtype, count=count, offset=at)
            at += arr.nbytes
            return arr

        snaps = take(n, np.int64)
        r_counts = take(n, np.int32)
        w_counts = take(n, np.int32)
        m_counts = take(n, np.int32)
        m_types = take(nm, np.uint8)
        rb_len = take(nr, np.int32)
        re_len = take(nr, np.int32)
        wb_len = take(nw, np.int32)
        we_len = take(nw, np.int32)
        p1_len = take(nm, np.int32)
        p2_len = take(nm, np.int32)
        from ..resolver.wire import unpack_debug_column

        blob_len = sum(
            int(ln.astype(np.int64).sum())
            for ln in (rb_len, re_len, wb_len, we_len, p1_len, p2_len)
        )
        return cls(
            n_txns=n, snaps=snaps, r_counts=r_counts, w_counts=w_counts,
            m_counts=m_counts, m_types=m_types,
            rb_len=rb_len, re_len=re_len, wb_len=wb_len, we_len=we_len,
            p1_len=p1_len, p2_len=p2_len, blob=data[at: at + blob_len],
            dbg=unpack_debug_column(data, at + blob_len),
        )

    def to_reqs(self) -> list:
        """Decode into CommitTransactionRequest objects with fresh reply
        promises (server-side: the unpacked requests feed the proxy's
        commit stream like directly-sent ones)."""
        from ..kv.atomic import MutationType
        from ..kv.keys import KeyRange
        from .interfaces import CommitTransactionRequest, Mutation

        blob = self.blob
        groups = (self.rb_len, self.re_len, self.wb_len, self.we_len,
                  self.p1_len, self.p2_len)
        base = 0
        offs = []
        for ln in groups:
            l64 = ln.astype(np.int64)
            o = base + np.concatenate([[0], np.cumsum(l64[:-1])]) \
                if len(ln) else np.zeros(0, np.int64)
            offs.append(o)
            base += int(l64.sum())

        def rows(gi: int, at: int, count: int) -> list[bytes]:
            o, ln = offs[gi], groups[gi]
            return [
                blob[int(o[at + j]): int(o[at + j]) + int(ln[at + j])]
                for j in range(count)
            ]

        out = []
        r_at = w_at = m_at = 0
        for i in range(self.n_txns):
            ncr = int(self.r_counts[i])
            ncw = int(self.w_counts[i])
            ncm = int(self.m_counts[i])
            rr = [KeyRange(b, e) for b, e in
                  zip(rows(0, r_at, ncr), rows(1, r_at, ncr))]
            wr = [KeyRange(b, e) for b, e in
                  zip(rows(2, w_at, ncw), rows(3, w_at, ncw))]
            ms = [
                Mutation(MutationType(int(self.m_types[m_at + j])), p1, p2)
                for j, (p1, p2) in enumerate(
                    zip(rows(4, m_at, ncm), rows(5, m_at, ncm))
                )
            ]
            out.append(CommitTransactionRequest(
                read_snapshot=int(self.snaps[i]),
                read_conflict_ranges=tuple(rr),
                write_conflict_ranges=tuple(wr),
                mutations=tuple(ms),
            ))
            r_at += ncr
            w_at += ncw
            m_at += ncm
        for i, did in self.dbg:
            out[i].debug_id = did
        return out


_TMB_MAGIC = 0xFDB7_9EEB
_TMB_VERSION = 1
_TMB_TAGGED = 1  # flags bit 0: rows are TaggedMutation (else bare Mutation)
_TMB_HEADER = struct.Struct("<IHHQQQ")  # magic, ver, flags, n_ent, n_rows, n_tags


@dataclass
class TaggedMutationBatch:
    """The log->storage peek payload as columns: N (version, [mutation])
    entries ride ONE buffer — per-entry version/row-count columns, per-row
    type/param-length columns (plus tag columns when the rows are
    TaggedMutations, the LogRouter/spill shape) over a single value blob.
    `from_bytes` is zero-copy np.frombuffer views; `slice()` chunks at
    entry granularity without re-encoding rows. ROADMAP notes this is the
    exact mutation-apply format the device storage engine will consume,
    so the layout is defined once here, beside its push-side twin
    (`pack_tagged_mutations`). Gated by SERVER_KNOBS.TLOG_PEEK_WIRE with
    the object path kept as the differential oracle (`to_entries` must be
    bit-identical to the list the log would have returned)."""

    n_entries: int
    tagged: bool
    versions: np.ndarray    # (E,)  int64
    row_counts: np.ndarray  # (E,)  int32
    tag_counts: np.ndarray  # (R,)  int32  (empty when not tagged)
    tags: np.ndarray        # (NT,) int32  (empty when not tagged)
    m_types: np.ndarray     # (R,)  uint8
    p1_len: np.ndarray      # (R,)  int32
    p2_len: np.ndarray      # (R,)  int32
    blob: bytes             # p1 rows ++ p2 rows

    @classmethod
    def from_entries(cls, entries: Sequence[tuple]) -> "TaggedMutationBatch":
        """Columnarize [(version, [Mutation|TaggedMutation])] in one
        linear pass (server-side encoder, off the long-poll reply)."""
        n_e = len(entries)
        versions = np.fromiter(
            (v for v, _ in entries), np.int64, count=n_e
        )
        row_counts = np.fromiter(
            (len(ms) for _, ms in entries), np.int32, count=n_e
        )
        rows = [m for _, ms in entries for m in ms]
        tagged = bool(rows) and hasattr(rows[0], "mutation")
        if tagged:
            tag_counts = np.fromiter(
                (len(r.tags) for r in rows), np.int32, count=len(rows)
            )
            tags = np.fromiter(
                (t for r in rows for t in r.tags), np.int32,
                count=int(tag_counts.sum()),
            )
            muts = [r.mutation for r in rows]
        else:
            tag_counts = np.zeros(0, np.int32)
            tags = np.zeros(0, np.int32)
            muts = rows
        m_types = np.fromiter(
            (int(m.type) for m in muts), np.uint8, count=len(muts)
        )
        p1 = [m.param1 for m in muts]
        p2 = [m.param2 for m in muts]
        return cls(
            n_entries=n_e, tagged=tagged, versions=versions,
            row_counts=row_counts, tag_counts=tag_counts, tags=tags,
            m_types=m_types, p1_len=_len_col(p1), p2_len=_len_col(p2),
            blob=b"".join(p1) + b"".join(p2),
        )

    def to_bytes(self) -> bytes:
        flags = _TMB_TAGGED if self.tagged else 0
        n_rows = len(self.m_types)
        parts = [
            _TMB_HEADER.pack(_TMB_MAGIC, _TMB_VERSION, flags,
                             self.n_entries, n_rows, len(self.tags)),
            np.ascontiguousarray(self.versions, np.int64).tobytes(),
            np.ascontiguousarray(self.row_counts, np.int32).tobytes(),
        ]
        if self.tagged:
            parts.append(
                np.ascontiguousarray(self.tag_counts, np.int32).tobytes()
            )
            parts.append(np.ascontiguousarray(self.tags, np.int32).tobytes())
        parts += [
            np.ascontiguousarray(self.m_types, np.uint8).tobytes(),
            np.ascontiguousarray(self.p1_len, np.int32).tobytes(),
            np.ascontiguousarray(self.p2_len, np.int32).tobytes(),
            self.blob,
        ]
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TaggedMutationBatch":
        """Zero-copy parse: every column is an np.frombuffer view on the
        reply payload; no per-entry Python work."""
        if len(data) < _TMB_HEADER.size:
            raise ValueError("TaggedMutationBatch payload truncated")
        magic, version, flags, n_e, n_rows, n_tags = \
            _TMB_HEADER.unpack_from(data, 0)
        if magic != _TMB_MAGIC or version != _TMB_VERSION:
            raise ValueError("not a TaggedMutationBatch payload")
        tagged = bool(flags & _TMB_TAGGED)
        at = _TMB_HEADER.size

        def take(count, dtype):
            nonlocal at
            arr = np.frombuffer(data, dtype=dtype, count=count, offset=at)
            at += arr.nbytes
            return arr

        versions = take(n_e, np.int64)
        row_counts = take(n_e, np.int32)
        if tagged:
            tag_counts = take(n_rows, np.int32)
            tags = take(n_tags, np.int32)
        else:
            tag_counts = np.zeros(0, np.int32)
            tags = np.zeros(0, np.int32)
        m_types = take(n_rows, np.uint8)
        p1_len = take(n_rows, np.int32)
        p2_len = take(n_rows, np.int32)
        blob_len = int(p1_len.astype(np.int64).sum()) + \
            int(p2_len.astype(np.int64).sum())
        if at + blob_len > len(data):
            raise ValueError("TaggedMutationBatch payload truncated")
        return cls(
            n_entries=n_e, tagged=tagged, versions=versions,
            row_counts=row_counts, tag_counts=tag_counts, tags=tags,
            m_types=m_types, p1_len=p1_len, p2_len=p2_len,
            blob=data[at: at + blob_len],
        )

    def slice(self, lo: int, hi: int) -> "TaggedMutationBatch":
        """Entries [lo, hi) as a standalone batch — chunking for bounded
        peek replies without re-encoding any row (column slices plus two
        blob spans)."""
        lo = max(0, min(lo, self.n_entries))
        hi = max(lo, min(hi, self.n_entries))
        rc64 = self.row_counts.astype(np.int64)
        r0 = int(rc64[:lo].sum())
        r1 = r0 + int(rc64[lo:hi].sum())
        p1_64 = self.p1_len.astype(np.int64)
        p2_64 = self.p2_len.astype(np.int64)
        p1_total = int(p1_64.sum())
        s1, e1 = int(p1_64[:r0].sum()), int(p1_64[:r1].sum())
        s2, e2 = int(p2_64[:r0].sum()), int(p2_64[:r1].sum())
        if self.tagged:
            tc64 = self.tag_counts.astype(np.int64)
            t0, t1 = int(tc64[:r0].sum()), int(tc64[:r1].sum())
            tag_counts = self.tag_counts[r0:r1]
            tags = self.tags[t0:t1]
        else:
            tag_counts = self.tag_counts
            tags = self.tags
        return TaggedMutationBatch(
            n_entries=hi - lo, tagged=self.tagged,
            versions=self.versions[lo:hi],
            row_counts=self.row_counts[lo:hi],
            tag_counts=tag_counts, tags=tags,
            m_types=self.m_types[r0:r1],
            p1_len=self.p1_len[r0:r1], p2_len=self.p2_len[r0:r1],
            blob=self.blob[s1:e1]
            + self.blob[p1_total + s2: p1_total + e2],
        )

    def to_entries(self) -> list[tuple[int, list]]:
        """Decode back into [(version, [Mutation|TaggedMutation])] —
        bit-identical to the object path (the parity tests fingerprint
        the applied keyspace both ways)."""
        from ..kv.atomic import MutationType
        from .interfaces import Mutation

        blob = self.blob
        p1_lens, p2_lens = self.p1_len.tolist(), self.p2_len.tolist()
        types = self.m_types.tolist()
        m_type = {t: MutationType(t) for t in set(types)}
        p1_at = 0
        p2_at = sum(p1_lens)
        muts = []
        for t, l1, l2 in zip(types, p1_lens, p2_lens):
            muts.append(Mutation(
                m_type[t], blob[p1_at: p1_at + l1], blob[p2_at: p2_at + l2],
            ))
            p1_at += l1
            p2_at += l2
        if self.tagged:
            from .log_system import TaggedMutation

            tags = self.tags.tolist()
            t_at = 0
            rows = []
            for m, tc in zip(muts, self.tag_counts.tolist()):
                rows.append(TaggedMutation(tuple(tags[t_at: t_at + tc]), m))
                t_at += tc
        else:
            rows = muts
        out = []
        r_at = 0
        for v, rc in zip(self.versions[: self.n_entries].tolist(),
                         self.row_counts[: self.n_entries].tolist()):
            out.append((v, rows[r_at: r_at + rc]))
            r_at += rc
        return out


def maybe_wire_peek(entries: list) -> list:
    """The in-process peek gate: under SIMULATION with
    SERVER_KNOBS.TLOG_PEEK_WIRE on, round-trip a peek result through the
    columnar codec so every sim seed that draws the knob exercises the
    wire format against the object-path oracle (in-process tiers never
    serialize, so the roundtrip IS the coverage). Real-clock processes
    skip it: the multiprocess tier ships the actual bytes exactly once,
    at the LogHost peek reply."""
    from ..core.knobs import SERVER_KNOBS
    from ..core.runtime import current_loop

    if not entries or not SERVER_KNOBS.TLOG_PEEK_WIRE:
        return entries
    if not current_loop().is_simulated():
        return entries
    rows = [m for _, ms in entries for m in ms]
    tagged = bool(rows) and hasattr(rows[0], "mutation")
    if not all(hasattr(m, "mutation") == tagged
               and (tagged or hasattr(m, "param1")) for m in rows):
        # Synthetic payloads (unit tests push bare tuples through
        # MemoryTLog.commit) aren't wire-representable; production peeks
        # only ever carry Mutation/TaggedMutation rows.
        return entries
    return TaggedMutationBatch.from_bytes(
        TaggedMutationBatch.from_entries(entries).to_bytes()
    ).to_entries()


# Per-txn outcome codes of a batched commit reply: the client maps them
# back onto the exceptions the direct path raises, so transaction retry
# loops see identical errors either way.
OUTCOME_COMMITTED = 0
OUTCOME_CONFLICT = 1
OUTCOME_TOO_OLD = 2
OUTCOME_MAYBE_COMMITTED = 3
OUTCOME_FAILED = 4


def pack_tagged_mutations(tms: Sequence) -> bytes:
    """One buffer of N TaggedMutations — the txn-host -> log-host push
    payload (RemoteLogSystem.push, SERVER_KNOBS.TLOG_WIRE_BATCH): tag
    vectors, type codes and param columns over a single blob instead of
    N nested dataclasses through the recursive encoder."""
    n = len(tms)
    t_counts = np.fromiter((len(t.tags) for t in tms), np.int32, count=n)
    tags = np.fromiter(
        (tag for t in tms for tag in t.tags), np.int32,
        count=int(t_counts.sum()),
    )
    m_types = np.fromiter(
        (int(t.mutation.type) for t in tms), np.uint8, count=n
    )
    p1 = [t.mutation.param1 for t in tms]
    p2 = [t.mutation.param2 for t in tms]
    p1_len = _len_col(p1)
    p2_len = _len_col(p2)
    return b"".join([
        struct.pack("<I", n), t_counts.tobytes(), tags.tobytes(),
        m_types.tobytes(), p1_len.tobytes(), p2_len.tobytes(),
        b"".join(p1), b"".join(p2),
    ])


def unpack_tagged_mutations(data: bytes) -> list:
    from ..kv.atomic import MutationType
    from .interfaces import Mutation
    from .log_system import TaggedMutation

    (n,) = struct.unpack_from("<I", data, 0)
    at = 4
    t_counts = np.frombuffer(data, np.int32, n, at); at += 4 * n
    nt = int(t_counts.sum())
    tags = np.frombuffer(data, np.int32, nt, at); at += 4 * nt
    m_types = np.frombuffer(data, np.uint8, n, at); at += n
    p1_len = np.frombuffer(data, np.int32, n, at); at += 4 * n
    p2_len = np.frombuffer(data, np.int32, n, at); at += 4 * n
    p2_at = at + int(p1_len.sum())
    out = []
    t_at = 0
    for i in range(n):
        tc, l1, l2 = int(t_counts[i]), int(p1_len[i]), int(p2_len[i])
        out.append(TaggedMutation(
            tuple(int(t) for t in tags[t_at: t_at + tc]),
            Mutation(MutationType(int(m_types[i])),
                     data[at: at + l1], data[p2_at: p2_at + l2]),
        ))
        t_at += tc
        at += l1
        p2_at += l2
    return out


def pack_outcomes(outs: Sequence[tuple]) -> bytes:
    """One buffer of N (code, version, versionstamp, message) outcomes —
    the reply rides the wire as a single bytes value instead of N nested
    tuples walking the recursive encoder."""
    n = len(outs)
    codes = np.fromiter((o[0] for o in outs), np.uint8, count=n)
    vers = np.fromiter((o[1] for o in outs), np.int64, count=n)
    stamps = [o[2] for o in outs]
    msgs = [o[3].encode() for o in outs]
    s_len = _len_col(stamps)
    m_len = _len_col(msgs)
    return b"".join([
        struct.pack("<I", n), codes.tobytes(), vers.tobytes(),
        s_len.tobytes(), m_len.tobytes(),
        b"".join(stamps), b"".join(msgs),
    ])


def unpack_outcomes(data: bytes) -> list[tuple]:
    (n,) = struct.unpack_from("<I", data, 0)
    at = 4
    codes = np.frombuffer(data, np.uint8, n, at); at += n
    vers = np.frombuffer(data, np.int64, n, at); at += 8 * n
    s_len = np.frombuffer(data, np.int32, n, at); at += 4 * n
    m_len = np.frombuffer(data, np.int32, n, at); at += 4 * n
    outs = []
    m_at = at + int(s_len.sum())
    for i in range(n):
        sl, ml = int(s_len[i]), int(m_len[i])
        outs.append((int(codes[i]), int(vers[i]), data[at: at + sl],
                     data[m_at: m_at + ml].decode()))
        at += sl
        m_at += ml
    return outs


@dataclass
class CommitBatchRequest:
    """One columnar buffer of N commits (CommitWireBatch.to_bytes),
    answered with N (outcome_code, version, versionstamp, message) tuples.
    Served by the txn host (WLTOKEN_COMMIT_BATCH, cluster/multiprocess.py),
    produced by the client connection's commit coalescer
    (client/connection.py, CLIENT_KNOBS.COMMIT_WIRE_BATCH)."""

    payload: bytes
    reply: Promise = field(default_factory=Promise)


def _register_wire_types() -> None:
    from ..core.serialize import register_message

    register_message(CommitBatchRequest)


_register_wire_types()
