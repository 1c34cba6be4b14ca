"""Rank-fed conflict kernel: keys never cross the host-device link.

The port's counterpart of foundationdb_tpu/resolver/rankfed.py. The host
keeps a SORTED MIRROR of the history's keys (fixed-width byte-encoded,
numpy 'S' dtype, memcmp order == the packed word order), always exactly
aligned by position with the device's one (C,) int32 version vector.
Every rank the device needs (read-begin/end history ranks for phase 1,
write-endpoint merge ranks for phase 3, the case A/B geometry of phase
2) is an np.searchsorted on the host, shipped as int32 in one fused
buffer. The device work is the version range-max, the intra-batch fixed
point and the merge scatter.

Alignment without per-batch sync, the SUPERSET insert: every write
endpoint of a batch goes into mirror and device state alike, committed
or not; an endpoint of an uncommitted write takes its predecessor's
value, which leaves the step FUNCTION unchanged. Duplicates and no-op
entries accumulate until a GC ROUND (one D2H of the version vector on
the TPU_COMPACT_EVERY_BATCHES cadence) re-canonicalizes both sides.

The JAX package built this kernel for a host link of 10-30 MB/s; on a
card with a fast host link it is kept as the resolver whose keys stay on
the host, beside ConflictSetGPU, whose keys live on the card.

What differs from the JAX package, and why:

- `_rank_kernel_impl` is three hand-written CUDA kernels on the card
  (XLA compiled it; the JAX package wrote no Pallas kernel for it):
  phases 1 and 3 in csrc/rankfed.cu (rankfed_ops.py, their plain torch
  versions beside them, the JAX/torch semantic hazards through
  resolver/_ops.py), phase 2 in csrc/phase2.cu.
- Phase 2's `lax.while_loop` stops on a device boolean, which eager
  torch cannot do without a host read. `_phase2_fixed_point` runs its
  rounds in the hand-written CUDA kernel that gpu.py's phase 2 runs
  (phase2.py, csrc/phase2.cu; case B stabs leaf qb2 - 1, no seed, the
  cap T + 2), so resolve_async makes no host read on the card. On CPU
  tensors the plain version runs the rounds in groups (1, 2, 4, 8, 8,
  ...) with one host read per group, counted in P2_SYNCS.
- The JAX kernel donates the version vector; here the set holds one
  `hv` tensor and replaces it with the kernel's output.
- The fused buffer's H2D goes through pinned memory, non_blocking, and
  the statuses' D2H starts at dispatch behind a CUDA event (gpu.upload,
  gpu._start_d2h).

Differential contract: statuses, canonicalized entries() and the raw
version vector equal the JAX package's ConflictSetRankFed bit for bit;
statuses and entries() equal ConflictSetCPU's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS
from ..device import resolve_device
from . import phase2, rankfed_ops
from ._ops import I32
from .gpu import _P2_GROUPS, _start_d2h, to_device, upload
from .packing import KeyWidthError, flatten_batch, next_pow2, pack_keys
from .types import ConflictBatchResult, TxnConflictInfo

INT32_MAX = np.int32(2**31 - 1)
P2_SYNCS = 0  # host reads of phase 2's plain version (CPU tensors only)


# ---------------------------------------------------------------------------
# Host-side key encoding: fixed-width bytes whose memcmp order equals the
# (words..., len) tuple order (big-endian unsigned words, big-endian u32
# length) — the same total order the classic kernel compares in int32.
# ---------------------------------------------------------------------------

def encode_keys(keys: Sequence[bytes], n_words: int) -> np.ndarray:
    words, lens = pack_keys(keys, n_words)
    n = len(keys)
    # Concatenate at the BYTE level: np.concatenate silently normalizes
    # byteswapped dtypes to native order, which would scramble the memcmp
    # encoding.
    raw = (
        (words.view(np.uint32) ^ np.uint32(0x80000000))
        .astype(">u4").view(np.uint8).reshape(n, 4 * n_words)
    )
    lens_b = lens.astype(">u4").view(np.uint8).reshape(n, 4)
    buf = np.concatenate([raw, lens_b], axis=1)
    return np.ascontiguousarray(buf).view(f"S{4 * (n_words + 1)}").reshape(-1)


def widen_encoded(enc: np.ndarray, old_words: int, new_words: int) -> np.ndarray:
    """Re-encode a mirror at a wider word count WITHOUT decoding: insert
    zero words between the old words and the length (packed keys are
    zero-padded, so the extra words are raw 0x00000000 big-endian)."""
    a = enc.view(np.uint8).reshape(len(enc), 4 * (old_words + 1))
    pad = np.zeros((len(enc), 4 * (new_words - old_words)), dtype=np.uint8)
    out = np.concatenate([a[:, : 4 * old_words], pad, a[:, 4 * old_words:]],
                         axis=1)
    return np.ascontiguousarray(out).view(f"S{4 * (new_words + 1)}").reshape(-1)


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

class RankLayout:
    """Static layout of the fused int32 buffer (all host-computed ranks).

    Segments (int32):
      rank_b   R   #mirror entries <= read_begin   (phase 1, >=1: b"" root)
      rank_e   R   #mirror entries <  read_end     (phase 1)
      loA      R   #write-begins with key <= read_begin          (case A)
      hiA      R   #write-begins with key <  read_end            (case A)
      qb2      R   read_begin's position among sorted write endpoints
                   (= #write endpoints sorted before read_begin's point,
                   tag order included)                            (case B)
      rtxn     R   owning txn of each read row
      rsnap    R   read snapshot offset
      perm     Wr  write row at each begin-rank (case A permutation)
      wb2      Wr  write begin position among sorted write endpoints
      we2      Wr  write end position among sorted write endpoints
      wtxn     Wr  owning txn of each write row
      w_valid  Wr  1 for real write rows
      ub_c     M   #mirror entries <= endpoint key, per sorted endpoint
                   (pads: n, so they merge past the live region)
      wsrc     M   (write_row << 1) | is_begin, per sorted endpoint
      too_old  T
      scalars  3   [version_off, oldest_off, n]
    """

    def __init__(self, R: int, Wr: int, T: int, C: int):
        self.R, self.Wr, self.T, self.C = R, Wr, T, C
        self.M = 2 * Wr
        o = 0
        names = [
            ("rank_b", R), ("rank_e", R), ("loA", R), ("hiA", R),
            ("qb2", R), ("rtxn", R), ("rsnap", R),
            ("perm", Wr), ("wb2", Wr), ("we2", Wr), ("wtxn", Wr),
            ("w_valid", Wr),
            ("ub_c", self.M), ("wsrc", self.M),
            ("too_old", T), ("scalars", 3),
        ]
        for name, size in names:
            setattr(self, "off_" + name, o)
            o += size
        self.total = o

    def key(self):
        return (self.R, self.Wr, self.T, self.C)


def _phase2_fixed_point(base_conf, *, wb2, we2, leaf, loA, hiA, perm, rtxn,
                        wtxn, w_valid, T: int, M: int):
    """Intra-batch fixed point from `base_conf`: rounds until nothing
    changes, at most T + 2 (rankfed.py:223-253), through
    phase2.phase2_rounds (the CUDA kernel on the card; on the CPU the
    plain version, whose group reads P2_SYNCS counts). Case B stabs
    `leaf` (phase 1's rankfed_ops.stab_leaf of qb2: -1 where the read
    point sorts before every write endpoint, nothing covers it)."""
    global P2_SYNCS
    conflict, _, reads = phase2.phase2_rounds(
        base_conf, base_conf, 0, T + 2, perm=perm, lo=loA, hi=hiA,
        seg_lo=wb2, seg_hi=we2, n_leaves=M, leaf=leaf, rtxn=rtxn, wtxn=wtxn,
        w_valid=w_valid, groups=_P2_GROUPS)
    P2_SYNCS += reads
    return conflict


def _rank_kernel_impl(hv, fused, *, lay: RankLayout):
    """One resolve. hv: (C,) int32 version offsets; fused: RankLayout
    buffer (views of it, no conversion op). Phase 1 (rankfed_ops.phase1),
    phase 2 (phase2.phase2_rounds), phase 3 (rankfed_ops.phase3): on the
    card three kernel launches. Returns (hv_new, statuses)."""
    R, Wr, T, M = lay.R, lay.Wr, lay.T, lay.M

    def sl(name, size):
        off = getattr(lay, "off_" + name)
        return fused[off:off + size]

    rtxn, wtxn = sl("rtxn", R), sl("wtxn", Wr)
    w_valid, too_old = sl("w_valid", Wr), sl("too_old", T)

    # ---- Phase 1: read-vs-history (range max over [rank_b-1, rank_e)) ----
    base_conf, leaf, valid = rankfed_ops.phase1(
        hv, rank_b=sl("rank_b", R), rank_e=sl("rank_e", R),
        rsnap=sl("rsnap", R), rtxn=rtxn, too_old=too_old, qb2=sl("qb2", R),
        w_valid=w_valid, M=M)

    # ---- Phase 2: intra-batch fixed point (write-endpoint space) ----
    conflict = _phase2_fixed_point(
        base_conf, wb2=sl("wb2", Wr), we2=sl("we2", Wr), leaf=leaf,
        loA=sl("loA", R), hiA=sl("hiA", R), perm=sl("perm", Wr), rtxn=rtxn,
        wtxn=wtxn, w_valid=valid, T=T, M=M)

    # ---- Phase 3: superset merge (positions fully host-determined) ----
    return rankfed_ops.phase3(
        hv, conflict, wtxn=wtxn, w_valid=w_valid, ub_c=sl("ub_c", M),
        wsrc=sl("wsrc", M), too_old=too_old,
        scalars=fused[lay.off_scalars:lay.off_scalars + 3])


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def _tagged(enc: np.ndarray, tag: int) -> np.ndarray:
    """Append a tag byte so argsort orders equal keys by tag (we < wb)."""
    w = enc.dtype.itemsize
    a = enc.view(np.uint8).reshape(len(enc), w)
    t = np.full((len(enc), 1), tag, dtype=np.uint8)
    return np.ascontiguousarray(
        np.concatenate([a, t], axis=1)
    ).view(f"S{w + 1}").reshape(-1)


class RankPackedBatch:
    def __init__(self, layout, buf, base, n_txns, n_reads, n_writes,
                 new_mirror, longest):
        self.layout = layout
        self.buf = buf
        self.base = base
        self.n_txns = n_txns
        self.n_reads = n_reads
        self.n_writes = n_writes
        self.new_mirror = new_mirror  # mirror AFTER this batch's inserts
        self.longest = longest

    def set_scalars(self, version_off: int, oldest_off: int) -> None:
        self.buf[self.layout.off_scalars] = version_off
        self.buf[self.layout.off_scalars + 1] = oldest_off


class PendingRankResolve:
    """An in-flight resolve: the statuses' D2H started at dispatch;
    result() waits for it. `_keep` holds the pinned H2D source until
    then (the event orders after its copy). `p2_syncs` is the number of
    host reads phase 2 made in this dispatch."""

    def __init__(self, statuses, n_txns, keep=None, p2_syncs: int = 0):
        self._host, self._event = _start_d2h(statuses)
        self._keep = keep
        self.n_txns = n_txns
        self.p2_syncs = p2_syncs

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._keep = None
        return self._host.numpy()[: self.n_txns]


class ConflictSetRankFed:
    """ConflictSetCPU contract; the device holds versions only (see the
    module docstring). `device=None` means the CUDA card; without one it
    raises unless the caller passes device="cpu"."""

    def __init__(self, init_version: int = 0, max_key_bytes: int = 32,
                 initial_capacity: int = 1024, device=None):
        self.device = resolve_device(device)
        self.n_words = max(1, (max_key_bytes + 3) // 4)
        self.max_key_bytes = 4 * self.n_words
        self.capacity = next_pow2(initial_capacity, minimum=64)
        self.oldest_version = 0
        if not (0 <= init_version < 2**31):
            raise ValueError("init_version must fit the initial int32 window")
        self.mirror = encode_keys([b""], self.n_words)
        self.n = 1
        self._since_gc = 0
        self.gc_rounds = 0
        hv = np.zeros(self.capacity, dtype=np.int32)
        hv[0] = init_version
        self.hv = to_device(hv, self.device)

    def __len__(self) -> int:
        return self.n

    # -- introspection: canonical view, matches the oracle bit-for-bit --
    def _canonical(self):
        """The canonical step function (keys, values) from one read of the
        version vector: the amortized departure of GC rounds and
        entries()."""
        vals = self.hv[: self.n].cpu().numpy()
        enc = self.mirror
        # Last duplicate of each key wins.
        last = np.concatenate([enc[1:] != enc[:-1], [True]])
        kk, vv = enc[last], vals[last]
        # Coalesce equal adjacent values (first of each run kept).
        keep = np.concatenate([[True], vv[1:] != vv[:-1]])
        return kk[keep], vv[keep]

    def entries(self) -> list[tuple[bytes, int]]:
        kk, vv = self._canonical()
        W = self.n_words
        out = []
        for e, v in zip(kk, vv):
            # The encoding stores the raw key bytes zero-padded (unbiased,
            # big-endian words == the bytes themselves) + a BE u32 length;
            # 'S' dtype strips trailing NULs, so re-pad before slicing.
            b = e.ljust(4 * (W + 1), b"\x00")
            length = int.from_bytes(b[4 * W:], "big")
            key = b[:length]
            v = int(v)
            out.append((key, v + self.oldest_version if v > 0 else 0))
        return out

    # -- growth --
    def _grow(self, min_capacity: int) -> None:
        new_cap = next_pow2(min_capacity, minimum=self.capacity * 2)
        pad = torch.zeros(new_cap - self.capacity, dtype=I32,
                          device=self.device)
        self.hv = torch.cat([self.hv, pad])
        self.capacity = new_cap

    def _grow_width(self, min_key_bytes: int) -> None:
        cap = CLIENT_KNOBS.KEY_SIZE_LIMIT + 1
        if min_key_bytes > cap:
            raise KeyWidthError(
                f"key of {min_key_bytes} bytes exceeds the deployment "
                f"key-size limit {cap}"
            )
        new_words = min(
            next_pow2((min_key_bytes + 3) // 4, minimum=self.n_words * 2),
            next_pow2((cap + 3) // 4),
        )
        self.mirror = widen_encoded(self.mirror, self.n_words, new_words)
        self.n_words = new_words
        self.max_key_bytes = 4 * new_words

    # -- GC round: re-canonicalize both sides (amortized D2H) --
    def gc_round(self) -> None:
        kk, vv = self._canonical()
        self.mirror = kk
        self.n = len(kk)
        self.gc_rounds += 1
        if self.n > (3 * self.capacity) // 4:
            self._grow(2 * self.n)
        hv = np.zeros(self.capacity, dtype=np.int32)
        hv[: self.n] = vv
        self.hv = to_device(hv, self.device)

    def prepare(self, txns: Sequence[TxnConflictInfo]) -> None:
        """resolve()'s admission rule before a pack: widen the key width
        for a longer key, and run a GC round (then grow) when the
        superset's pessimistic bound nears capacity or on the
        TPU_COMPACT_EVERY_BATCHES cadence. A pipelined caller runs it
        before each pack()."""
        longest = 0
        for t in txns:
            if t.read_snapshot < self.oldest_version and t.read_ranges:
                continue
            for r in t.read_ranges:
                if not r.is_empty():
                    longest = max(longest, len(r.begin), len(r.end))
            for w in t.write_ranges:
                if not w.is_empty():
                    longest = max(longest, len(w.begin), len(w.end))
        if longest > self.max_key_bytes:
            self._grow_width(longest)
        # Capacity: superset inserts burn 2 entries per write row; GC when
        # the pessimistic bound approaches capacity, and on the same
        # amortized cadence as the block-sparse kernel's compaction pass
        # (SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES).
        n_writes = sum(
            1
            for t in txns
            if not (t.read_snapshot < self.oldest_version and t.read_ranges)
            for w in t.write_ranges
            if not w.is_empty()
        )
        self._since_gc += 1
        if (self.n + 2 * n_writes >= self.capacity - 1
                or self._since_gc >= SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES):
            self.gc_round()
            self._since_gc = 0
            if self.n + 2 * n_writes >= self.capacity - 1:
                self._grow(self.n + 2 * n_writes + 2)

    # -- packing --
    def pack(self, txns: Sequence[TxnConflictInfo]) -> RankPackedBatch:
        (too_old_l, r_begin, r_end, r_txn, r_snap, w_begin, w_end, w_txn) = (
            flatten_batch(txns, self.oldest_version)
        )
        nr, nw, n_txns = len(r_begin), len(w_begin), len(txns)
        longest = 0
        for ks in (r_begin, r_end, w_begin, w_end):
            for k in ks:
                if len(k) > longest:
                    longest = len(k)
        R = next_pow2(max(nr, 1))
        Wr = next_pow2(max(nw, 1))
        T = next_pow2(max(n_txns, 1))
        lay = RankLayout(R, Wr, T, self.capacity)
        buf = np.zeros(lay.total, dtype=np.int32)

        enc_rb = encode_keys(r_begin, self.n_words)
        enc_re = encode_keys(r_end, self.n_words)
        enc_wb = encode_keys(w_begin, self.n_words)
        enc_we = encode_keys(w_end, self.n_words)

        # Sorted write-endpoint space (tag order: end < begin at equal key).
        comp = np.concatenate([_tagged(enc_we, 1), _tagged(enc_wb, 2)])
        order = np.argsort(comp, kind="stable")
        m = 2 * nw
        ep_enc = np.concatenate([enc_we, enc_wb])[order]
        is_begin_sorted = (order >= nw).astype(np.int32)
        row_sorted = np.where(order >= nw, order - nw, order).astype(np.int32)
        inv = np.empty(m, np.int32)
        inv[order] = np.arange(m, dtype=np.int32)
        we2 = inv[:nw]
        wb2 = inv[nw:]

        sorted_wb = np.sort(enc_wb, kind="stable")
        perm = np.argsort(enc_wb, kind="stable").astype(np.int32)

        def seg(name, size):
            off = getattr(lay, "off_" + name)
            return buf[off:off + size]

        # Reads (pads inert: rank_b=1, rank_e=0, loA=hiA=0, qb2=0,
        # rsnap=max).
        rb_seg = seg("rank_b", R)
        rb_seg[:] = 1
        re_seg = seg("rank_e", R)
        rs_seg = seg("rsnap", R)
        rs_seg[:] = INT32_MAX
        if nr:
            rb_seg[:nr] = np.searchsorted(self.mirror, enc_rb, "right")
            re_seg[:nr] = np.searchsorted(self.mirror, enc_re, "left")
            seg("loA", R)[:nr] = np.searchsorted(sorted_wb, enc_rb, "right")
            seg("hiA", R)[:nr] = np.searchsorted(sorted_wb, enc_re, "left")
            seg("qb2", R)[:nr] = np.searchsorted(ep_enc, enc_rb, "right")
            seg("rtxn", R)[:nr] = r_txn
            rel = np.asarray(r_snap, dtype=np.int64) - self.oldest_version
            if rel.min() < 0 or rel.max() >= 2**31:
                raise ValueError("read snapshot outside the int32 window")
            rs_seg[:nr] = rel.astype(np.int32)
        # Writes (pads: perm=row index, wb2=we2=M empty interval).
        perm_seg = seg("perm", Wr)
        perm_seg[:] = np.arange(Wr, dtype=np.int32)
        wb2_seg = seg("wb2", Wr)
        wb2_seg[:] = lay.M
        we2_seg = seg("we2", Wr)
        we2_seg[:] = lay.M
        if nw:
            perm_seg[:nw] = perm
            wb2_seg[:nw] = wb2
            we2_seg[:nw] = we2
            seg("wtxn", Wr)[:nw] = w_txn
            seg("w_valid", Wr)[:nw] = 1
        # Sorted endpoints (pads: ub_c=n so they merge past live region,
        # wsrc points at a pad write row -> value 0).
        ub_seg = seg("ub_c", lay.M)
        ub_seg[:] = self.n
        ws_seg = seg("wsrc", lay.M)
        ws_seg[:] = (Wr - 1) << 1
        ub_real = None
        if m:
            ub_real = np.searchsorted(self.mirror, ep_enc, "right").astype(
                np.int32
            )
            ub_seg[:m] = ub_real
            ws_seg[:m] = (row_sorted << 1) | is_begin_sorted
        seg("too_old", T)[:n_txns] = too_old_l

        # Mirror AFTER this batch: all real endpoints inserted at their
        # merged positions (superset; commit verdicts not needed).
        if m:
            new_mirror = np.empty(self.n + m, dtype=self.mirror.dtype)
            posB = np.arange(m, dtype=np.int64) + ub_real
            mask = np.ones(self.n + m, dtype=bool)
            mask[posB] = False
            new_mirror[posB] = ep_enc
            new_mirror[mask] = self.mirror
        else:
            new_mirror = self.mirror
        return RankPackedBatch(lay, buf, self.oldest_version, n_txns, nr, nw,
                               new_mirror, longest)

    # -- resolution --
    def resolve_async(self, version: int, new_oldest_version: int,
                      pb: RankPackedBatch) -> PendingRankResolve:
        """Dispatch one packed batch; the set advances (mirror, n, oldest
        version) at once, so the next batch is packed after this call.
        Its only host reads are phase 2's, one per round group."""
        if pb.base != self.oldest_version:
            raise ValueError(
                f"batch packed at base {pb.base} but set is at "
                f"{self.oldest_version}"
            )
        if pb.layout.C != self.capacity:
            raise ValueError(
                f"batch packed at capacity {pb.layout.C} but set has "
                f"{self.capacity}"
            )
        oldest_eff = max(self.oldest_version, new_oldest_version)
        version_off = version - self.oldest_version
        if not (0 <= version_off < 2**31):
            raise ValueError("resolve version outside the int32 window")
        pb.set_scalars(version_off, oldest_eff - self.oldest_version)
        pb.buf[pb.layout.off_scalars + 2] = self.n
        fused, keep = upload(pb.buf, self.device)
        syncs0 = P2_SYNCS
        self.hv, statuses = _rank_kernel_impl(self.hv, fused, lay=pb.layout)
        self.mirror = pb.new_mirror
        self.n = self.n + 2 * pb.n_writes
        self.oldest_version = oldest_eff
        return PendingRankResolve(statuses, pb.n_txns, keep,
                                  p2_syncs=P2_SYNCS - syncs0)

    def resolve_packed(self, version, new_oldest_version, pb) -> np.ndarray:
        return self.resolve_async(version, new_oldest_version, pb).result()

    def resolve(
        self, version: int, new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        self.prepare(txns)
        pb = self.pack(txns)
        st = self.resolve_packed(version, new_oldest_version, pb)
        return ConflictBatchResult([int(s) for s in st])
