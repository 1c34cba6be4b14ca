"""Batched conflict detection on the CUDA card — the port's main path.

The torch counterpart of foundationdb_tpu/resolver/tpu.py: the same
block-sparse resident history (NB blocks of B sorted slots, a fence
directory, a block-max segment tree), the same batch-scaled fast resolve,
the same amortized compaction through the dense kernel, the same host
mirror and the same submit/verdicts contract. Function names match
tpu.py one for one, so each has an obvious twin; the module docstring of
tpu.py explains the algorithm and its invariants.

What differs from the JAX package, and why:

- Hand-written CUDA kernels where tpu.py has one compiled program: the
  one Pallas kernel, the rank probe (probe.py, csrc/probe.cu), the block
  kernel's decode, phase 1 and phase 3 (block.py, csrc/block.cu; the
  decode serves the dense kernel too), and the compaction's densify, the
  dense kernel's ranks + phase 1 and phase 3, and the redistribution
  (compact.py, csrc/compact.cu), each one launch on CUDA tensors. Phase
  2's geometry is the one stage left as plain torch ops.
- JAX/torch semantic differences (scan dtype, scatter drops, gather
  clamps, int32 wrap, int8 bytes) go through resolver/_ops.py.
- The fast kernel updates the resident hmat/counts/btree IN PLACE where
  JAX donated those buffers (tpu.py:1105-1116), so the per-batch cost
  stays batch-scaled with no O(capacity) copy.
- Phase 2's `lax.while_loop` stops on a device boolean, which eager torch
  cannot do without a host read; its pointer-jumping seed and its rounds
  run in one launch of a hand-written CUDA kernel instead (phase2.py,
  csrc/phase2.cu), so submit makes no host read there, as tpu.py makes
  none, and launches no seed op. On CPU tensors the plain version runs
  the seed as torch ops and the rounds in groups with one `.item()` per
  group, counted in P2_SYNCS. The mirror readback the next dispatch
  after a compaction makes (as tpu.py does) is the one host sync left
  inside submit on the card.
- The verdict bytes (st_aux) start their D2H right after each dispatch,
  into pinned memory behind a CUDA event; verdicts() waits on the events.

Everything is integer arithmetic, so the results equal the JAX package's
and the CPU oracle's bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS
from ..device import resolve_device
from ._ops import (  # noqa: F401  (tpu.py's twins, for the tests)
    I32,
    _arange,
    _build_table,
    _canonical_nodes_flat,
    _lex_lt_eq,
    _lower_rank,
    _table_range_query,
    cumsum32,
    scatter_new,
)
from .packing import (
    BIAS,
    INT32_MAX,
    PAD_WORD,
    FusedLayout,
    KeyWidthError,
    PackedBatch,
    StickyCaps,
    empty_block_state,
    encode_packed_words,
    next_bucket,
    next_pow2,
    pack_batch,
    pack_keys,
    state_pad_block,
    unpack_key,
    widen_state,
)
from . import block, compact, phase2
from .probe import probe_ranks
from .types import ConflictBatchResult, TxnConflictInfo

P2_SYNCS = 0  # host reads of phase 2's plain version (CPU tensors only)

# Phase-2 round groups of the plain version: one host read after each
# group. Most batches settle in the first verification round (the pointer-
# jumping seed is exact on pure chains), so the groups start small and grow.
_P2_GROUPS = (1, 2, 4, 8)


def _phase2_fixed_point(base_conf, *, smat, q_begin, q_end, s_begin, s_end,
                        rtxn, wtxn, w_valid, T, Wr, P2):
    """Intra-batch fixed point (checkIntraBatchConflicts): the geometry,
    the pointer-jumping seed and the verification rounds until nothing
    changes (cap n_jump+T+2), exactly as tpu._phase2_fixed_point, in one
    phase2.phase2_rounds call in its geometry form (q_end): one launch of
    the CUDA kernel and no torch op on the card, the plain version
    (phase2.geometry_ref, then one host read per round group, counted in
    P2_SYNCS) on the CPU. Returns the per-txn conflict vector and the
    round count (0-d int32)."""
    global P2_SYNCS
    n_jump = phase2.n_jump(T)
    conflict, it, reads = phase2.phase2_rounds(
        base_conf, base_conf, n_jump, n_jump + T + 2, seed=True,
        seg_lo=s_begin, seg_hi=s_end, n_leaves=P2, leaf=q_begin, q_end=q_end,
        rtxn=rtxn, wtxn=wtxn, w_valid=w_valid, groups=_P2_GROUPS)
    P2_SYNCS += reads
    return conflict, it


def _resolve_kernel_impl(hmat, n, fused, *, lay: FusedLayout):
    """One DENSE resolve step (full-history merge; the amortized compaction
    pass). hmat: (W+2, C) int32 state [words.., len, version]; n: live
    entry count (0-d int32 on hmat's device); fused: the batch buffer. The
    decode, the ranks and phase 1 (compact.ranks), phase 2, and phase 3
    (compact.dense_phase3): on the card four kernel launches and phase 2's
    geometry ops. Returns (hmat_out, new_n, st_aux).

    On the card the state must not be full with a write endpoint equal to
    its last key and a later one greater (n = C; see compact.dense_phase3):
    there tpu.py's merge positions collide, and the kernel's result differs
    from the plain version's. A compaction never densifies to n = C."""
    (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn, w_valid,
     too_old, version, oldest_eff, nr, nw) = block.decode_fused(
         fused, lay=lay)

    # ============ Ranks + phase 1: read-vs-history ============
    ub, eq, base_conf = compact.ranks(hmat, n, smat, q_begin, q_end, rsnap,
                                      rtxn, too_old)

    # ============ Phase 2: intra-batch fixed point ============
    conflict, p2_iters = _phase2_fixed_point(
        base_conf, smat=smat, q_begin=q_begin, q_end=q_end,
        s_begin=s_begin, s_end=s_end, rtxn=rtxn, wtxn=wtxn,
        w_valid=w_valid, T=lay.T, Wr=lay.Wr, P2=lay.P2,
    )

    # ============ Phase 3: merge-by-rank + coalesce + compact ============
    return compact.dense_phase3(
        hmat, n, smat=smat, s_begin=s_begin, s_end=s_end, wtxn=wtxn,
        w_valid=w_valid, conflict=conflict, too_old=too_old, ub=ub, eq=eq,
        version=version, oldest_eff=oldest_eff, p2_iters=p2_iters)


def _block_probe(hkeys, qmat, start, B: int):
    """#entries of the B-slot sorted block window at column `start` (per
    query) strictly less than each query key, plus equality at that rank:
    the dense halving walk confined to one block."""
    size = hkeys.shape[1]
    pos = torch.zeros(qmat.shape[1], dtype=I32, device=qmat.device)
    s = B // 2
    while s >= 1:
        h = hkeys[:, torch.clamp(start + pos + (s - 1), 0, size - 1)]
        lt, _ = _lex_lt_eq(h, qmat)
        pos = pos + lt.to(I32) * s
        s //= 2
    _, eq = _lex_lt_eq(hkeys[:, torch.clamp(start + pos, 0, size - 1)], qmat)
    return pos, eq.to(I32)


def _fence_rank(fences, qmat):
    """Block id of each query key: index of the last fence <= key."""
    lb = _lower_rank(fences, qmat)
    _, eq = _lex_lt_eq(fences[:, torch.clamp(lb, 0, fences.shape[1] - 1)], qmat)
    return lb + eq.to(I32) - 1


def _resolve_block_kernel_impl(hmat, counts, btree, fences, n, fused, *,
                               lay: FusedLayout, K: int, NB: int, B: int):
    """Batch-scaled resolve over the block-sparse state (tpu.py:690): the
    decode, the rank probe, phase 1 via in-block gathers and the
    block-max segment tree, phase 2 shared with the dense kernel, phase 3
    a superset merge confined to the K gathered (touched) blocks. On the
    card five kernel launches (block.py's decode, phase 1 and phase 3,
    probe.py's probe, phase2.py's rounds) and phase 2's geometry ops.

    hmat, counts and btree are updated IN PLACE (JAX donated them) and
    returned; returns (hmat, counts, btree, n', st_aux)."""
    W = lay.n_words
    (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn, w_valid,
     too_old, version, _oldest_eff, nr, nw) = block.decode_fused(
         fused, lay=lay)
    g_ids = fused[lay.total: lay.total + K]
    n_g = fused[lay.total + K]

    # ---- block ranks for every sorted endpoint: the probe kernel ----
    bid, lb_loc, eq_loc = probe_ranks(hmat[: W + 1], fences, smat, NB=NB, B=B)

    # ============ Phase 1: read-vs-history ============
    base_conf = block.phase1(hmat[W + 1], btree, bid, lb_loc, eq_loc,
                             q_begin, q_end, rsnap, rtxn, too_old, NB=NB, B=B)

    # ============ Phase 2: intra-batch fixed point (shared) ============
    conflict, p2_iters = _phase2_fixed_point(
        base_conf, smat=smat, q_begin=q_begin, q_end=q_end,
        s_begin=s_begin, s_end=s_end, rtxn=rtxn, wtxn=wtxn,
        w_valid=w_valid, T=lay.T, Wr=lay.Wr, P2=lay.P2,
    )

    # ============ Phase 3: touched-block superset merge ============
    n_out, st_aux = block.phase3(
        hmat, counts, btree, n, smat=smat, s_begin=s_begin, s_end=s_end,
        wtxn=wtxn, w_valid=w_valid, nw=nw, conflict=conflict,
        too_old=too_old, p2_iters=p2_iters, bid=bid, lb_loc=lb_loc,
        eq_loc=eq_loc, g_ids=g_ids, n_g=n_g, version=version, K=K, NB=NB,
        B=B)
    return hmat, counts, btree, n_out, st_aux


def _compact_resolve_impl(hmat, counts, fused, *, lay: FusedLayout,
                          NB: int, NB_out: int, B: int):
    """Amortized compaction + resolve (tpu.py:924): densify, drop superset
    duplicates (last wins), run the DENSE kernel, redistribute into NB_out
    blocks at fill B//2 and rebuild the directory (compact.densify, the
    dense kernel, compact.redistribute: on the card six kernel launches
    and phase 2's geometry ops). hmat (W+2, NB*B) and counts (NB,) are
    the block state. Returns (hmat', counts', btree', fences', n',
    st_aux), all fresh tensors."""
    if hmat.shape[1] != NB * B:
        raise ValueError(f"hmat has {hmat.shape[1]} columns, NB*B = {NB * B}")
    dense2, m2 = compact.densify(hmat, counts, B=B)
    hmat_d, new_n, st_aux = _resolve_kernel_impl(dense2, m2, fused, lay=lay)
    out, counts_o, bt, fences_o = compact.redistribute(
        hmat_d, new_n, st_aux, NB_out=NB_out, B=B)
    return out, counts_o, bt, fences_o, new_n, st_aux


def _touched_blocks(fences_enc: np.ndarray, wb_enc, we_enc, nw: int):
    """Rank a batch's write endpoints against a host fence mirror: returns
    (touched block ids, pessimistic per-block insert bound)."""
    nbl = len(fences_enc)
    if not nw:
        return np.zeros(0, dtype=np.int64), np.zeros(nbl, dtype=np.int64)
    enc = np.concatenate([wb_enc, we_enc])
    bids = np.searchsorted(fences_enc, enc, side="right").astype(np.int64) - 1
    _, uix = np.unique(enc, return_index=True)
    inc = np.bincount(bids[uix], minlength=nbl)
    a = np.searchsorted(fences_enc, wb_enc, side="left")
    b = np.searchsorted(fences_enc, we_enc, side="right")
    cov = np.zeros(nbl + 1, dtype=np.int64)
    np.add.at(cov, a, 1)
    np.add.at(cov, np.maximum(a, b - 1), -1)
    covered = np.nonzero(np.cumsum(cov[:nbl]) > 0)[0]
    touched = np.unique(np.concatenate([bids, covered]))
    return touched, inc


def needs_compaction(since_compact: int, version_off: int, n_touched: int,
                     fills, incs, n_writes, NB: int, B: int) -> bool:
    """Whether a batch takes the compaction instead of the fast step: the
    compaction cadence, a version offset near the int32 limit, more
    touched blocks than the cap, or, in any shard (fills, incs and
    n_writes hold one entry per shard; a lone set is one shard), a block
    whose pessimistic insert bound passes B - 1 or a fill that could pass
    the capacity."""
    return (
        since_compact + 1 >= SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
        or version_off >= 1 << 30
        or next_bucket(max(n_touched, 1))
        > SERVER_KNOBS.TPU_MAX_TOUCHED_BLOCKS
        or any(
            bool(np.any(f[: len(inc)] + inc > B - 1))
            or int(f.sum()) + 2 * nw + 1 >= NB * B
            for f, inc, nw in zip(fills, incs, n_writes)
        )
    )


def compacted_blocks(m_pred: int, F: int, min_NB: int, NB: int) -> int:
    """NB after a compaction: room for m_pred entries at fill F with at
    least one pad fence, no fewer than min_NB, and NB kept where it would
    shrink less than 4x (hysteresis)."""
    NB_out = max(next_pow2(max(-(-(m_pred + 1) // F) + 1, 8)), min_NB)
    if NB_out < NB and NB_out * 4 > NB:
        NB_out = NB
    return NB_out


def rebase_snapshots(buf: np.ndarray, lay: FusedLayout, delta: int) -> None:
    """Move a packed batch's snapshots from its packing base to the
    device base (delta = packing base - device base), in place."""
    if delta:
        buf[lay.off_tsnap: lay.off_tsnap + lay.T] += delta


def block_step_buf(buf: np.ndarray, lay: FusedLayout, touched, K: int,
                   NB: int, version_off: int, oldest_off: int,
                   delta: int) -> np.ndarray:
    """The fast step's fused buffer: the packed batch, the touched-block
    gather vector padded with NB up to K (the kernel redirects pad rows to
    an untouched block), the touched count, the step's scalars, and the
    snapshots rebased by delta."""
    g = np.full(K, NB, dtype=np.int32)
    g[: len(touched)] = touched
    buf2 = np.concatenate([buf, g, np.array([len(touched)], dtype=np.int32)])
    buf2[lay.off_scalars] = version_off
    buf2[lay.off_scalars + 1] = oldest_off
    rebase_snapshots(buf2, lay, delta)
    return buf2


def fence_mirror(fw: np.ndarray, n_words: int, nbl: int) -> np.ndarray:
    """The host fence mirror: the first nbl fences of fw (n_words + 1,
    NB), encoded."""
    return encode_packed_words(fw[:n_words, :nbl].T, fw[n_words, :nbl])


def widen_fences(fw: np.ndarray, n_words: int, new_words: int) -> np.ndarray:
    """Fence columns fw (..., n_words + 1, NB) at a wider key width: a
    live fence gains biased zero words, a pad fence pad words."""
    live = fw[..., n_words, :] != INT32_MAX
    extra = np.where(
        live[..., None, :],
        np.int32(np.uint32(BIAS).view(np.int32)),  # biased zero word
        np.int32(PAD_WORD),
    )
    return np.concatenate(
        [
            fw[..., :n_words, :],
            np.broadcast_to(
                extra, fw.shape[:-2] + (new_words - n_words, fw.shape[-1])
            ),
            fw[..., n_words:, :],
        ],
        axis=-2,
    )


def canonical_entries(hmat: np.ndarray, counts: np.ndarray, n_words: int,
                      B: int, base: int, oldest_version: int):
    """Canonicalize a block-sparse state's host copy into the oracle's
    entries() form: absolute versions, stale clamp vs the logical horizon,
    duplicate keys last-wins, equal-value coalesce."""
    NB = counts.shape[0]
    W = n_words
    k = np.arange(NB).repeat(B)
    j = np.tile(np.arange(B), NB)
    cols = np.nonzero(j < counts[k])[0]  # block order == key order
    kw = hmat[:W, cols]
    lens = hmat[W, cols]
    v = hmat[W + 1, cols].astype(np.int64)
    absv = np.where(v > 0, v + base, 0)
    absv = np.where(absv <= oldest_version, 0, absv)
    enc = encode_packed_words(kw.T, lens)
    last = np.concatenate([enc[1:] != enc[:-1], [True]])
    kw, lens, absv = kw[:, last], lens[last], absv[last]
    keep = np.concatenate([[True], absv[1:] != absv[:-1]])
    idx = np.nonzero(keep)[0]
    return [
        (unpack_key(kw[:, i], int(lens[i])), int(absv[i])) for i in idx
    ]


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A fresh int32 tensor on `device` (always a copy: the state is
    updated in place and must never alias the caller's array). On the
    card the copy goes through pinned memory with non_blocking: a copy
    from pageable memory would block the host, and block growth calls
    this inside submit."""
    src = torch.from_numpy(np.array(arr, dtype=np.int32, order="C"))
    if device.type != "cuda":
        return src
    return src.pin_memory().to(device, non_blocking=True)


def upload(buf: np.ndarray, device: torch.device):
    """One H2D of a fused buffer: (device tensor, pinned source to keep
    alive until the copy completes, or None)."""
    src = torch.from_numpy(buf)
    if device.type != "cuda":
        return src, None
    src = src.pin_memory()
    return src.to(device, non_blocking=True), src


def _start_d2h(st_aux: torch.Tensor):
    """Begin the verdict bytes' D2H right after their dispatch: (host
    tensor, CUDA event marking the copy's completion or None on the CPU)."""
    if st_aux.device.type != "cuda":
        return st_aux, None
    host = torch.empty(st_aux.shape, dtype=st_aux.dtype, pin_memory=True)
    host.copy_(st_aux, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(st_aux.device))
    return host, ev


class PendingResolve:
    """Handle to an in-flight resolve: dispatch returned without waiting;
    result() waits for this resolve's verdict bytes and checks the
    invariants. `_keep` holds the pinned H2D source until the copy is done
    (the event orders after it)."""

    def __init__(self, cs: "ConflictSetGPU", st_aux, n_txns: int,
                 t_pad: int, seq: int, extra_snapshot: int, keep=None):
        self._cs = cs
        self._st_aux = st_aux
        self._host, self._event = _start_d2h(st_aux)
        self._keep = keep
        self.n_txns = n_txns
        self._t_pad = t_pad
        self._seq = seq
        self._extra_snapshot = extra_snapshot

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._keep = None

    def result(self) -> np.ndarray:
        self.wait()
        return self._finish(self._host.numpy())

    def _finish(self, arr: np.ndarray) -> np.ndarray:
        st = arr[: self.n_txns]
        u = arr[self._t_pad: self._t_pad + 4].view(np.uint8).astype(np.uint32)
        new_n = int(u[0] | (u[1] << 8) | (u[2] << 16) | (u[3] << 24))
        overflow = bool(arr[self._t_pad + 4])
        self._cs.last_p2_iters = int(arr[self._t_pad + 5])
        if overflow:  # pragma: no cover - host pre-growth makes this dead
            # The kernel output (already installed for pipelining) dropped
            # entries past capacity; poison the set so every later resolve
            # fails fast.
            self._cs._poisoned = True
            raise RuntimeError(
                "conflict set overflow despite pre-growth bound "
                f"(new_n={new_n}, capacity={self._cs.capacity}); "
                "conflict set is poisoned"
            )
        # Refresh the host-side pessimistic bound with this exact count;
        # stale (out-of-order) results must not regress the refresh.
        cs = self._cs
        if self._seq > cs._result_seq:
            cs._result_seq = self._seq
            cs._n_known = new_n
            cs._result_cum = self._extra_snapshot
        return st


def collect_results(handles: Sequence[PendingResolve]) -> list[np.ndarray]:
    """Results of several in-flight resolves: wait on each one's D2H event
    (the copies were started at dispatch), then finish them in order."""
    out = []
    for h in handles:
        h.wait()
    for h in handles:
        out.append(h._finish(h._host.numpy()))
    return out


def _pc() -> float:
    """Stage-timing read (telemetry only; never enters control flow)."""
    return time.perf_counter()


def _precede(chunk, version: int):
    """`chunk` (txn objects or a WireBatch) with every read snapshot at or
    past `version` lowered to version - 1. A later chunk of a batch sees
    the earlier chunks' committed writes as history stamped `version`, and
    a read conflicts with history written after its snapshot: a snapshot
    at the batch's own version (a lag of 0, which config 5's generator
    draws) would miss the intra-batch conflict that one unchunked batch
    (and the oracle) reports. No write of an earlier batch is newer than
    version - 1, so nothing else changes, and tooOld (a snapshot below the
    oldest version, itself below `version`) stays as it was."""
    from .wire import WireBatch

    if isinstance(chunk, WireBatch):
        if chunk.n_txns and int(chunk.snaps.max()) >= version:
            chunk = dataclasses.replace(
                chunk, snaps=np.minimum(chunk.snaps, version - 1))
        return chunk
    if any(t.read_snapshot >= version for t in chunk):
        chunk = [TxnConflictInfo(min(t.read_snapshot, version - 1),
                                 t.read_ranges, t.write_ranges)
                 for t in chunk]
    return chunk


class ResolveHandle:
    """One submitted batch in flight (ConflictSetGPU.submit): the chunked
    PendingResolves plus per-stage timing. Consume exactly once with
    ConflictSetGPU.verdicts(). `p2_syncs` counts the host reads phase 2
    made while this batch was dispatched: 0 on the card, the plain
    version's group reads on the CPU."""

    __slots__ = ("chunks", "n_txns", "version", "pack_ms", "dispatch_ms",
                 "device_ms", "d2h_ms", "depth_at_submit", "consumed",
                 "p2_syncs")

    def __init__(self, chunks, n_txns: int, version: int,
                 pack_ms: float, dispatch_ms: float, depth_at_submit: int,
                 p2_syncs: int = 0):
        self.chunks = chunks          # [(chunk_n_txns, PendingResolve)]
        self.n_txns = n_txns
        self.version = version
        self.pack_ms = pack_ms
        self.dispatch_ms = dispatch_ms
        self.device_ms = None         # set at consumption
        self.d2h_ms = None
        self.depth_at_submit = depth_at_submit
        self.consumed = False
        self.p2_syncs = p2_syncs


class ConflictSetGPU:
    """Device-resident BLOCK-SPARSE conflict set (ConflictSetCPU contract),
    the counterpart of tpu.ConflictSetTPU with the same state, attributes
    and host mirror:

      hmat    (n_words+2, NB*B)  key words, key length, version offset
      counts  (NB,)              live entries per block (<= B-1)
      fences  (n_words+1, NB)    each block's minimum live key
      btree   (2*NB,)            segment tree over per-block version maxes
      n       0-d                total live entries (superset count)

    `device=None` means the CUDA card; without one it raises unless the
    caller passes device="cpu".
    """

    def __init__(
        self,
        init_version: int = 0,
        max_key_bytes: int = 32,
        initial_capacity: int = 1024,
        min_capacity: int = 64,
        block_slots: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_words = max(1, (max_key_bytes + 3) // 4)
        self.max_key_bytes = 4 * self.n_words
        self.B = next_pow2(
            int(block_slots or SERVER_KNOBS.TPU_BLOCK_SLOTS), minimum=8
        )
        self.F = self.B // 2
        self.NB = next_pow2(max(initial_capacity, 1) // self.B, minimum=8)
        self.min_NB = min(
            next_pow2(max(min_capacity, 1) // self.B, minimum=8), self.NB
        )
        self.oldest_version = 0  # logical horizon (absolute)
        self._base = 0           # device version-offset base (absolute)
        if not (0 <= init_version < 2**31):
            raise ValueError("init_version must fit the initial int32 window")
        hmat, counts, fences, btree = empty_block_state(
            self.n_words, self.NB, self.B, init_version
        )
        self.hmat = self._dev(hmat)
        self.counts = self._dev(counts)
        self.fences = self._dev(fences)
        self.btree = self._dev(btree)
        self.n = torch.tensor(1, dtype=I32, device=self.device)
        w0, l0 = pack_keys([b""], self.n_words)
        self._fences_enc = encode_packed_words(w0, l0)
        self._fills = np.zeros(self.NB, dtype=np.int64)
        self._fills[0] = 1
        self._since_compact = 0
        self._init_host_state()

    def _init_host_state(self) -> None:
        self._pending_mirror = None  # (fences_dev, counts_dev) after compact
        self._sticky = StickyCaps()
        self._n_known = 1     # last exact count read back from device
        self._cum_writes = 0  # 2*writes over ALL dispatches (monotone)
        self._result_cum = 0  # _cum_writes snapshot at last-applied result
        self._dispatch_seq = 0
        self._result_seq = 0
        self._poisoned = False
        self.last_p2_iters = None  # phase-2 rounds of the last resulted batch
        self.inflight = 0
        self.max_inflight = 0
        # Dispatch counts by path (telemetry): compaction passes and
        # batch-scaled fast resolves.
        self.compactions = 0
        self.fast_resolves = 0
        self.mirror_reads = 0  # fence/count readbacks (one host read each)

    @classmethod
    def from_state(cls, state: dict, device=None) -> "ConflictSetGPU":
        """Rebuild a set from another implementation's state (plain numpy
        arrays and ints): hmat, counts, fences, btree, n, NB, B, n_words,
        _base, oldest_version, _since_compact and the host mirror
        _fences_enc/_fills (optional: min_NB). A JAX ConflictSetTPU handed
        over mid-stream (with its mirror refreshed) continues identically."""
        cs = cls.__new__(cls)
        cs.device = resolve_device(device)
        cs.n_words = int(state["n_words"])
        cs.max_key_bytes = 4 * cs.n_words
        cs.B = int(state["B"])
        cs.F = cs.B // 2
        cs.NB = int(state["NB"])
        cs.min_NB = int(state.get("min_NB", min(8, cs.NB)))
        cs.oldest_version = int(state["oldest_version"])
        cs._base = int(state["_base"])
        cs.hmat = cs._dev(state["hmat"])
        cs.counts = cs._dev(state["counts"])
        cs.fences = cs._dev(state["fences"])
        cs.btree = cs._dev(state["btree"])
        if tuple(cs.hmat.shape) != (cs.n_words + 2, cs.NB * cs.B):
            raise ValueError(f"hmat shape {tuple(cs.hmat.shape)} does not "
                             f"match n_words={cs.n_words}, NB*B={cs.NB * cs.B}")
        cs.n = torch.tensor(int(state["n"]), dtype=I32, device=cs.device)
        cs._fences_enc = np.asarray(state["_fences_enc"]).copy()
        cs._fills = np.asarray(state["_fills"], dtype=np.int64).copy()
        cs._since_compact = int(state["_since_compact"])
        cs._init_host_state()
        cs._n_known = int(state["n"])
        return cs

    def _dev(self, arr) -> torch.Tensor:
        return to_device(arr, self.device)

    # -- introspection --

    @property
    def capacity(self) -> int:
        return self.NB * self.B

    def __len__(self) -> int:
        return int(self.n)

    @property
    def _n_extra(self) -> int:
        return self._cum_writes - self._result_cum

    @property
    def _n_bound(self) -> int:
        return min(self.capacity, self._n_known + self._n_extra)

    def entries(self) -> list[tuple[bytes, int]]:
        """Host copy of the live step function, ABSOLUTE versions,
        canonicalized (bit-identical to the oracle's entries())."""
        return canonical_entries(
            self.hmat.cpu().numpy(), self.counts.cpu().numpy(), self.n_words,
            self.B, self._base, self.oldest_version,
        )

    # -- host mirror --

    def _refresh_mirror(self) -> None:
        """Materialize a compaction's fence/count readback into the host
        mirror (one small D2H per compaction, paid lazily here)."""
        if self._pending_mirror is None:
            return
        fences_dev, counts_dev = self._pending_mirror
        self._pending_mirror = None
        self.mirror_reads += 1
        # One D2H for both: counts, then the fence matrix row-major.
        both = torch.cat([counts_dev, fences_dev.reshape(-1)]).cpu().numpy()
        nb = counts_dev.shape[0]
        counts, fw = both[:nb], both[nb:].reshape(self.n_words + 1, nb)
        self._fences_enc = fence_mirror(fw, self.n_words,
                                        int((counts > 0).sum()))
        self._fills = counts.astype(np.int64)

    # -- growth --

    def _grow_blocks(self, NB_out: int) -> None:
        pad = (NB_out - self.NB) * self.B
        self.hmat = torch.cat(
            [self.hmat, self._dev(state_pad_block(self.n_words, pad))], dim=1
        )
        self.counts = torch.cat([
            self.counts,
            torch.zeros(NB_out - self.NB, dtype=I32, device=self.device),
        ])
        self._fills = np.concatenate(
            [self._fills, np.zeros(NB_out - self.NB, dtype=np.int64)]
        )
        # fences/btree are rebuilt by the compaction this growth precedes.
        self.NB = NB_out

    def _grow_width(self, min_key_bytes: int) -> None:
        """Re-pack the resident history at a wider key width, bounded by
        the key-size knob."""
        cap = CLIENT_KNOBS.KEY_SIZE_LIMIT + 1
        if min_key_bytes > cap:
            raise KeyWidthError(
                f"key of {min_key_bytes} bytes exceeds the deployment "
                f"key-size limit {cap}"
            )
        self._refresh_mirror()
        new_words = min(
            next_pow2((min_key_bytes + 3) // 4, minimum=self.n_words * 2),
            next_pow2((cap + 3) // 4),
        )
        self.hmat = self._dev(
            widen_state(self.hmat.cpu().numpy(), self.n_words, new_words)
        )
        fw = self.fences.cpu().numpy()
        fw2 = widen_fences(fw, self.n_words, new_words)
        self.fences = self._dev(fw2)
        self.n_words = new_words
        self.max_key_bytes = 4 * new_words
        self._fences_enc = fence_mirror(
            fw2, new_words, int((fw[-1] != INT32_MAX).sum())
        )

    # -- resolution --

    def resolve_async(
        self, version: int, new_oldest_version: int, pb: PackedBatch
    ) -> PendingResolve:
        if self._poisoned:
            raise RuntimeError("conflict set is poisoned by a prior overflow")
        if pb.base != self.oldest_version:
            raise ValueError(
                f"batch packed at base {pb.base} but conflict set is at "
                f"oldest_version {self.oldest_version}"
            )
        if pb.layout.n_words != self.n_words:
            raise ValueError("batch packed with a different key width")
        oldest_eff = max(self.oldest_version, new_oldest_version)
        if not (0 <= version - self.oldest_version < 2**31):
            raise ValueError(
                "resolve version outside the int32 window relative to "
                f"oldest_version {self.oldest_version}"
            )
        self._refresh_mirror()
        lay = pb.layout
        nw = pb.n_writes
        nbl = len(self._fences_enc)

        # Touched blocks + the pessimistic per-block insert bound.
        touched, inc = _touched_blocks(self._fences_enc, pb.wb_enc,
                                       pb.we_enc, nw)

        need_slow = needs_compaction(
            self._since_compact, version - self._base, len(touched),
            [self._fills], [inc], [nw], self.NB, self.B,
        )
        delta = pb.base - self._base

        if need_slow:
            # Amortized compaction + dense resolve.
            NB_out = compacted_blocks(int(self._fills.sum()) + 2 * nw,
                                      self.F, self.min_NB, self.NB)
            if NB_out > self.NB:
                self._grow_blocks(NB_out)
            pb.set_scalars(version - self._base, oldest_eff - self._base)
            rebase_snapshots(pb.buf, lay, delta)
            fused, keep = upload(pb.buf, self.device)
            out = _compact_resolve_impl(
                self.hmat, self.counts, fused, lay=lay, NB=self.NB,
                NB_out=NB_out, B=self.B,
            )
            self.hmat, self.counts, self.btree, self.fences, self.n, st_aux = out
            self.NB = NB_out
            self._base = oldest_eff
            self._since_compact = 0
            self.compactions += 1
            self._pending_mirror = (self.fences, self.counts)
            self._fills = None  # stale until _refresh_mirror
        else:
            k_nat = next_bucket(max(len(touched), 1))
            K = min(max(k_nat, self._sticky.k_cap_for(pb.n_txns)), self.NB)
            self._sticky.update_k(pb.n_txns, min(k_nat, self.NB))
            buf2 = block_step_buf(pb.buf, lay, touched, K, self.NB,
                                  version - self._base,
                                  oldest_eff - self._base, delta)
            fused, keep = upload(buf2, self.device)
            out = _resolve_block_kernel_impl(
                self.hmat, self.counts, self.btree, self.fences, self.n,
                fused, lay=lay, K=K, NB=self.NB, B=self.B,
            )
            self.hmat, self.counts, self.btree, self.n, st_aux = out
            self._fills[:nbl] += inc
            self._since_compact += 1
            self.fast_resolves += 1

        self._cum_writes += 2 * nw
        self._dispatch_seq += 1
        self.oldest_version = oldest_eff
        return PendingResolve(
            self, st_aux, pb.n_txns, lay.T, self._dispatch_seq,
            self._cum_writes, keep=keep,
        )

    def resolve_packed(
        self, version: int, new_oldest_version: int, pb: PackedBatch
    ) -> np.ndarray:
        return self.resolve_async(version, new_oldest_version, pb).result()

    def pack(self, txns: Sequence[TxnConflictInfo]) -> PackedBatch:
        """Pack a batch against this set's base, width and sticky caps."""
        pb = pack_batch(
            txns, self.oldest_version, self.n_words,
            caps=self._sticky.caps_for(len(txns)),
        )
        self._sticky.update(pb)
        return pb

    def _chunks(self, txns: Sequence[TxnConflictInfo]):
        """Split a batch into chunks bounded by the knob caps (txn count and
        total range count); chunked resolution at one version is exact
        once every later chunk's snapshots precede the version
        (_precede)."""
        max_txns = SERVER_KNOBS.TPU_MAX_CHUNK_TXNS
        max_ranges = SERVER_KNOBS.TPU_MAX_CHUNK_RANGES
        out: list[list[TxnConflictInfo]] = []
        cur: list[TxnConflictInfo] = []
        cur_ranges = 0
        for t in txns:
            nr = len(t.read_ranges) + len(t.write_ranges)
            if cur and (len(cur) >= max_txns or cur_ranges + nr > max_ranges):
                out.append(cur)
                cur = []
                cur_ranges = 0
            cur.append(t)
            cur_ranges += nr
        if cur or not out:
            out.append(cur)
        return out

    def submit(self, version: int, new_oldest_version: int, batch
               ) -> ResolveHandle:
        """Dispatch one batch (txn objects OR a wire.WireBatch): width
        admission, chunking, packing, and every chunk's H2D + resolve are
        enqueued; the handle returns without waiting for the verdicts.
        Consume with verdicts()."""
        from .wire import WireBatch, chunk_bounds, pack_wire

        syncs0 = P2_SYNCS
        if isinstance(batch, WireBatch):
            longest = batch.max_key_len()
            if longest > self.max_key_bytes:
                self._grow_width(longest)
            bounds = chunk_bounds(
                batch, SERVER_KNOBS.TPU_MAX_CHUNK_TXNS,
                SERVER_KNOBS.TPU_MAX_CHUNK_RANGES,
            )
            chunks = [
                batch.slice(bounds[i], bounds[i + 1])
                for i in range(len(bounds) - 1)
            ] or [batch]
            sizes = [c.n_txns for c in chunks]

            def packer(ch):
                return pack_wire(
                    ch, self.oldest_version, self.n_words, self._sticky
                )
        else:
            # Width admission happens ONCE, up front, over the rows the
            # packer keeps (a failed batch commits nothing).
            longest = 0
            for t in batch:
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
            chunks = self._chunks(batch)
            sizes = [len(c) for c in chunks]
            packer = self.pack

        pending = []
        pack_ms = dispatch_ms = 0.0
        for i, ch in enumerate(chunks):
            tp = _pc()
            if i:
                ch = _precede(ch, version)
            pb = packer(ch)
            td = _pc()
            pack_ms += (td - tp) * 1e3
            last = i == len(chunks) - 1
            h = self.resolve_async(
                version,
                new_oldest_version if last else self.oldest_version,
                pb,
            )
            dispatch_ms += (_pc() - td) * 1e3
            pending.append((sizes[i], h))
        self.inflight += 1
        self.max_inflight = max(self.max_inflight, self.inflight)
        return ResolveHandle(
            pending, sum(sizes), version, pack_ms, dispatch_ms,
            self.inflight, p2_syncs=P2_SYNCS - syncs0,
        )

    def verdicts(self, handle: ResolveHandle) -> list[int]:
        """Consume one in-flight batch: the designated host-sync site.
        Waits for the batch's verdict bytes, then finishes every chunk."""
        if handle.consumed:
            raise RuntimeError("verdicts() consumed twice for one handle")
        t0 = _pc()
        for _, h in handle.chunks:
            h.wait()
        t1 = _pc()
        sts = collect_results([h for _, h in handle.chunks])
        t2 = _pc()
        handle.device_ms = (t1 - t0) * 1e3
        handle.d2h_ms = (t2 - t1) * 1e3
        handle.consumed = True
        self.inflight -= 1
        out: list[int] = []
        for st in sts:
            out.extend(int(s) for s in st)
        return out

    def resolve(
        self,
        version: int,
        new_oldest_version: int,
        txns: Sequence[TxnConflictInfo],
    ) -> ConflictBatchResult:
        """Synchronous resolve = submit + immediate verdicts."""
        return ConflictBatchResult(
            self.verdicts(self.submit(version, new_oldest_version, txns))
        )

    def warmup(self, shapes: Sequence[tuple[int, int, int]] | None = None,
               footprint: tuple[int, int] = (5, 2)) -> None:
        """Run both resolve paths once per (n_txns, n_reads, n_writes)
        padded bucket (default: SERVER_KNOBS.TPU_BATCH_BUCKETS at
        `footprint` = (reads, writes) per txn) — the kernel build and the
        allocator's first allocations land here, not on the commit path —
        then restore the full host+device state."""
        if shapes is None:
            fr, fw = footprint
            shapes = [
                (b, fr * b, fw * b) for b in SERVER_KNOBS.TPU_BATCH_BUCKETS
            ]
        self._refresh_mirror()
        # Host copies: the fast path updates the state tensors in place.
        saved_dev = (self.hmat.cpu().numpy().copy(),
                     self.counts.cpu().numpy().copy(),
                     self.btree.cpu().numpy().copy(),
                     self.fences.cpu().numpy().copy(), int(self.n))
        saved = (self.NB, self._base, self.oldest_version,
                 self._fences_enc, self._fills.copy(), self._since_compact,
                 self._n_known, self._cum_writes, self._result_cum,
                 self._dispatch_seq, self._result_seq)
        for (t, r, w) in shapes:
            for force_slow in (True, False):
                batch = pack_batch(
                    [], self.oldest_version, self.n_words,
                    caps=(max(r, 1), max(w, 1), max(t, 1)),
                )
                self._sticky.seed(batch.layout)
                if force_slow:
                    self._since_compact = 10**9
                self.resolve_packed(self.oldest_version, 0, batch)
                self._refresh_mirror()
                self.hmat, self.counts, self.btree, self.fences = (
                    self._dev(a) for a in saved_dev[:4]
                )
                self.n = torch.tensor(saved_dev[4], dtype=I32, device=self.device)
                (self.NB, self._base, self.oldest_version,
                 self._fences_enc, fills, self._since_compact,
                 self._n_known, self._cum_writes, self._result_cum,
                 self._dispatch_seq, self._result_seq) = saved
                self._fills = fills.copy()
                self._pending_mirror = None
