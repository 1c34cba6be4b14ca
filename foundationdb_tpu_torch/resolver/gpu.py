"""Batched conflict detection on the CUDA card — the port's main path.

The torch counterpart of foundationdb_tpu/resolver/tpu.py: the same
block-sparse resident history (NB blocks of B sorted slots, a fence
directory, a block-max segment tree), the same batch-scaled fast resolve,
the same amortized compaction through the dense kernel, the same host
mirror and the same submit/verdicts contract. Function names match
tpu.py one for one, so each has an obvious twin; the module docstring of
tpu.py explains the algorithm and its invariants.

What differs from the JAX package, and why:

- Plain torch ops on explicit devices instead of jit-compiled XLA. The
  JAX package left these functions to XLA (no Pallas), so they stay torch
  ops here; the one Pallas kernel, the rank probe, is a hand-written CUDA
  kernel (probe.py, csrc/probe.cu), called unconditionally by the block
  kernel's rank stage.
- JAX/torch semantic differences (scan dtype, scatter drops, gather
  clamps, int32 wrap, int8 bytes) go through resolver/_ops.py.
- The fast kernel updates the resident hmat/counts/btree IN PLACE where
  JAX donated those buffers (tpu.py:1105-1116), so the per-batch cost
  stays batch-scaled with no O(capacity) copy.
- Phase 2's `lax.while_loop` stops on a device boolean; torch eager cannot
  without a host read. The rounds run in groups under a device `active`
  flag (conflict and the round count freeze after the first unchanged
  round, so both stay bit-identical to JAX) with ONE `.item()` per group;
  P2_SYNCS counts them. Besides the mirror readback the next dispatch
  after a compaction makes (as tpu.py does), they are the only host syncs
  inside submit.
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
from ._ops import (
    I32,
    I32_INF,
    add_wrap_i32,
    cumsum32,
    dump_index,
    floor_log2,
    int8_twos,
    le_bytes,
    scatter_cols_new,
    scatter_new,
)
from .packing import (
    BIAS,
    INT32_MAX,
    MODE_EXPLICIT,
    MODE_INCREMENT,
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
from .probe import probe_ranks
from .types import COMMITTED, CONFLICT, TOO_OLD, ConflictBatchResult, TxnConflictInfo

P2_SYNCS = 0  # host reads made by phase 2's stopping rule (one per group)

# Phase-2 round groups: one host read after each group. Most batches settle
# in the first verification round (the pointer-jumping seed is exact on
# pure chains), so the groups start small and grow.
_P2_GROUPS = (1, 2, 4, 8)


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=dev)


def _pad_col(W: int, dev, with_value: bool = True) -> torch.Tensor:
    """One pad state column: +inf key words and length (and version 0).
    Built by device fills: a tensor made from host data would be a
    blocking copy, i.e. a host sync."""
    col = torch.full((W + 1,), I32_INF, dtype=I32, device=dev)
    if not with_value:
        return col
    return torch.cat([col, torch.zeros(1, dtype=I32, device=dev)])


def _lex_lt_eq(h, q, or_equal: bool = False):
    """Lexicographic h < q (or <=) over leading-axis word rows (at least
    one), decided at the first differing word: a fixed handful of ops at
    any width, where the JAX package's word loop takes 4 a word (the
    simulator's fuzzers write keys of up to 10,000 bytes, 2,501 words)."""
    ne = h != q
    eq = ~ne.any(0)
    first = ne.to(torch.uint8).argmax(0, keepdim=True)
    lt = torch.gather(h < q, 0, first)[0]
    if or_equal:
        lt = lt | eq
    return lt, eq


def _lower_rank(hkeys, qmat):
    """#entries of the sorted (C, +inf padded) key matrix strictly less than
    each query key: log C halving steps, one 2-D column gather each."""
    c = hkeys.shape[1]
    pos = torch.zeros(qmat.shape[1], dtype=I32, device=qmat.device)
    s = c // 2
    while s >= 1:
        h = hkeys[:, pos + (s - 1)]
        lt, _ = _lex_lt_eq(h, qmat)
        pos = pos + lt.to(I32) * s
        s //= 2
    return pos


def _build_table(v, op, identity: int):
    """(L, C) sparse range-query table: row m combines windows [i, i+2^m)."""
    c = v.shape[0]
    rows = [v]
    s = 1
    while s < c:
        prev = rows[-1]
        shifted = torch.cat(
            [prev[s:], torch.full((s,), identity, dtype=v.dtype, device=v.device)]
        )
        rows.append(op(prev, shifted))
        s *= 2
    return torch.stack(rows)


def _table_range_query(table, lo, hi, op, identity: int):
    """op-combine over [lo, hi) per query; empty ranges -> identity. Two
    gathers of overlapping power-of-two windows."""
    c = table.shape[1]
    length = (hi - lo).to(I32)
    m = floor_log2(torch.clamp(length, min=1))  # 31 - clz (hazard: no clz)
    window = torch.ones_like(m) << m
    flat = table.reshape(-1)
    base = m.to(torch.int64) * c
    got1 = flat[base + torch.clamp(lo, 0, c - 1)]
    got2 = flat[base + torch.clamp(hi - window, 0, c - 1)]
    return torch.where(hi > lo, op(got1, got2), identity)


def _canonical_nodes_flat(pos_lo, pos_hi, n_leaves: int):
    """Canonical segment-tree node ids of each [pos_lo, pos_hi) interval,
    flattened to 1-D (2*steps blocks of N), 0 marking unused slots (node 0
    is never a real node — root is 1). Pure integer arithmetic."""
    steps = n_leaves.bit_length()
    l = (pos_lo + n_leaves).to(I32)
    r = (pos_hi + n_leaves).to(I32)
    cols = []
    for _ in range(steps):
        active = l < r
        tl = active & ((l & 1) == 1)
        cols.append(torch.where(tl, l, 0))
        l = l + tl.to(I32)
        tr = active & ((r & 1) == 1)
        r = r - tr.to(I32)
        cols.append(torch.where(tr, r, 0))
        l = l >> 1
        r = r >> 1
    return torch.cat(cols), 2 * steps


def _decode_fused(fused, *, lay: FusedLayout):
    """Unpack + decode the compact fused buffer (packing.FusedLayout):
    sorted endpoint matrix, per-row txn ids/snapshots, write validity and
    the scalars (0-d tensors). Shared by the dense and block kernels."""
    W = lay.n_words
    P2, R, Wr, T = lay.P2, lay.R, lay.Wr, lay.T
    dev = fused.device
    W1 = W + 1

    def sl(off, size):
        return fused[off: off + size]

    rbk = sl(lay.off_rb, W1 * R).reshape(W1, R)
    wbk = sl(lay.off_wb, W1 * Wr).reshape(W1, Wr)
    q_begin = sl(lay.off_q_begin, R)
    q_end = sl(lay.off_q_end, R)
    s_begin = sl(lay.off_s_begin, Wr)
    s_end = sl(lay.off_s_end, Wr)
    tmeta = sl(lay.off_tmeta, T)
    tsnap = sl(lay.off_tsnap, T)
    version = fused[lay.off_scalars]
    oldest_eff = fused[lay.off_scalars + 1]
    nr = fused[lay.off_scalars + 2]
    nw = fused[lay.off_scalars + 3]

    def decode_cols(bk, ext, n_ext):
        """(begin, end) key columns (W1, count) of one row segment: pad
        sentinel -> +inf keys; ends derived per the mode bits (keyAfter /
        integer increment / explicit side table)."""
        count = bk.shape[1]
        lenf = bk[W]
        ln = lenf & 0x3FFF
        mode = lenf >> 14
        is_pad = ln == 0x3FFF
        bcol = torch.cat([bk[:W], torch.where(is_pad, I32_INF, ln)[None]], 0)
        # Integer increment: +1 with carry from the last word (biased int32
        # wraps exactly like the raw unsigned word; the wrap is explicit).
        # The carry into word j: every word after it is all ones.
        ones = torch.flip(torch.cumprod(
            torch.flip((bk[1:W] == I32_INF).to(I32), [0]), 0), [0])
        carry_in = torch.cat(
            [ones, torch.ones((1, count), dtype=I32, device=dev)], 0)
        inc = add_wrap_i32(bk[:W], carry_in)
        is_inc = (mode == MODE_INCREMENT)[None, :]
        ewords = torch.where(is_inc, inc, bk[:W])
        elen = torch.where(mode == MODE_INCREMENT, ln, ln + 1)
        if n_ext:
            is_ex = mode == MODE_EXPLICIT
            ex = is_ex.to(I32)
            eidx = cumsum32(ex) - ex
            ecols = ext[:, torch.clamp(eidx, 0, n_ext - 1)]
            ewords = torch.where(is_ex[None, :], ecols[:W], ewords)
            elen = torch.where(is_ex, ecols[W] & 0x3FFF, elen)
        ecol = torch.cat(
            [
                torch.where(is_pad[None, :], int(PAD_WORD), ewords),
                torch.where(is_pad, I32_INF, elen)[None],
            ],
            0,
        )
        return bcol, ecol

    re_ext = sl(lay.off_re_ext, W1 * lay.Er).reshape(W1, lay.Er) if lay.Er else None
    we_ext = sl(lay.off_we_ext, W1 * lay.Ew).reshape(W1, lay.Ew) if lay.Ew else None
    rb_col, re_col = decode_cols(rbk, re_ext, lay.Er)
    wb_col, we_col = decode_cols(wbk, we_ext, lay.Ew)

    # Sorted endpoint matrix: every sorted slot holds exactly one endpoint
    # (pads included), so four column scatters rebuild it.
    smat = _pad_col(W, dev, with_value=False)[:, None].expand(W1, P2 + 1).clone()
    for pos, col in ((q_begin, rb_col), (q_end, re_col),
                     (s_begin, wb_col), (s_end, we_col)):
        smat.index_copy_(1, dump_index(pos, P2), col)
    smat = smat[:, :P2].contiguous()

    # Per-row txn ids from per-txn counts; rows outside the live prefix
    # resolve to harmless values (snapshot +inf, validity False).
    rcount = tmeta & 0x7FFF
    wcount = (tmeta >> 15) & 0x7FFF
    too_old = ((tmeta >> 30) & 1).to(torch.bool)

    def row_txn(counts, size):
        starts = cumsum32(counts) - counts
        marks = scatter_new(size + 1, 0, starts, 1, "add")
        return torch.clamp(cumsum32(marks[:size]) - 1, 0, T - 1)

    rtxn = row_txn(rcount, R)
    wtxn = row_txn(wcount, Wr)
    rsnap = torch.where(_arange(R, dev) < nr, tsnap[rtxn], I32_INF)
    w_valid = _arange(Wr, dev) < nw
    return (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn,
            w_valid, too_old, version, oldest_eff, nr, nw)


def _phase2_fixed_point(base_conf, *, smat, q_begin, q_end, s_begin, s_end,
                        rtxn, wtxn, w_valid, T, Wr, P2):
    """Intra-batch fixed point (checkIntraBatchConflicts): the pointer-
    jumping seed, then the verification rounds until nothing changes (cap
    n_jump+T+2), exactly as tpu._phase2_fixed_point. Returns the per-txn
    conflict vector and the round count (0-d int32)."""
    global P2_SYNCS
    dev = base_conf.device
    inf = I32_INF
    is_wb = scatter_new(P2, 0, s_begin, 1, "set")
    wb_excl = cumsum32(is_wb) - is_wb   # #write-begins strictly before pos
    lo_r, hi_r = wb_excl[q_begin], wb_excl[q_end]
    rank_w = wb_excl[s_begin]             # rank of each write among wb's
    perm_w = scatter_new(Wr, 0, rank_w, _arange(Wr, dev), "set")
    wnodes, n_blocks = _canonical_nodes_flat(s_begin, s_end, P2)
    wnodes = wnodes.to(torch.int64)       # node 0 absorbs unused slots
    k_levels = P2.bit_length()
    anc = (q_begin[None, :] + P2) >> _arange(k_levels, dev)[:, None]

    def min_writer_per_read(wval):
        case_a = _table_range_query(
            _build_table(wval[perm_w], torch.minimum, inf),
            lo_r, hi_r, torch.minimum, inf,
        )
        tree_l = torch.full((2 * P2,), inf, dtype=I32, device=dev)
        tree_l.scatter_reduce_(0, wnodes, wval.repeat(n_blocks),
                               reduce="amin", include_self=True)
        stab = tree_l[anc].amin(dim=0)
        return torch.minimum(case_a, stab)

    # Pointer-doubling seed over the read -> min-potential-writer chain.
    pot = min_writer_per_read(torch.where(w_valid, wtxn, inf))
    pot = torch.where(pot < rtxn, pot, inf)
    parent = scatter_new(T + 1, inf, rtxn, pot, "min")[:T]
    has_par = parent < inf
    ptr = torch.cat([torch.where(has_par, parent, T),
                     torch.full((1,), T, dtype=I32, device=dev)])
    base_b = base_conf > 0
    a = torch.cat([torch.where(base_b, 0, 1).to(I32),
                   torch.zeros(1, dtype=I32, device=dev)])
    b = torch.cat([torch.where(base_b | has_par, 0, 1).to(I32),
                   torch.ones(1, dtype=I32, device=dev)])
    n_jump = max((T - 1).bit_length(), 1)
    for _ in range(n_jump):
        ap, bp = a[ptr], b[ptr]
        a, b, ptr = (torch.where(ap == 1, b, a), torch.where(bp == 1, b, a),
                     ptr[ptr])
    conflict = torch.maximum(base_conf, 1 - a[:T])

    def body(conflict):
        committed_w = w_valid & (conflict[wtxn] == 0)
        min_writer = min_writer_per_read(torch.where(committed_w, wtxn, inf))
        evidence = (min_writer < rtxn).to(I32)
        ev_txn = scatter_new(T, 0, rtxn, evidence, "max")
        return torch.maximum(base_conf, ev_txn)

    # lax.while_loop(changed & it < cap) in groups: a round applies only
    # while `active`, so conflict and `it` freeze after the first unchanged
    # round (or at the cap) exactly where the JAX loop stops.
    cap = n_jump + T + 2
    it = torch.full((), n_jump, dtype=I32, device=dev)
    active = torch.ones((), dtype=torch.bool, device=dev)
    group, left = 0, T + 2   # group index, rounds the cap still allows
    while left > 0:
        size = min(_P2_GROUPS[min(group, len(_P2_GROUPS) - 1)], left)
        for _ in range(size):
            new = body(conflict)
            changed = (new != conflict).any()
            conflict = torch.where(active, new, conflict)
            it = it + active.to(I32)
            active = active & changed & (it < cap)
        left -= size
        group += 1
        P2_SYNCS += 1
        if not bool(active.item()):
            break
    return conflict, it


def _st_aux(too_old, conflict, n_out, overflow, p2_iters):
    """The one verdict readback array: statuses ++ 4 LE bytes of n ++
    overflow ++ clamped phase-2 round count (tpu.py:631-650)."""
    statuses = torch.where(
        too_old, TOO_OLD, torch.where(conflict > 0, CONFLICT, COMMITTED)
    ).to(torch.int8)
    return torch.cat([
        statuses, le_bytes(n_out),
        overflow.to(torch.int8).reshape(1),
        int8_twos(torch.clamp(p2_iters, max=127)).reshape(1),
    ])


def _resolve_kernel_impl(hmat, n, fused, *, lay: FusedLayout):
    """One DENSE resolve step (full-history merge; the amortized compaction
    pass). hmat: (W+2, C) int32 state [words.., len, version]; n: live
    entry count; fused: the batch buffer. Returns (hmat_out, new_n,
    st_aux)."""
    W = lay.n_words
    C = hmat.shape[1]
    P2, Wr, T = lay.P2, lay.Wr, lay.T
    dev = hmat.device

    (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn, w_valid,
     too_old, version, oldest_eff, nr, nw) = _decode_fused(fused, lay=lay)

    hkeys = hmat[: W + 1]
    hv = hmat[W + 1]

    # ============ Ranks: one binary search + algebraic derivations ============
    lb = _lower_rank(hkeys, smat)                        # #h < key
    _, eq = _lex_lt_eq(hkeys[:, torch.clamp(lb, 0, C - 1)], smat)
    is_pad_q = smat[W] == int(INT32_MAX)
    ub = torch.where(is_pad_q, C, lb + eq.to(I32))        # #h <= key

    # ============ Phase 1: read-vs-history ============
    rank_e = lb[q_end]
    rank_b = ub[q_begin]
    vtab = _build_table(hv, torch.maximum, 0)
    hist_max = _table_range_query(vtab, rank_b - 1, rank_e, torch.maximum, 0)
    read_conf = (hist_max > rsnap).to(I32)
    hist_conf = scatter_new(T, 0, rtxn, read_conf, "max")
    base_conf = torch.maximum(hist_conf, too_old.to(I32))

    # ============ Phase 2: intra-batch fixed point ============
    conflict, p2_iters = _phase2_fixed_point(
        base_conf, smat=smat, q_begin=q_begin, q_end=q_end,
        s_begin=s_begin, s_end=s_end, rtxn=rtxn, wtxn=wtxn,
        w_valid=w_valid, T=T, Wr=Wr, P2=P2,
    )

    # ============ Phase 3: merge-by-rank + coalesce + compact ============
    committed_w = w_valid & (conflict[wtxn] == 0)
    M = 2 * Wr
    N3 = C + M

    is_w = scatter_new(P2, 0, torch.cat([s_begin, s_end]), 1, "set")
    w_rank = cumsum32(is_w) - is_w
    wb_slot = w_rank[s_begin]
    we_slot = w_rank[s_end]
    # ONE scatter carries everything per compacted endpoint, bit-packed:
    # bit0 committed, bit1 is-begin, bits2+ global sorted position.
    cw = committed_w.to(I32)
    packed_ep = scatter_new(
        M, 0, torch.cat([wb_slot, we_slot]),
        torch.cat([(s_begin << 2) + 2 + cw, (s_end << 2) + cw]), "set",
    )
    sidx = packed_ep >> 2
    is_begin_c = (packed_ep >> 1) & 1
    committed_c = packed_ep & 1
    cwb = committed_c & is_begin_c
    cwe = committed_c & (1 - is_begin_c)
    ub_c = ub[sidx]
    eq_c = eq[sidx]

    # Merge duality: #write-endpoints < hist[j] = #{p : ub_c[p] <= j}.
    cnt_ub = scatter_new(C + 1, 0, torch.clamp(ub_c, max=C), 1, "add")
    lbB = cumsum32(cnt_ub[:C])
    posA = _arange(C, dev) + lbB          # history -> merged
    posB = _arange(M, dev) + ub_c         # write endpoints -> merged

    kw_c = smat[:, sidx]                  # (W+1, M) keys + len
    zero1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same_w = torch.cat([zero1, (kw_c[:, 1:] == kw_c[:, :-1]).all(dim=0)])
    prev_is_ep = torch.cat([zero1, posB[1:] == posB[:-1] + 1])
    same_prev_ep = torch.where(prev_is_ep, same_w, eq_c & (ub_c > 0))

    # Bit-packed merged planes, ONE scatter over all N3 slots: bit0
    # is_hist, bit1 cwb, bit2 cwe, bit3 same_prev, bits4+ source column in
    # the concatenated [history | sorted endpoints] key matrix.
    iota_c = _arange(C, dev)
    val_a = (iota_c < n).to(I32) + (iota_c << 4)
    val_b = ((cwb << 1) + (cwe << 2) + (same_prev_ep.to(I32) << 3)
             + ((C + sidx) << 4))
    merged = scatter_new(N3, 0, torch.cat([posA, posB]),
                         torch.cat([val_a, val_b]), "set")
    is_h_m = merged & 1
    cwb_m = (merged >> 1) & 1
    cwe_m = (merged >> 2) & 1
    same_prev_m = ((merged >> 3) & 1).to(torch.bool)
    src_m = merged >> 4

    cum_h = cumsum32(is_h_m)
    cum_wb = cumsum32(cwb_m)
    cum_we = cumsum32(cwe_m)

    # Runs of equal keys: segment ends via a reversed running minimum.
    iota = _arange(N3, dev)
    is_start = ~same_prev_m
    ns = torch.cummin(torch.where(is_start, iota, N3).flip(0), 0).values.flip(0)
    next_start = torch.cat([ns[1:], torch.full((1,), N3, dtype=I32, device=dev)])
    end_idx = next_start - 1

    at_end = torch.stack([cum_h, cum_wb, cum_we])[:, end_idx]
    covered = at_end[1] > at_end[2]
    old_val = hv[torch.clamp(at_end[0] - 1, 0, C - 1)]
    val = torch.where(covered, version, old_val)
    # Stale clamp + rebase to the new base (= absolute oldest_eff); the
    # clamp is inclusive, as in ConflictSetCPU._gc.
    val = torch.where(val <= oldest_eff, 0, val - oldest_eff)

    valid_pt = is_h_m | cwb_m | cwe_m
    cum_v = cumsum32(valid_pt)
    seg_base = torch.cummax(torch.where(is_start, cum_v - valid_pt, -1), 0).values
    first_valid = (valid_pt == 1) & (cum_v == seg_base + 1)

    # Compaction 1 — run representatives to the front (dump slot N3, .max
    # keeps the result independent of scatter order).
    cum_fv = cumsum32(first_valid.to(I32))
    dest1 = torch.where(first_valid, cum_fv - 1, N3)
    m1 = cum_fv[N3 - 1]
    csrc = scatter_new(N3 + 1, 0, dest1, src_m, "max")[:N3]
    cval = scatter_new(N3 + 1, 0, dest1, val, "max")[:N3]

    # Coalesce equal adjacent step values.
    in1 = iota < m1
    prev_val = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), cval[:-1]])
    keep2 = in1 & ((iota == 0) | (cval != prev_val))
    cum2 = cumsum32(keep2.to(I32))
    new_n = cum2[N3 - 1]

    # Compaction 2 — into the C-capacity state (dump slot C).
    dest2 = torch.where(keep2, torch.clamp(cum2 - 1, max=C), C)
    src2 = scatter_new(C + 1, 0, dest2, csrc, "max")[:C]
    hv_new = scatter_new(C + 1, 0, dest2, cval, "max")[:C]

    # Materialize keys from [history | sorted endpoints] in one gather.
    all_keys = torch.cat([hkeys, smat], dim=1)
    live = iota_c < new_n
    picked = all_keys[:, torch.clamp(src2, 0, C + P2 - 1)]
    pad_col = _pad_col(W, dev, with_value=False)
    keys_out = torch.where(live[None, :], picked, pad_col[:, None])
    hv_out = torch.where(live, hv_new, 0)
    hmat_out = torch.cat([keys_out, hv_out[None, :]], dim=0)

    overflow = new_n > C
    return hmat_out, new_n, _st_aux(too_old, conflict, new_n, overflow, p2_iters)


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
    """Batch-scaled resolve over the block-sparse state (tpu.py:690): ranks
    by the probe, phase 1 via in-block gathers and the block-max segment
    tree, phase 2 shared with the dense kernel, phase 3 a superset merge
    confined to the K gathered (touched) blocks.

    hmat, counts and btree are updated IN PLACE (JAX donated them) and
    returned; returns (hmat, counts, btree, n', st_aux)."""
    W = lay.n_words
    C = NB * B
    R, T = lay.R, lay.T
    P2, Wr = lay.P2, lay.Wr
    M = 2 * Wr
    dev = hmat.device

    (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn, w_valid,
     too_old, version, _oldest_eff, nr, nw) = _decode_fused(fused, lay=lay)
    g_ids = fused[lay.total: lay.total + K]
    n_g = fused[lay.total + K]

    hkeys = hmat[: W + 1]
    hv = hmat[W + 1]

    # ---- block ranks for every sorted endpoint: the probe kernel ----
    bid, lb_loc, eq_loc = probe_ranks(hkeys, fences, smat, NB=NB, B=B)
    ub_loc = lb_loc + eq_loc                              # #block entries <= key

    # ============ Phase 1: read-vs-history ============
    rb_bid = bid[q_begin]
    rb_ub = ub_loc[q_begin]
    re_bid = bid[q_end]
    re_lb = lb_loc[q_end]
    same_blk = rb_bid == re_bid
    cols = _arange(B, dev)[None, :]
    rowsA = hv[torch.clamp(rb_bid[:, None] * B + cols, 0, C - 1)]
    hiA = torch.where(same_blk, re_lb, B)
    mA = torch.where(
        (cols >= (rb_ub - 1)[:, None]) & (cols < hiA[:, None]), rowsA, 0
    ).amax(dim=1)
    rowsC = hv[torch.clamp(re_bid[:, None] * B + cols, 0, C - 1)]
    hiC = torch.where(same_blk, 0, re_lb)
    mC = torch.where(cols < hiC[:, None], rowsC, 0).amax(dim=1)
    nodes, n_seg = _canonical_nodes_flat(
        torch.minimum(rb_bid + 1, re_bid), re_bid, NB
    )
    mB = btree[nodes].reshape(n_seg, R).amax(dim=0)       # btree[0] == 0
    hist_max = torch.maximum(torch.maximum(mA, mB), mC)
    read_conf = (hist_max > rsnap).to(I32)
    hist_conf = scatter_new(T, 0, rtxn, read_conf, "max")
    base_conf = torch.maximum(hist_conf, too_old.to(I32))

    # ============ Phase 2: intra-batch fixed point (shared) ============
    conflict, p2_iters = _phase2_fixed_point(
        base_conf, smat=smat, q_begin=q_begin, q_end=q_end,
        s_begin=s_begin, s_end=s_end, rtxn=rtxn, wtxn=wtxn,
        w_valid=w_valid, T=T, Wr=Wr, P2=P2,
    )

    # ============ Phase 3: touched-block superset merge ============
    committed_w = w_valid & (conflict[wtxn] == 0)
    is_w = scatter_new(P2, 0, torch.cat([s_begin, s_end]), 1, "set")
    w_rank = cumsum32(is_w) - is_w
    cw = committed_w.to(I32)
    packed_ep = scatter_new(
        M, 0, torch.cat([w_rank[s_begin], w_rank[s_end]]),
        torch.cat([(s_begin << 2) + 2 + cw, (s_end << 2) + cw]), "set",
    )
    sidx = packed_ep >> 2
    is_begin_c = (packed_ep >> 1) & 1
    committed_c = packed_ep & 1
    real_ep = _arange(M, dev) < 2 * nw
    kw_c = smat[:, sidx]
    zero1 = torch.zeros(1, dtype=torch.bool, device=dev)
    same_w = torch.cat([zero1, (kw_c[:, 1:] == kw_c[:, :-1]).all(dim=0)])
    bid_c = bid[sidx]
    ub_c = ub_loc[sidx]
    eq_c = eq_loc[sidx].to(torch.bool)
    gidx = torch.searchsorted(g_ids, bid_c, out_int32=True)
    gidx = torch.where(real_ep, gidx, K)
    gidx_c = torch.clamp(gidx, 0, K - 1)

    # Novel-key inserts consume slots; equal-key endpoints overwrite.
    insert_c = real_ep & (~eq_c) & (~same_w)
    ins_i32 = insert_c.to(I32)
    ins_per_blk = scatter_new(K + 1, 0, gidx, ins_i32, "add")[:K]
    ins_start = cumsum32(ins_per_blk) - ins_per_blk
    ins_le_loc = cumsum32(ins_i32) - ins_start[gidx_c]
    delta_pos = ub_c + ins_le_loc - 1
    flatKB = K * B
    mpos = torch.where(real_ep, gidx_c * B + delta_pos, flatKB)

    # Gather the touched blocks.
    gv = _arange(K, dev) < n_g
    g_clip = torch.clamp(g_ids, 0, NB - 1)
    j = _arange(B, dev)[None, :]
    gcol = (g_clip[:, None] * B + j).reshape(-1)
    blk = hmat[:, gcol]                                   # (W+2, K*B)
    nblk = torch.where(gv, counts[g_clip], 0)             # (K,)

    # History shift: entry i of gathered block g moves to i + #inserts with
    # in-block rank <= i.
    cnt2 = scatter_new(
        flatKB + 1, 0, torch.where(insert_c, gidx_c * B + ub_c, flatKB), 1, "add"
    )[:flatKB].reshape(K, B)
    shift = cumsum32(cnt2, dim=1)
    live_h = j < nblk[:, None]
    dest_h = torch.where(
        live_h, _arange(K, dev)[:, None] * B + j + shift, flatKB
    ).reshape(-1)

    # Merged blocks, (W+2, flatKB) plus the discard column flatKB.
    mer = _pad_col(W, dev)[:, None].expand(W + 2, flatKB + 1).clone()
    mer.index_copy_(1, dump_index(dest_h, flatKB), blk)
    # Inserted endpoints: keys from the sorted endpoint matrix, value = the
    # pre-merge in-block predecessor (the step function at the key).
    pred_v = blk[W + 1][torch.clamp(gidx_c * B + ub_c - 1, 0, flatKB - 1)]
    dest_e = torch.where(insert_c, mpos, flatKB)
    mer.index_copy_(1, dump_index(dest_e, flatKB),
                    torch.cat([kw_c, pred_v[None, :]], dim=0))
    mer = mer[:, :flatKB]

    # Coverage depth over the merged order (+1 committed begins, -1 ends).
    delta = torch.where(
        real_ep & (committed_c == 1), torch.where(is_begin_c == 1, 1, -1), 0
    ).to(I32)
    dsum_blk = scatter_new(K + 1, 0, gidx, delta, "add")[:K]
    depth_in = cumsum32(dsum_blk) - dsum_blk
    d2 = scatter_new(flatKB + 1, 0, mpos, delta, "add")[:flatKB].reshape(K, B)
    depth = depth_in[:, None] + cumsum32(d2, dim=1)
    live2 = torch.zeros(flatKB + 1, dtype=torch.bool, device=dev)
    true_ = torch.ones(1, dtype=torch.bool, device=dev)
    live2.index_copy_(0, dump_index(dest_h, flatKB), true_.expand(dest_h.shape[0]))
    live2.index_copy_(0, dump_index(dest_e, flatKB), true_.expand(dest_e.shape[0]))
    live2 = live2[:flatKB].reshape(K, B)
    val2 = torch.where(live2 & (depth > 0), version, mer[W + 1].reshape(K, B))

    # Scatter the rewritten blocks back IN PLACE. JAX drops the pad rows
    # (beyond n_g) at column C; here they rewrite a block no real row
    # touches with its own current contents, so the resident state needs
    # no dump column. The first index where g_ids stops being 0, 1, 2, ...
    # is such a block (g_ids is sorted and unique over its n_g real rows;
    # with no pad rows the choice is unused).
    out = torch.cat([mer[: W + 1], val2.reshape(1, -1)], dim=0)
    idx_k = _arange(K, dev)
    # (free_b stays a tensor: indexing with a 0-d tensor would read it on
    # the host.)
    free_b = torch.where((g_ids != idx_k) | ~gv, idx_k, K).amin().clamp(max=NB - 1)
    dest_blk = torch.where(gv, g_clip, free_b)
    dest_cols = (dest_blk[:, None] * B + j).reshape(-1).to(torch.int64)
    keep = hmat[:, free_b * B + j[0]].repeat(1, K)
    gv_cols = gv[:, None].expand(K, B).reshape(1, -1)
    hmat.index_copy_(1, dest_cols, torch.where(gv_cols, out, keep))
    counts_new_g = torch.where(gv, nblk + ins_per_blk, 0)
    counts.index_copy_(0, dest_blk.to(torch.int64),
                       torch.where(gv, counts_new_g, counts[free_b.reshape(1)]))
    # A block needs a pad column for the in-block probe; the host's
    # pessimistic fill bound makes this dead, but the kernel reports it.
    overflow = (counts_new_g > B - 1).any()
    n_out = n + ins_per_blk.sum(dtype=I32)

    # Segment-tree maintenance: new leaf max per touched block, then the
    # logNB ancestor paths (duplicate parents write identical values). Pad
    # rows write node 0 (never a real node) with its own value, where JAX
    # drops them at 2*NB.
    b0 = btree[0]
    blkmax = torch.where(live2, val2, 0).amax(dim=1)
    cur = torch.where(gv, NB + g_clip, 0)
    btree.index_copy_(0, cur.to(torch.int64), torch.where(gv, blkmax, b0))
    for _ in range(NB.bit_length() - 1):
        cur = torch.where(gv, cur >> 1, 0)
        lch = btree[torch.clamp(2 * cur, 0, 2 * NB - 1)]
        rch = btree[torch.clamp(2 * cur + 1, 0, 2 * NB - 1)]
        btree.index_copy_(0, cur.to(torch.int64),
                          torch.where(gv, torch.maximum(lch, rch), b0))

    return hmat, counts, btree, n_out, _st_aux(
        too_old, conflict, n_out, overflow, p2_iters
    )


def _compact_resolve_impl(hmat, counts, fused, *, lay: FusedLayout,
                          NB: int, NB_out: int, B: int):
    """Amortized compaction + resolve (tpu.py:924): densify, drop superset
    duplicates (last wins), run the DENSE kernel, redistribute into NB_out
    blocks at fill B//2 and rebuild the directory. Returns (hmat',
    counts', btree', fences', n', st_aux), all fresh tensors."""
    W = lay.n_words
    C = NB * B
    C_out = NB_out * B
    F = B // 2
    dev = hmat.device
    pad_col = _pad_col(W, dev)

    # Densify: global position of slot (k, i) = prefix[k] + i.
    slot = _arange(C, dev)
    k = slot // B
    j = slot % B
    prefix = cumsum32(counts) - counts
    live = j < counts[k]
    dense_pos = torch.where(live, prefix[k] + j, C)
    dense = scatter_cols_new(pad_col, C, dense_pos, hmat)
    m = counts.sum(dtype=I32)

    # Dedup equal-key runs, last wins.
    dk = dense[: W + 1]
    same_next = torch.cat([
        (dk[:, 1:] == dk[:, :-1]).all(dim=0),
        torch.zeros(1, dtype=torch.bool, device=dev),
    ])
    keep = (~same_next) & (slot < m)
    cum = cumsum32(keep.to(I32))
    m2 = cum[C - 1]
    dest = torch.where(keep, cum - 1, C)
    dense2 = scatter_cols_new(pad_col, C, dest, dense)

    hmat_d, new_n, st_aux = _resolve_kernel_impl(dense2, m2, fused, lay=lay)

    # Redistribute into NB_out blocks at fill F; fences = each block's
    # minimum key; segment tree rebuilt bottom-up.
    blk_o = slot // F
    dest_o = torch.where(
        (slot < new_n) & (blk_o < NB_out), blk_o * B + (slot % F), C_out
    )
    out = scatter_cols_new(pad_col, C_out, dest_o, hmat_d).contiguous()
    ib = _arange(NB_out, dev) * F
    counts_o = torch.clamp(new_n - ib, 0, F)
    fsrc = torch.clamp(ib, 0, C - 1)
    fvalid = ib < new_n
    fences_o = torch.where(
        fvalid[None, :], hmat_d[: W + 1][:, fsrc], pad_col[: W + 1][:, None]
    )
    lv = out[W + 1].reshape(NB_out, B).amax(dim=1)
    bt = torch.zeros(2 * NB_out, dtype=I32, device=dev)
    bt[NB_out:] = lv
    size = NB_out
    while size > 1:
        size //= 2
        bt[size: 2 * size] = bt[2 * size: 4 * size].reshape(size, 2).amax(dim=1)
    # The fill layout must hold the canonical set (reported through the
    # same overflow byte).
    st_aux[lay.T + 4] = torch.maximum(
        st_aux[lay.T + 4], (new_n > NB_out * F).to(torch.int8)
    )
    return out, counts_o, bt, fences_o.contiguous(), new_n, st_aux


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
    made while this batch was dispatched."""

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
