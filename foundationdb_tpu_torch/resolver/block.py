"""The block-sparse fast resolve's decode, phase 1 and phase 3.

The counterparts of what foundationdb_tpu/resolver/tpu.py computes
around the rank probe and phase 2:

- `decode_fused`: tpu.py::_decode_fused (:215-325), the fused batch
  buffer unpacked into the sorted endpoint matrix, per-row txn ids and
  snapshots, write validity and too_old (the dense and compaction kernels
  call it too);
- `phase1`: the read-vs-history stage of _resolve_block_kernel_impl
  (:729-759), base_conf = max(too_old, any read of the txn whose history
  range maximum passes its snapshot);
- `phase3`: its touched-block superset merge and segment-tree update
  (:768-919), in place on the state, with n' and the verdict bytes
  st_aux (:909-920).

On CUDA tensors each launches its hand-written kernel in
csrc/block.cu (built by _build.py; one cooperative grid each, no host
read) and counts the launch in LAUNCHES; on CPU tensors each runs its
plain torch version (`*_ref`), the same integer arithmetic, bit for bit.
A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ._launch import (
    check_operands,
    check_shapes,
    cuda_device,
    run_entry,
    typed_lib,
)
from ._launch import stamp_ptr as _stamp_ptr
from ._ops import (
    I32,
    I32_INF,
    _arange,
    _canonical_nodes_flat,
    _pad_col,
    add_wrap_i32,
    cumsum32,
    dump_index,
    scatter_new,
    st_aux_ref,
)
from .packing import MODE_EXPLICIT, MODE_INCREMENT, PAD_WORD, FusedLayout

# Kernel launches since the caller last reset them, by kernel.
LAUNCHES = {"decode": 0, "phase1": 0, "phase3": 0}

_c_ptr = ctypes.c_void_p

# The stages that each kernel stamps where the caller passes a stamp
# buffer (csrc/grid.cuh Stamps): stage k runs from stamp k to stamp k + 1,
# so the buffer holds one int64 more than stages.
DECODE_STAGES = ("reduce", "rows")
PHASE3_STAGES = ("name", "reduce", "compact", "merge", "tree")


# ------------------------------------------------------------- decode


def decode_fused_ref(fused, *, lay: FusedLayout):
    """Plain torch version of decode_fused."""
    W = lay.n_words
    P2, R, Wr, T = lay.P2, lay.R, lay.Wr, lay.T
    dev = fused.device
    W1 = W + 1

    def sl(off, size):
        return fused[off: off + size]

    rbk = sl(lay.off_rb, W1 * R).reshape(W1, R)
    wbk = sl(lay.off_wb, W1 * Wr).reshape(W1, Wr)
    q_begin, q_end, s_begin, s_end, tmeta, tsnap = _views(fused, lay)
    version, oldest_eff, nr, nw = _scalars(fused, lay)

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


def _views(fused, lay: FusedLayout):
    """q_begin, q_end, s_begin, s_end, tmeta, tsnap: views of fused."""
    R, Wr, T = lay.R, lay.Wr, lay.T
    return tuple(fused[o: o + n] for o, n in (
        (lay.off_q_begin, R), (lay.off_q_end, R), (lay.off_s_begin, Wr),
        (lay.off_s_end, Wr), (lay.off_tmeta, T), (lay.off_tsnap, T)))


def _scalars(fused, lay: FusedLayout):
    """version, oldest_eff, nr, nw: 0-d views of fused."""
    return tuple(fused[lay.off_scalars + i] for i in range(4))


def layout_words(lay: FusedLayout) -> list[int]:
    """The layout as csrc/block.cu's decode entry point takes it: sizes,
    then segment offsets."""
    return [lay.n_words, lay.P2, lay.R, lay.Wr, lay.T, lay.Er, lay.Ew,
            lay.off_rb, lay.off_wb, lay.off_re_ext, lay.off_we_ext,
            lay.off_q_begin, lay.off_q_end, lay.off_s_begin, lay.off_s_end,
            lay.off_tmeta, lay.off_tsnap, lay.off_scalars]


def decode_fused(fused, *, lay: FusedLayout):
    """Unpack + decode the compact fused buffer (packing.FusedLayout):
    (smat, q_begin, q_end, s_begin, s_end, rtxn, rsnap, wtxn, w_valid,
    too_old, version, oldest_eff, nr, nw), the scalars 0-d views of
    fused. On a CUDA tensor one kernel launch, else decode_fused_ref."""
    check_operands({"fused": fused}, fused.device)
    if fused.shape[0] < lay.total:
        raise ValueError(f"fused has {fused.shape[0]} words, the layout "
                         f"{lay.total}")
    if fused.device.type == "cpu":
        return decode_fused_ref(fused, lay=lay)
    return decode_fused_launch(fused, lay=lay)


def decode_fused_launch(fused, *, lay: FusedLayout, stamps=None):
    """decode_fused's kernel on a CUDA tensor; stamps, if given, gets its
    stage stamps (DECODE_STAGES)."""
    dev = cuda_device(fused, "decode")
    W1, P2, R, Wr, T = lay.n_words + 1, lay.P2, lay.R, lay.Wr, lay.T
    lib = _lib()
    lw = (ctypes.c_longlong * 18)(*layout_words(lay))
    smat = torch.empty((W1, P2), dtype=I32, device=dev)
    ints = torch.empty(2 * R + Wr, dtype=I32, device=dev)
    bools = torch.empty(Wr + T, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.fdb_block_decode_scratch_ints(lw), dtype=I32,
                          device=dev)
    rtxn, rsnap, wtxn = ints[:R], ints[R: 2 * R], ints[2 * R:]
    w_valid, too_old = bools[:Wr], bools[Wr:]
    _run(lib, "fdb_block_decode", dev, "decode", fused.data_ptr(),
         smat.data_ptr(), rtxn.data_ptr(), rsnap.data_ptr(), wtxn.data_ptr(),
         w_valid.data_ptr(), too_old.data_ptr(), scratch.data_ptr(),
         _stamp_ptr(stamps, len(DECODE_STAGES), dev), lw,
         shapes=f"n_words={lay.n_words} P2={P2} R={R} Wr={Wr} T={T}")
    return (smat, *_views(fused, lay)[:4], rtxn, rsnap, wtxn, w_valid,
            too_old, *_scalars(fused, lay))


# ------------------------------------------------------------- phase 1


def phase1_ref(hv, btree, bid, lb_loc, eq_loc, q_begin, q_end, rsnap, rtxn,
               too_old, *, NB: int, B: int):
    """Plain torch version of phase1."""
    dev = hv.device
    C = NB * B
    T = too_old.shape[0]
    R = q_begin.shape[0]
    ub_loc = lb_loc + eq_loc
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
    return torch.maximum(hist_conf, too_old.to(I32))


def phase1(hv, btree, bid, lb_loc, eq_loc, q_begin, q_end, rsnap, rtxn,
           too_old, *, NB: int, B: int):
    """base_conf (T,) int32 of the block kernel's phase 1: hv (NB*B,) the
    state's version row, btree (2 NB,) its block-max tree, bid/lb_loc/
    eq_loc (P2,) the probe's ranks, q_begin/q_end/rsnap/rtxn (R,) the
    decoded reads, too_old (T,) bool."""
    ts = {"hv": hv, "btree": btree, "bid": bid, "lb_loc": lb_loc,
          "eq_loc": eq_loc, "q_begin": q_begin, "q_end": q_end,
          "rsnap": rsnap, "rtxn": rtxn, "too_old": too_old}
    check_operands(ts, hv.device, flags=("too_old",))
    check_shapes(ts, {"hv": NB * B, "btree": 2 * NB, "lb_loc": bid.shape[0],
                 "eq_loc": bid.shape[0], "q_end": q_begin.shape[0],
                 "rsnap": q_begin.shape[0], "rtxn": q_begin.shape[0]})
    if hv.device.type == "cpu":
        return phase1_ref(hv, btree, bid, lb_loc, eq_loc, q_begin, q_end,
                          rsnap, rtxn, too_old, NB=NB, B=B)
    return phase1_launch(ts, NB=NB, B=B)


def phase1_launch(ts: dict, *, NB: int, B: int):
    """phase1's kernel on CUDA tensors (phase1's operands by name)."""
    dev = cuda_device(ts["hv"], "phase1")
    T, R, P2 = (ts[k].shape[0] for k in ("too_old", "q_begin", "bid"))
    out = torch.empty(T, dtype=I32, device=dev)
    _run(_lib(), "fdb_block_phase1", dev, "phase1",
         *(t.data_ptr() for t in ts.values()), out.data_ptr(), NB, B, R, T,
         P2, shapes=f"NB={NB} B={B} R={R} T={T} P2={P2}")
    return out


# ------------------------------------------------------------- phase 3


def phase3_ref(hmat, counts, btree, n, *, smat, s_begin, s_end, wtxn,
               w_valid, nw, conflict, too_old, p2_iters, bid, lb_loc, eq_loc,
               g_ids, n_g, version, K: int, NB: int, B: int):
    """Plain torch version of phase3. JAX drops the pad rows (past n_g)
    of its in-place scatters at column C; here they rewrite a block no
    real row touches with its own contents (free_b), so that the update
    stays in place with no dump column and no host read. The kernel skips
    them; this version keeps free_b because `submit` on a CPU set
    (device="cpu") runs it, and tests/test_torch_sync_rule.py holds every
    function that `submit` reaches, this one included, to no host read
    (dropping the pad rows by a mask would read n_g)."""
    W = smat.shape[0] - 1
    dev = hmat.device
    Wr = s_begin.shape[0]
    M = 2 * Wr
    P2 = smat.shape[1]
    ub_loc = lb_loc + eq_loc
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

    # Scatter the rewritten blocks back in place; pad rows rewrite free_b,
    # the first index where g_ids stops being 0, 1, 2, ... (g_ids is
    # sorted and unique over its n_g real rows; with no pad rows the choice
    # is unused), with its own contents. free_b stays a tensor: indexing
    # with a 0-d tensor would read it on the host.
    out = torch.cat([mer[: W + 1], val2.reshape(1, -1)], dim=0)
    idx_k = _arange(K, dev)
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
    return n_out, st_aux_ref(too_old, conflict, n_out, overflow, p2_iters)


# phase3's tensor operands, in the C entry point's order (the outputs
# n_out, st_aux and the scratch follow them there).
PHASE3_OPERANDS = ("hmat", "counts", "btree", "n", "smat", "s_begin",
                   "s_end", "wtxn", "w_valid", "nw", "conflict", "too_old",
                   "p2_iters", "bid", "lb_loc", "eq_loc", "g_ids", "n_g",
                   "version")


def phase3(hmat, counts, btree, n, *, smat, s_begin, s_end, wtxn, w_valid,
           nw, conflict, too_old, p2_iters, bid, lb_loc, eq_loc, g_ids, n_g,
           version, K: int, NB: int, B: int):
    """The block kernel's phase 3 on the state hmat (W+2, NB*B), counts
    (NB,) and btree (2 NB,), updated in place: the touched blocks g_ids
    (K,) (n_g real, sorted, padded with NB) merge the batch's write
    endpoints (smat (W+1, P2) the decoded endpoint matrix, s_begin/s_end/
    wtxn (Wr,), w_valid (Wr,) bool, conflict (T,) phase 2's vector),
    committed ones taking `version`. n, nw, p2_iters, n_g and version are
    0-d int32 on the device. Returns (n' 0-d, st_aux (T + 6,) int8)."""
    ts = dict(zip(PHASE3_OPERANDS, (
        hmat, counts, btree, n, smat, s_begin, s_end, wtxn, w_valid, nw,
        conflict, too_old, p2_iters, bid, lb_loc, eq_loc, g_ids, n_g,
        version)))
    check_operands(ts, hmat.device, flags=("w_valid", "too_old"))
    W1, P2 = smat.shape
    Wr = s_begin.shape[0]
    check_shapes(ts, {"hmat": (W1 + 1, NB * B), "counts": NB, "btree": 2 * NB,
                 "n": (), "s_end": Wr, "wtxn": Wr, "w_valid": Wr, "nw": (),
                 "too_old": conflict.shape[0], "p2_iters": (), "bid": P2,
                 "lb_loc": P2, "eq_loc": P2, "g_ids": K, "n_g": (),
                 "version": ()})
    if hmat.device.type == "cpu":
        return phase3_ref(hmat, counts, btree, n, smat=smat, s_begin=s_begin,
                          s_end=s_end, wtxn=wtxn, w_valid=w_valid, nw=nw,
                          conflict=conflict, too_old=too_old,
                          p2_iters=p2_iters, bid=bid, lb_loc=lb_loc,
                          eq_loc=eq_loc, g_ids=g_ids, n_g=n_g,
                          version=version, K=K, NB=NB, B=B)
    return phase3_launch(ts, K=K, NB=NB, B=B)


def phase3_launch(ts: dict, *, K: int, NB: int, B: int, stamps=None):
    """phase3's kernel on CUDA tensors (phase3's operands by name); stamps,
    if given, gets its stage stamps (PHASE3_STAGES)."""
    dev = cuda_device(ts["hmat"], "phase3")
    lib = _lib()
    W1, P2 = ts["smat"].shape
    Wr, T = ts["s_begin"].shape[0], ts["conflict"].shape[0]
    n_out = torch.empty((), dtype=I32, device=dev)
    st_aux = torch.empty(T + 6, dtype=torch.int8, device=dev)
    scratch = torch.empty(lib.fdb_block_phase3_scratch_ints(
        W1 - 1, P2, Wr, T, K, NB, B), dtype=I32, device=dev)
    ptrs = (_c_ptr * 23)(*(t.data_ptr() for t in ts.values()),
                         n_out.data_ptr(), st_aux.data_ptr(),
                         scratch.data_ptr(),
                         _stamp_ptr(stamps, len(PHASE3_STAGES), dev))
    _run(lib, "fdb_block_phase3", dev, "phase3", ptrs, W1 - 1, P2, Wr, T, K,
         NB, B, shapes=f"W={W1 - 1} P2={P2} Wr={Wr} T={T} K={K} NB={NB} "
         f"B={B}")
    return n_out, st_aux


# ------------------------------------------------------------- plumbing


# The C entry points of csrc/block.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
_LAYOUT = ctypes.POINTER(ctypes.c_longlong)
ENTRY_POINTS = {
    "fdb_block_decode": (ctypes.c_int, [*([_c_ptr] * 9), _LAYOUT, _c_ptr]),
    "fdb_block_decode_scratch_ints": (ctypes.c_longlong, [_LAYOUT]),
    "fdb_block_phase1": (ctypes.c_int, [*([_c_ptr] * 11),
                                        *([ctypes.c_int] * 5), _c_ptr]),
    "fdb_block_phase3": (ctypes.c_int, [ctypes.POINTER(_c_ptr),
                                        *([ctypes.c_int] * 7), _c_ptr]),
    "fdb_block_phase3_scratch_ints": (ctypes.c_longlong, [ctypes.c_int] * 7),
    "fdb_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib():
    return typed_lib("block", ENTRY_POINTS)


def _run(lib, entry: str, dev, kernel: str, *args, shapes: str) -> None:
    run_entry(lib, entry, dev, kernel, LAUNCHES, *args, shapes=shapes)
