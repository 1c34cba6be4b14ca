"""The compaction pass: densify + dedup, the dense resolve's ranks + phase
1, its phase 3, and the redistribution into blocks.

The counterparts of what foundationdb_tpu/resolver/tpu.py computes around
the decode (block.decode_fused) and phase 2 in the compaction pass:

- `densify`: _compact_resolve_impl's densify and dedup (:947-974), the
  block state's live prefixes as one sorted dense matrix, the last of each
  equal-key run kept, and its live count m2;
- `ranks`: _resolve_kernel_impl's ranks and phase 1 (:457-472): for each
  sorted endpoint #history <= key (ub, C for a pad) and whether the
  history entry at its lower rank equals it (eq); base_conf = max(too_old,
  any read of the txn whose history maximum passes its snapshot);
- `dense_phase3`: _resolve_kernel_impl's phase 3 (:481-650): the
  committed write endpoints merged by rank into the dense state, stale
  clamp, coalesce and rebase, with new_n and the verdict bytes st_aux;
- `redistribute`: _compact_resolve_impl's redistribution (:978-1009): the
  dense state into NB_out blocks at fill B/2, counts, fences, the block-max
  segment tree, and st_aux's overflow byte raised where the fill layout
  cannot hold the set.

On CUDA tensors each launches its hand-written kernel in csrc/compact.cu
(built by _build.py; one cooperative grid each, no host read) and counts
the launch in LAUNCHES; on CPU tensors each runs its plain torch version
(`*_ref`), the same integer arithmetic, bit for bit. A failed build or
launch raises; nothing falls back.
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
    _arange,
    _build_table,
    _lex_lt_eq,
    _lower_rank,
    _pad_col,
    _table_range_query,
    cumsum32,
    scatter_cols_new,
    scatter_new,
    st_aux_ref,
)
from .packing import INT32_MAX

# Kernel launches since the caller last reset them, by kernel.
LAUNCHES = {"densify": 0, "ranks": 0, "dense_phase3": 0, "redistribute": 0}

_c_ptr = ctypes.c_void_p

# The stages that each kernel stamps where the caller passes a stamp
# buffer (csrc/grid.cuh Stamps): stage k runs from stamp k to stamp k + 1,
# so the buffer holds one int64 more than stages.
DENSIFY_STAGES = ("counts_reduce", "counts_apply", "keep_reduce", "write")
PHASE3_STAGES = ("mark", "rank_reduce", "rank_apply", "merge_runs_reduce",
                 "runs_apply", "valid_reduce", "valid_apply", "keep_reduce",
                 "keep_apply", "gather")
RANKS_STAGES = ("ranks_levels", "query")
REDIST_STAGES = ("copy_subtrees", "roots")

# ranks' tier of each run (a thread block's chunk of the sorted endpoints,
# whole multiples of 256; a word for each 256 at the end of its scratch,
# 0 past the runs, csrc/compact.cu RanksScratch): the rest of the run's
# walks in the shared tile of history columns, or in device memory, or an
# endpoint out of sorted order (which walked every step); "+rewalked"
# where the bracket's predicted walks failed their check (a history out
# of sorted order).
RANKS_TIERS = {1: "tile", 2: "wide", 3: "out_of_order"}
RANKS_REWALKED = 4
RANKS_RUN = 256


def ranks_scratch(C: int, P2: int, dev):
    """A scratch for ranks_launch(..., scratch=) on dev."""
    return torch.empty(_lib().fdb_compact_ranks_scratch_ints(C, P2),
                       dtype=I32, device=dev)


def ranks_tier_words(scratch, P2: int):
    """The tier words (on the scratch's device) of a ranks launch's
    scratch."""
    runs = -(-P2 // RANKS_RUN)
    return scratch[-runs:]


def ranks_tiers(words) -> list[str]:
    """Each run's tier (RANKS_TIERS) from its tier words, as host ints."""
    return [RANKS_TIERS.get(x & 3, str(x))
            + ("+rewalked" if x & RANKS_REWALKED else "")
            for x in words if x]


# ------------------------------------------------------------- densify


def densify_ref(hmat, counts, *, B: int):
    """Plain torch version of densify."""
    W = hmat.shape[0] - 2
    C = hmat.shape[1]
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
    return scatter_cols_new(pad_col, C, dest, dense).contiguous(), m2


def densify(hmat, counts, *, B: int):
    """The block state hmat (W+2, NB*B), counts (NB,) as one dense sorted
    matrix (W+2, NB*B) of its live entries, the last of each equal-key run
    kept, pads past m2; returns (dense, m2 0-d). On a CUDA tensor one
    kernel launch, else densify_ref."""
    ts = {"hmat": hmat, "counts": counts}
    check_operands(ts, hmat.device)
    NB = counts.shape[0]
    if hmat.dim() != 2 or hmat.shape[0] < 3:
        raise ValueError(f"hmat has shape {tuple(hmat.shape)}")
    check_shapes(ts, {"hmat": (hmat.shape[0], NB * B), "counts": NB})
    if hmat.device.type == "cpu":
        return densify_ref(hmat, counts, B=B)
    return densify_launch(hmat, counts, B=B)


def densify_launch(hmat, counts, *, B: int, stamps=None):
    """densify's kernel on CUDA tensors; stamps, if given, gets its stage
    stamps (DENSIFY_STAGES)."""
    dev = cuda_device(hmat, "densify")
    W2, C = hmat.shape
    NB = counts.shape[0]
    lib = _lib()
    dense = torch.empty((W2, C), dtype=I32, device=dev)
    m2 = torch.empty((), dtype=I32, device=dev)
    scratch = torch.empty(lib.fdb_compact_densify_scratch_ints(NB, B),
                          dtype=I32, device=dev)
    _run(lib, "fdb_compact_densify", dev, "densify", hmat.data_ptr(),
         counts.data_ptr(), dense.data_ptr(), m2.data_ptr(),
         scratch.data_ptr(), _stamp_ptr(stamps, len(DENSIFY_STAGES), dev),
         W2 - 2, NB, B,
         shapes=f"W={W2 - 2} NB={NB} B={B}")
    return dense, m2


# ------------------------------------------------------- ranks + phase 1


def ranks_ref(hmat, n, smat, q_begin, q_end, rsnap, rtxn, too_old):
    """Plain torch version of ranks: tpu.py's walk over all C columns,
    which n does not enter (under ranks' precondition the columns past n
    are pads, and the answer is the same)."""
    W = smat.shape[0] - 1
    C = hmat.shape[1]
    T = too_old.shape[0]
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
    return ub, eq, torch.maximum(hist_conf, too_old.to(I32))


RANKS_OPERANDS = ("hmat", "n", "smat", "q_begin", "q_end", "rsnap", "rtxn",
                  "too_old")


def ranks(hmat, n, smat, q_begin, q_end, rsnap, rtxn, too_old):
    """(ub (P2,) int32, eq (P2,) bool, base_conf (T,) int32) of the dense
    state hmat (W+2, C) of n live columns (0-d int32 on the device) for
    the decoded endpoints smat (W+1, P2) and reads q_begin/q_end/rsnap/
    rtxn (R,), too_old (T,) bool. On a CUDA tensor one kernel launch,
    else ranks_ref.

    The kernel reads n on the device and works over the live columns
    only: it takes the columns past n to be pads (kInf key rows, version
    0), as dense_phase3 does, and under that precondition every answer
    equals tpu.py's walk over all C columns (its saturation at C - 1
    included)."""
    ts = dict(zip(RANKS_OPERANDS, (hmat, n, smat, q_begin, q_end, rsnap,
                                   rtxn, too_old)))
    check_operands(ts, hmat.device, flags=("too_old",))
    W1, P2 = smat.shape
    R = q_begin.shape[0]
    check_shapes(ts, {"hmat": (W1 + 1, hmat.shape[1]), "n": (), "q_end": R,
                 "rsnap": R, "rtxn": R})
    if hmat.device.type == "cpu":
        return ranks_ref(hmat, n, smat, q_begin, q_end, rsnap, rtxn, too_old)
    return ranks_launch(ts)


def ranks_launch(ts: dict, stamps=None, scratch=None):
    """ranks' kernel on CUDA tensors (ranks' operands by name); stamps, if
    given, gets its stage stamps (RANKS_STAGES); scratch, if given (int32
    of ranks_scratch_ints(C, P2)), is used in place of a fresh one, so
    that the caller can read its tiers (ranks_tier_words) after the
    launch."""
    dev = cuda_device(ts["hmat"], "ranks")
    C = ts["hmat"].shape[1]
    W1, P2 = ts["smat"].shape
    R, T = ts["q_begin"].shape[0], ts["too_old"].shape[0]
    lib = _lib()
    ub = torch.empty(P2, dtype=I32, device=dev)
    eq = torch.empty(P2, dtype=torch.bool, device=dev)
    base_conf = torch.empty(T, dtype=I32, device=dev)
    if scratch is None:
        scratch = ranks_scratch(C, P2, dev)
    ptrs = (_c_ptr * 13)(*(t.data_ptr() for t in ts.values()), ub.data_ptr(),
                         eq.data_ptr(), base_conf.data_ptr(),
                         scratch.data_ptr(),
                         _stamp_ptr(stamps, len(RANKS_STAGES), dev))
    _run(lib, "fdb_compact_ranks", dev, "ranks", ptrs, W1 - 1, C, P2, R, T,
         shapes=f"W={W1 - 1} C={C} P2={P2} R={R} T={T}")
    return ub, eq, base_conf


# ------------------------------------------------------------- phase 3


def dense_phase3_ref(hmat, n, *, smat, s_begin, s_end, wtxn, w_valid,
                     conflict, too_old, ub, eq, version, oldest_eff,
                     p2_iters):
    """Plain torch version of dense_phase3."""
    W = smat.shape[0] - 1
    C = hmat.shape[1]
    P2 = smat.shape[1]
    Wr = s_begin.shape[0]
    dev = hmat.device
    hkeys = hmat[: W + 1]
    hv = hmat[W + 1]

    # Only WRITE endpoints enter the history: the merge space is C + 2 Wr.
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
    return hmat_out, new_n, st_aux_ref(too_old, conflict, new_n, overflow,
                                       p2_iters)


# dense_phase3's tensor operands, in the C entry point's order (the outputs
# hmat_out, new_n, st_aux, the scratch and the stamp buffer follow them
# there).
DENSE_PHASE3_OPERANDS = ("hmat", "n", "smat", "s_begin", "s_end", "wtxn",
                   "w_valid", "conflict", "too_old", "ub", "eq", "version",
                   "oldest_eff", "p2_iters")


def dense_phase3(hmat, n, *, smat, s_begin, s_end, wtxn, w_valid,
                 conflict, too_old, ub, eq, version, oldest_eff, p2_iters):
    """The dense resolve's phase 3 on the dense state hmat (W+2, C) of n
    live entries: the batch's write endpoints (smat (W+1, P2) the decoded
    endpoint matrix, s_begin/s_end/wtxn (Wr,), w_valid (Wr,) bool,
    conflict (T,) phase 2's vector, ub/eq (P2,) from ranks) merge by rank,
    committed ones taking `version`, then the stale clamp at oldest_eff,
    the coalesce and the rebase. n, version, oldest_eff and p2_iters are
    0-d int32 on the device. Returns (hmat_out (W+2, C), new_n 0-d,
    st_aux (T + 6,) int8).

    The kernel takes the write endpoints' ranks ub as never falling in
    sorted order. That fails only on a full state (n = C, where the rank
    walk saturates at C - 1) with a write endpoint equal to the last key
    and a later one greater: ub falls from C to C - 1, tpu.py's merge
    positions collide and its result depends on its scatter's order. The
    plain version follows tpu.py there on the CPU; the kernel's result
    differs. The compaction never builds that input: a block keeps at most
    B - 1 entries, so densify's n stays under C."""
    ts = dict(zip(DENSE_PHASE3_OPERANDS, (
        hmat, n, smat, s_begin, s_end, wtxn, w_valid, conflict, too_old, ub,
        eq, version, oldest_eff, p2_iters)))
    check_operands(ts, hmat.device, flags=("w_valid", "too_old", "eq"))
    W1, P2 = smat.shape
    Wr = s_begin.shape[0]
    check_shapes(ts, {"hmat": (W1 + 1, hmat.shape[1]), "n": (), "s_end": Wr,
                 "wtxn": Wr, "w_valid": Wr, "too_old": conflict.shape[0],
                 "ub": P2, "eq": P2, "version": (), "oldest_eff": (),
                 "p2_iters": ()})
    if hmat.device.type == "cpu":
        return dense_phase3_ref(
            hmat, n, smat=smat, s_begin=s_begin, s_end=s_end, wtxn=wtxn,
            w_valid=w_valid, conflict=conflict, too_old=too_old, ub=ub,
            eq=eq, version=version, oldest_eff=oldest_eff, p2_iters=p2_iters)
    return dense_phase3_launch(ts)


def dense_phase3_launch(ts: dict, stamps=None):
    """dense_phase3's kernel on CUDA tensors (its operands by name); stamps,
    if given, gets its stage stamps (PHASE3_STAGES)."""
    dev = cuda_device(ts["hmat"], "dense_phase3")
    W2, C = ts["hmat"].shape
    P2 = ts["smat"].shape[1]
    Wr, T = ts["s_begin"].shape[0], ts["conflict"].shape[0]
    lib = _lib()
    hmat_out = torch.empty((W2, C), dtype=I32, device=dev)
    new_n = torch.empty((), dtype=I32, device=dev)
    st_aux = torch.empty(T + 6, dtype=torch.int8, device=dev)
    scratch = torch.empty(lib.fdb_compact_phase3_scratch_ints(C, P2, Wr),
                          dtype=I32, device=dev)
    ptrs = (_c_ptr * 19)(*(t.data_ptr() for t in ts.values()),
                         hmat_out.data_ptr(), new_n.data_ptr(),
                         st_aux.data_ptr(), scratch.data_ptr(),
                         _stamp_ptr(stamps, len(PHASE3_STAGES), dev))
    _run(lib, "fdb_compact_phase3", dev, "dense_phase3", ptrs, W2 - 2, C, P2,
         Wr, T, shapes=f"W={W2 - 2} C={C} P2={P2} Wr={Wr} T={T}")
    return hmat_out, new_n, st_aux


# -------------------------------------------------------- redistribute


def redistribute_ref(hmat_d, new_n, st_aux, *, NB_out: int, B: int):
    """Plain torch version of redistribute."""
    W = hmat_d.shape[0] - 2
    C = hmat_d.shape[1]
    C_out = NB_out * B
    F = B // 2
    dev = hmat_d.device
    pad_col = _pad_col(W, dev)

    # Redistribute into NB_out blocks at fill F; fences = each block's
    # minimum key; segment tree rebuilt bottom-up.
    slot = _arange(C, dev)
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
    T = st_aux.shape[0] - 6
    st_aux[T + 4] = torch.maximum(
        st_aux[T + 4], (new_n > NB_out * F).to(torch.int8)
    )
    return out, counts_o, bt, fences_o.contiguous()


def redistribute(hmat_d, new_n, st_aux, *, NB_out: int, B: int):
    """phase3's dense state hmat_d (W+2, C) of new_n (0-d) entries into
    NB_out blocks of B slots at fill B/2 (both powers of two, B at least
    8, as gpu.py's blocks are): (hmat (W+2, NB_out*B), counts (NB_out,),
    btree (2 NB_out,), fences (W+1, NB_out)), st_aux (T + 6,) int8's
    overflow byte raised in place where new_n passes NB_out * B/2. On a
    CUDA tensor one kernel launch, else redistribute_ref."""
    if NB_out < 1 or NB_out & (NB_out - 1) or B < 8 or B & (B - 1):
        raise ValueError(f"NB_out and B must be powers of two, B at least 8, "
                         f"got NB_out={NB_out} B={B}")
    check_operands({"hmat_d": hmat_d, "new_n": new_n}, hmat_d.device)
    check_shapes({"new_n": new_n}, {"new_n": ()})
    if st_aux.dtype != torch.int8 or st_aux.dim() != 1 or \
            st_aux.device != hmat_d.device or st_aux.shape[0] < 7:
        raise ValueError("st_aux must be int8 (T + 6,) on hmat_d's device")
    if hmat_d.device.type == "cpu":
        return redistribute_ref(hmat_d, new_n, st_aux, NB_out=NB_out, B=B)
    return redistribute_launch(hmat_d, new_n, st_aux, NB_out=NB_out, B=B)


def redistribute_launch(hmat_d, new_n, st_aux, *, NB_out: int, B: int,
                        stamps=None):
    """redistribute's kernel on CUDA tensors; stamps, if given, gets its
    stage stamps (REDIST_STAGES)."""
    dev = cuda_device(hmat_d, "redistribute")
    W2, C = hmat_d.shape
    T = st_aux.shape[0] - 6
    out = torch.empty((W2, NB_out * B), dtype=I32, device=dev)
    counts = torch.empty(NB_out, dtype=I32, device=dev)
    btree = torch.empty(2 * NB_out, dtype=I32, device=dev)
    fences = torch.empty((W2 - 1, NB_out), dtype=I32, device=dev)
    ptrs = (_c_ptr * 8)(hmat_d.data_ptr(), new_n.data_ptr(),
                        st_aux.data_ptr(), out.data_ptr(), counts.data_ptr(),
                        btree.data_ptr(), fences.data_ptr(),
                        _stamp_ptr(stamps, len(REDIST_STAGES), dev))
    _run(_lib(), "fdb_compact_redistribute", dev, "redistribute", ptrs,
         W2 - 2, C, NB_out, B, T,
         shapes=f"W={W2 - 2} C={C} NB_out={NB_out} B={B} T={T}")
    return out, counts, btree, fences


# ------------------------------------------------------------- plumbing

# The C entry points of csrc/compact.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
_PTRS = ctypes.POINTER(_c_ptr)
_I, _LL = ctypes.c_int, ctypes.c_longlong
ENTRY_POINTS = {
    "fdb_compact_densify": (_I, [*([_c_ptr] * 6), _I, _I, _I, _c_ptr]),
    "fdb_compact_densify_scratch_ints": (_LL, [_I, _I]),
    "fdb_compact_ranks": (_I, [_PTRS, _I, _LL, _I, _I, _I, _c_ptr]),
    "fdb_compact_ranks_scratch_ints": (_LL, [_LL, _I]),
    "fdb_compact_phase3": (_I, [_PTRS, _I, _LL, _I, _I, _I, _c_ptr]),
    "fdb_compact_phase3_scratch_ints": (_LL, [_LL, _I, _I]),
    "fdb_compact_redistribute": (_I, [_PTRS, _I, _LL, _I, _I, _I, _c_ptr]),
    "fdb_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib():
    return typed_lib("compact", ENTRY_POINTS)


def _run(lib, entry: str, dev, kernel: str, *args, shapes: str) -> None:
    run_entry(lib, entry, dev, kernel, LAUNCHES, *args, shapes=shapes)
