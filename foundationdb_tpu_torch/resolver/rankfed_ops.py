"""The rank-fed resolve's phases 1 and 3, around phase 2.

The counterparts of what foundationdb_tpu/resolver/rankfed.py
`_rank_kernel_impl` computes before and after its phase-2 loop:

- `phase1` (:210-215): each read's range maximum of the version vector
  over [rank_b - 1, rank_e) by `_table_range_query`'s rules, a conflict
  where it passes the read's snapshot, scattered to its txn by max and
  maxed with too_old: base_conf; with phase 2's derived operands, the
  case-B stab leaf (:220: qb2 - 1 clipped into [0, M), -1 where qb2 is 0:
  the read point sorts before every write endpoint, nothing covers it)
  and w_valid as bool;
- `phase3` (:255-296): the superset merge of the committed write
  endpoints into the version vector by host-computed rank, the rebase
  and horizon clamp, and the statuses.

Both take the fused buffer's int32 slices as they are (too_old, w_valid
and the scalars nonzero / raw), so the resolve makes no conversion op.
On CUDA tensors each launches its hand-written kernel in csrc/rankfed.cu
(built by _build.py; one cooperative grid each, no host read, no
(log C + 1) x C table) and counts the launch in LAUNCHES; on CPU tensors
each runs its plain torch version (`*_ref`), bit for bit the same. A
failed build or launch raises; nothing falls back.
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
from ._ops import (
    I32,
    _build_table,
    _table_range_query,
    cumsum32,
    scatter_new,
)
from .types import COMMITTED, CONFLICT, TOO_OLD

# Kernel launches since the caller last reset them, by kernel.
LAUNCHES = {"phase1": 0, "phase3": 0}

_c_ptr = ctypes.c_void_p


# ------------------------------------------------------------- phase 1

PHASE1_OPERANDS = ("hv", "rank_b", "rank_e", "rsnap", "rtxn", "too_old",
                   "qb2", "w_valid")


def stab_leaf(qb2, M: int):
    """Phase 2's case-B leaf of each read (rankfed.py:220): qb2 - 1
    clipped into [0, M), -1 where qb2 is 0."""
    return torch.where(qb2 > 0, torch.clamp(qb2 - 1, 0, M - 1), -1).to(I32)


def phase1_ref(hv, *, rank_b, rank_e, rsnap, rtxn, too_old, qb2, w_valid,
               M: int):
    """Plain torch version of phase1."""
    T = too_old.shape[0]
    # _ops' sparse-table query lacks rankfed.py:155-157's cap of the window
    # level at the table's last row; here every query is at most the
    # table's length (C is a power of two), so the cap never binds.
    vtab = _build_table(hv, torch.maximum, 0)
    hist_max = _table_range_query(vtab, rank_b - 1, rank_e, torch.maximum, 0)
    del vtab
    read_conf = (hist_max > rsnap).to(I32)
    hist_conf = scatter_new(T, 0, rtxn, read_conf, "max")
    base_conf = torch.maximum(hist_conf, (too_old != 0).to(I32))
    return base_conf, stab_leaf(qb2, M), w_valid != 0


def phase1(hv, *, rank_b, rank_e, rsnap, rtxn, too_old, qb2, w_valid,
           M: int):
    """(base_conf (T,) int32, leaf (R,) int32, w_valid (Wr,) bool) of the
    version vector hv (C,) int32 and the fused buffer's slices rank_b,
    rank_e, rsnap, rtxn, qb2 (R,), too_old (T,), w_valid (Wr,), all
    int32, with M write endpoints. On a CUDA tensor one kernel launch,
    else phase1_ref."""
    ts = dict(zip(PHASE1_OPERANDS, (hv, rank_b, rank_e, rsnap, rtxn, too_old,
                                    qb2, w_valid)))
    check_operands(ts, hv.device)
    R = rank_b.shape[0]
    check_shapes(ts, {"rank_e": R, "rsnap": R, "rtxn": R, "qb2": R})
    kw = dict(rank_b=rank_b, rank_e=rank_e, rsnap=rsnap, rtxn=rtxn,
              too_old=too_old, qb2=qb2, w_valid=w_valid, M=M)
    if hv.device.type == "cpu":
        return phase1_ref(hv, **kw)
    return phase1_launch(ts, M=M)


def phase1_launch(ts: dict, *, M: int):
    """phase1's kernel on CUDA tensors (its operands by name)."""
    dev = cuda_device(ts["hv"], "rank-fed phase-1")
    C, R = ts["hv"].shape[0], ts["rank_b"].shape[0]
    T, Wr = ts["too_old"].shape[0], ts["w_valid"].shape[0]
    lib = _lib()
    base_conf = torch.empty(T, dtype=I32, device=dev)
    leaf = torch.empty(R, dtype=I32, device=dev)
    valid = torch.empty(Wr, dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.fdb_rankfed_phase1_scratch_ints(C), dtype=I32,
                          device=dev)
    ptrs = (_c_ptr * 12)(*(t.data_ptr() for t in ts.values()),
                         base_conf.data_ptr(), leaf.data_ptr(),
                         valid.data_ptr(), scratch.data_ptr())
    run_entry(lib, "fdb_rankfed_phase1", dev, "phase1", LAUNCHES, ptrs, C,
              R, T, Wr, M, shapes=f"C={C} R={R} T={T} Wr={Wr} M={M}")
    return base_conf, leaf, valid


# ------------------------------------------------------------- phase 3

PHASE3_OPERANDS = ("hv", "conflict", "wtxn", "w_valid", "ub_c", "wsrc",
                   "too_old", "scalars")


def phase3_ref(hv, conflict, *, wtxn, w_valid, ub_c, wsrc, too_old,
               scalars):
    """Plain torch version of phase3."""
    C, M = hv.shape[0], ub_c.shape[0]
    T = too_old.shape[0]
    dev = hv.device
    w_valid = w_valid != 0
    too_old = too_old != 0
    version, oldest_eff, n = scalars[0], scalars[1], scalars[2]
    # Endpoint p merges at posB = p + ub_c[p]; history j at j + lbB[j]
    # where lbB[j] = #{p: ub_c[p] <= j} (scatter-count + prefix sum).
    committed_row = w_valid & (conflict[wtxn] == 0)
    ep_row = (wsrc >> 1).to(torch.int64)
    valid_ep = w_valid[ep_row]
    cw_ep = committed_row[ep_row]
    is_begin = (wsrc & 1) != 0
    pred_val = hv[torch.clamp(ub_c - 1, 0, C - 1)]

    N3 = C + M
    cnt_ub = scatter_new(C + 1, 0, torch.clamp(ub_c, max=C), 1, "add")
    lbB = cumsum32(cnt_ub[:C])
    arange_c = torch.arange(C, dtype=I32, device=dev)
    # posA and posB are each strictly increasing and disjoint: live history
    # slots interleave with the endpoints, dead slots j >= n land at
    # j + M, past every posB <= n + M - 1. So the chained .at[].set of
    # rankfed.py:278-287 is two plain copies into one buffer.
    posA = (arange_c + lbB).to(torch.int64)
    posB = (torch.arange(M, dtype=I32, device=dev) + ub_c).to(torch.int64)
    # Coverage depth over MERGED order: +1 at committed begins, -1 at
    # committed ends, prefix-inclusive — a slot with depth > 0 lies inside
    # the union of committed write ranges. History entries exactly AT a
    # range boundary can be mis-classified by the strict merged order, but
    # a boundary endpoint always inserts an entry at the same key AFTER
    # the history entry, and last-duplicate-wins shadows it.
    delta = torch.where(cw_ep, torch.where(is_begin, 1, -1), 0).to(I32)
    depth = cumsum32(
        torch.zeros(N3, dtype=I32, device=dev).index_copy_(0, posB, delta))
    base = torch.zeros(N3, dtype=I32, device=dev)
    base.index_copy_(0, posA, hv)
    base.index_copy_(0, posB, torch.where(valid_ep, pred_val, 0).to(I32))
    live_slot = torch.zeros(N3, dtype=torch.bool, device=dev)
    live_slot.index_copy_(0, posA, arange_c < n)
    live_slot.index_copy_(0, posB, valid_ep)
    merged = torch.where(live_slot & (depth > 0), version, base)
    # Rebase + horizon clamp (inclusive: 0 means at-or-below horizon).
    merged = torch.where(merged <= oldest_eff, 0, merged - oldest_eff)
    hv_new = merged[:C]

    statuses = torch.where(
        too_old, TOO_OLD, torch.where(conflict[:T] > 0, CONFLICT, COMMITTED)
    ).to(I32)
    return hv_new, statuses


def phase3(hv, conflict, *, wtxn, w_valid, ub_c, wsrc, too_old, scalars):
    """(hv_new (C,) int32, statuses (T,) int32): the superset merge of the
    version vector hv (C,) with phase 2's conflict vector (T,) and the
    fused buffer's slices wtxn, w_valid (Wr,), ub_c, wsrc (M,), too_old
    (T,) and scalars (3,): version, oldest_eff, n. hv is only read. On a
    CUDA tensor one kernel launch, else phase3_ref. ub_c must never fall
    and lie in [0, C] (pads n), as the host builds it."""
    ts = dict(zip(PHASE3_OPERANDS, (hv, conflict, wtxn, w_valid, ub_c, wsrc,
                                    too_old, scalars)))
    check_operands(ts, hv.device)
    Wr, M = wtxn.shape[0], ub_c.shape[0]
    check_shapes(ts, {"w_valid": Wr, "wsrc": M,
                      "too_old": conflict.shape[0], "scalars": 3})
    kw = dict(wtxn=wtxn, w_valid=w_valid, ub_c=ub_c, wsrc=wsrc,
              too_old=too_old, scalars=scalars)
    if hv.device.type == "cpu":
        return phase3_ref(hv, conflict, **kw)
    return phase3_launch(ts)


def phase3_launch(ts: dict):
    """phase3's kernel on CUDA tensors (its operands by name)."""
    dev = cuda_device(ts["hv"], "rank-fed phase-3")
    C, Wr = ts["hv"].shape[0], ts["wtxn"].shape[0]
    M, T = ts["ub_c"].shape[0], ts["too_old"].shape[0]
    lib = _lib()
    hv_new = torch.empty(C, dtype=I32, device=dev)
    statuses = torch.empty(T, dtype=I32, device=dev)
    scratch = torch.empty(lib.fdb_rankfed_phase3_scratch_ints(C), dtype=I32,
                          device=dev)
    ptrs = (_c_ptr * 11)(*(t.data_ptr() for t in ts.values()),
                         hv_new.data_ptr(), statuses.data_ptr(),
                         scratch.data_ptr())
    run_entry(lib, "fdb_rankfed_phase3", dev, "phase3", LAUNCHES, ptrs, C,
              Wr, M, T, shapes=f"C={C} Wr={Wr} M={M} T={T}")
    return hv_new, statuses


# ------------------------------------------------------------- plumbing

# The C entry points of csrc/rankfed.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
_PTRS = ctypes.POINTER(_c_ptr)
_I, _LL = ctypes.c_int, ctypes.c_longlong
ENTRY_POINTS = {
    "fdb_rankfed_phase1": (_I, [_PTRS, _LL, _I, _I, _I, _I, _c_ptr]),
    "fdb_rankfed_phase1_scratch_ints": (_LL, [_LL]),
    "fdb_rankfed_phase3": (_I, [_PTRS, _LL, _I, _I, _I, _c_ptr]),
    "fdb_rankfed_phase3_scratch_ints": (_LL, [_LL]),
    "fdb_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib():
    return typed_lib("rankfed", ENTRY_POINTS)
