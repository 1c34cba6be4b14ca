"""The storage window's read gather: everything of one read dispatch after
the base probe.

The counterpart of what foundationdb_tpu/storage_engine/tpu_engine.py
`_read_kernel_impl` (:113-197) computes after its probe: the global rank
by the uniform-fill arithmetic, the delta rank (the halving walk over the
power-of-two, +inf padded delta), each point read's base and delta
predecessor with its key-equality test, each range read's S-wide base and
delta span with the local MVCC visibility test, and the one int32 aux
vector, in tpu_engine.py's order (6 P + 4 R + 6 R S ints):

  pt_found, pt_slot, pt_ver, pt_dfound, pt_dslot, pt_dver,
  rb, re, drb, dre, vis, sslot, sver, dvis, dsslot, dsver.

On CUDA tensors `read_gather` launches the hand-written kernel
csrc/read.cu (built by _build.py; one launch, no scratch, no host read)
and counts the launch in LAUNCHES; on CPU tensors it runs
`read_gather_ref`, the plain torch version, bit for bit the same. A
failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..resolver._launch import (
    check_operands,
    check_shapes,
    cuda_device,
    run_entry,
    typed_lib,
)
from ..resolver._ops import I32, _lex_lt_eq, _lower_rank

# Kernel launches since the caller last reset them.
LAUNCHES = {"read_gather": 0}

_c_ptr = ctypes.c_void_p

OPERANDS = ("hmat", "slots", "nextsame", "dmat", "dslots", "dnext", "qall",
            "rv", "bid", "pos")


def aux_len(P: int, R: int, S: int) -> int:
    """Ints of the aux vector."""
    return 6 * P + 4 * R + 6 * R * S


def read_gather_ref(hmat, slots, nextsame, dmat, dslots, dnext, qall, rv,
                    bid, pos, *, P: int, R: int, S: int, F: int, NB: int,
                    B: int):
    """Plain torch version of read_gather."""
    W2 = qall.shape[0]  # key words + len + version rows
    NBB = NB * B
    D = dmat.shape[1]
    vrow, dvrow = hmat[W2 - 1], dmat[W2 - 1]

    # -- base rank: the probe's (bid, pos), global rank by the uniform-fill
    #    arithmetic --
    g = bid.clamp(0, NB - 1) * F + pos
    # -- delta rank: dense halving walk over the (pow2, +inf padded) delta --
    dg = _lower_rank(dmat, qall)

    def col_of(rank):
        # uniform-fill rank -> column; out-of-range ranks clip onto the
        # last column, which is always padding (fill F < B)
        return ((rank // F) * B + rank % F).clamp(0, NBB - 1)

    # -- points: predecessor of lower_bound((key, len, v+1)) --
    qk = qall[: W2 - 1, :P]
    pred = g[:P] - 1
    pcol = col_of(pred.clamp(min=0))
    _, peq = _lex_lt_eq(hmat[: W2 - 1][:, pcol], qk)
    pt_found = ((pred >= 0) & peq).to(I32)
    pt_ver = vrow[pcol]
    pt_slot = slots[pcol]
    dpred = dg[:P] - 1
    dcol = dpred.clamp(0, D - 1)
    _, dpeq = _lex_lt_eq(dmat[: W2 - 1][:, dcol], qk)
    pt_dfound = ((dpred >= 0) & dpeq).to(I32)
    pt_dver = dvrow[dcol]
    pt_dslot = dslots[dcol]

    # -- ranges: span gather over [rb, re) with the local visibility test --
    rb, re = g[P: P + R], g[P + R:]
    span = torch.arange(S, dtype=I32, device=qall.device)
    rvc = rv[:, None]
    idx = rb[:, None] + span[None, :]  # (R, S) global ranks
    scol = col_of(idx)
    sver = vrow[scol]
    vis = (
        (idx < re[:, None])
        & (sver <= rvc)
        & ((nextsame[scol] == 0) | (vrow[col_of(idx + 1)] > rvc))
    ).to(I32)
    sslot = slots[scol]
    drb, dre = dg[P: P + R], dg[P + R:]
    didx = drb[:, None] + span[None, :]
    dscol = didx.clamp(0, D - 1)
    dsver = dvrow[dscol]
    dvis = (
        (didx < dre[:, None])
        & (dsver <= rvc)
        & ((dnext[dscol] == 0) | (dvrow[(didx + 1).clamp(0, D - 1)] > rvc))
    ).to(I32)
    dsslot = dslots[dscol]

    return torch.cat([
        pt_found, pt_slot, pt_ver, pt_dfound, pt_dslot, pt_dver,
        rb, re, drb, dre,
        vis.reshape(-1), sslot.reshape(-1), sver.reshape(-1),
        dvis.reshape(-1), dsslot.reshape(-1), dsver.reshape(-1),
    ])


def read_gather(hmat, slots, nextsame, dmat, dslots, dnext, qall, rv, bid,
                pos, *, P: int, R: int, S: int, F: int, NB: int, B: int):
    """The aux vector ((6 P + 4 R + 6 R S,) int32) of P point and R range
    reads: the base window hmat (W2, NB*B) with its slots and nextsame
    (NB*B,), the delta dmat (W2, D) (D a power of two) with dslots and
    dnext (D,), the queries qall (W2, P + 2R), the ranges' read versions
    rv (R,), and the probe's bid and pos (P + 2R,) of qall against the
    base. On CUDA tensors one kernel launch, else read_gather_ref."""
    ts = dict(zip(OPERANDS, (hmat, slots, nextsame, dmat, dslots, dnext,
                             qall, rv, bid, pos)))
    check_operands(ts, qall.device)
    W2, Q = qall.shape
    D = dmat.shape[1]
    check_shapes(ts, {"hmat": (W2, NB * B), "slots": NB * B,
                      "nextsame": NB * B, "dmat": (W2, D), "dslots": D,
                      "dnext": D, "qall": (W2, P + 2 * R), "rv": R,
                      "bid": Q, "pos": Q})
    if W2 < 2 or D < 1 or D & (D - 1) or S < 1 or F < 1:
        raise ValueError(f"the read gather takes W2 >= 2, a power-of-two D, "
                         f"S >= 1 and F >= 1, got W2={W2} D={D} S={S} F={F}")
    if qall.device.type == "cpu":
        return read_gather_ref(hmat, slots, nextsame, dmat, dslots, dnext,
                               qall, rv, bid, pos, P=P, R=R, S=S, F=F, NB=NB,
                               B=B)
    return read_gather_launch(ts, P=P, R=R, S=S, F=F, NB=NB, B=B)


def read_gather_launch(ts: dict, *, P: int, R: int, S: int, F: int, NB: int,
                       B: int):
    """read_gather's kernel on CUDA tensors (its operands by name)."""
    dev = cuda_device(ts["qall"], "read gather")
    W2 = ts["qall"].shape[0]
    D = ts["dmat"].shape[1]
    aux = torch.empty(aux_len(P, R, S), dtype=I32, device=dev)
    ptrs = (_c_ptr * 11)(*(t.data_ptr() for t in ts.values()),
                         aux.data_ptr())
    run_entry(_lib(), "fdb_read_gather", dev, "read_gather", LAUNCHES, ptrs,
              W2, P, R, S, F, NB, B, D,
              shapes=f"W2={W2} P={P} R={R} S={S} F={F} NB={NB} B={B} D={D}")
    return aux


# The C entry points of csrc/read.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
ENTRY_POINTS = {
    "fdb_read_gather": (ctypes.c_int, [ctypes.POINTER(_c_ptr),
                                       *([ctypes.c_int] * 8), _c_ptr]),
    "fdb_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib():
    return typed_lib("read", ENTRY_POINTS)
