"""Phase 2's verification loop: the intra-batch fixed point.

The counterpart of the JAX package's two `lax.while_loop`s of phase 2:
foundationdb_tpu/resolver/tpu.py::_phase2_fixed_point (the loop at
:419-437, run by the block and dense kernels, after a pointer-jumping
seed) and foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl
(:223-253, no seed). Both bodies compute the same round on different
index arrays: per read, the least committed writer among the writes that
begin strictly inside its span (case A, a range-min over begin-rank
order) and among the writes whose segment covers the read's leaf (case
B, an interval-tree stab); evidence where that writer precedes the
reader; per txn, new = max(base_conf, evidence). The loop repeats while
anything changed and the round counter is below its cap.

On a CUDA tensor `phase2_rounds` launches the hand-written kernel
csrc/phase2.cu (built by _build.py), which runs every round on the
device: no host read, as the JAX loop makes none. It counts the launch
in LAUNCHES. On a CPU tensor it runs `phase2_rounds_ref`, the plain torch
version, which runs the rounds in groups under a device `active` flag
with one host read per group and returns the number of reads it made.
"""

from __future__ import annotations

import ctypes

import torch

from ._ops import (
    I32,
    I32_INF,
    _build_table,
    _canonical_nodes_flat,
    _table_range_query,
    scatter_new,
)

LAUNCHES = 0  # kernel launches since the caller last reset it

_c_ptr = ctypes.c_void_p


def min_writer_fn(*, perm, lo, hi, seg_lo, seg_hi, n_leaves: int, leaf):
    """The per-read least writer of one batch's geometry, as a function
    of wval (Wr,) int32 (INT32_MAX for a write that does not count):
    min(case A over wval[perm][lo:hi], case B over the writes whose
    [seg_lo, seg_hi) holds leaf; no case B where leaf < 0)."""
    dev = perm.device
    inf = I32_INF
    wnodes, n_blocks = _canonical_nodes_flat(seg_lo, seg_hi, n_leaves)
    wnodes = wnodes.to(torch.int64)       # node 0 absorbs unused slots
    k_levels = n_leaves.bit_length()
    anc = ((torch.clamp(leaf, min=0)[None, :] + n_leaves)
           >> torch.arange(k_levels, dtype=I32, device=dev)[:, None])
    stabs = leaf >= 0

    def min_writer(wval):
        case_a = _table_range_query(
            _build_table(wval[perm], torch.minimum, inf),
            lo, hi, torch.minimum, inf,
        )
        tree = torch.full((2 * n_leaves,), inf, dtype=I32, device=dev)
        tree.scatter_reduce_(0, wnodes, wval.repeat(n_blocks),
                             reduce="amin", include_self=True)
        stab = torch.where(stabs, tree[anc].amin(dim=0), inf)
        return torch.minimum(case_a, stab)

    return min_writer


def phase2_rounds_ref(base_conf, conflict0, it0: int, cap: int, *, perm,
                      lo, hi, seg_lo, seg_hi, n_leaves: int, leaf, rtxn,
                      wtxn, w_valid, groups=(1, 2, 4, 8)):
    """Plain torch version: lax.while_loop(changed & it < cap) in groups
    of rounds (`groups`, the last size repeating). A round applies only
    while `active`, so the conflict vector and the counter freeze after
    the first unchanged round (or at the cap) exactly where the JAX loop
    stops, with ONE `.item()` per group. Returns (conflict, it, reads)."""
    T = base_conf.shape[0]
    inf = I32_INF
    min_writer = min_writer_fn(perm=perm, lo=lo, hi=hi, seg_lo=seg_lo,
                               seg_hi=seg_hi, n_leaves=n_leaves, leaf=leaf)

    def body(conflict):
        committed_w = w_valid & (conflict[wtxn] == 0)
        evidence = (min_writer(torch.where(committed_w, wtxn, inf))
                    < rtxn).to(I32)
        ev_txn = scatter_new(T, 0, rtxn, evidence, "max")
        return torch.maximum(base_conf, ev_txn)

    conflict = conflict0
    it = torch.full((), it0, dtype=I32, device=base_conf.device)
    active = torch.ones((), dtype=torch.bool, device=base_conf.device)
    group, left, reads = 0, cap - it0, 0   # rounds the cap still allows
    while left > 0:
        size = min(groups[min(group, len(groups) - 1)], left)
        for _ in range(size):
            new = body(conflict)
            changed = (new != conflict).any()
            conflict = torch.where(active, new, conflict)
            it = it + active.to(I32)
            active = active & changed & (it < cap)
        left -= size
        group += 1
        reads += 1
        if not bool(active.item()):
            break
    return conflict, it, reads


# The kernel's operands, in the C entry point's order, and the size each
# one's length is.
_ROWS = {"base_conf": "T", "conflict0": "T", "perm": "Wr", "lo": "R",
         "hi": "R", "seg_lo": "Wr", "seg_hi": "Wr", "leaf": "R", "rtxn": "R",
         "wtxn": "Wr", "w_valid": "Wr"}


def _check(it0: int, cap: int, n_leaves: int, ts: dict) -> dict:
    """Raise on what the kernel does not take; returns {T, R, Wr}."""
    dev = ts["base_conf"].device
    sizes = {k: ts[n].shape[0] if ts[n].dim() == 1 else -1
             for k, n in (("T", "base_conf"), ("R", "rtxn"), ("Wr", "wtxn"))}
    for name, t in ts.items():
        want = torch.bool if name == "w_valid" else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != (sizes[_ROWS[name]],):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"({_ROWS[name]}={sizes[_ROWS[name]]},) expected")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, base_conf on {dev}")
    if sizes["T"] < 1 or n_leaves < 1:
        raise ValueError(f"phase 2 needs T >= 1 and n_leaves >= 1, got "
                         f"T={sizes['T']} n_leaves={n_leaves}")
    if not -2**31 <= it0 <= cap < 2**31:
        raise ValueError(f"round counter {it0} and cap {cap} must be int32, "
                         "it0 <= cap")
    return sizes


# The C entry points of csrc/phase2.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
ENTRY_POINTS = {
    "fdb_phase2_rounds": (ctypes.c_int, [
        *([_c_ptr] * 14), *([ctypes.c_int] * 6), _c_ptr,
        ctypes.POINTER(ctypes.c_int)]),
    "fdb_phase2_scratch_ints": (ctypes.c_longlong, [ctypes.c_int] * 3),
    "fdb_phase2_block_threads": (ctypes.c_int, []),
    "fdb_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib():
    from .. import _build

    lib = _build.load("phase2")
    if not getattr(lib, "_fdb_typed", False):
        for name, (restype, argtypes) in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        lib._fdb_typed = True
    return lib


def phase2_rounds(base_conf, conflict0, it0: int, cap: int, *, perm, lo, hi,
                  seg_lo, seg_hi, n_leaves: int, leaf, rtxn, wtxn, w_valid,
                  groups=(1, 2, 4, 8)):
    """The fixed point from conflict0 with the round counter at it0:
    rounds until nothing changes or the counter reaches cap. Returns the
    conflict vector (T,) int32, the counter (0-d int32), both on the
    device, and the host reads made (0 on the card; the plain version's
    group reads on the CPU, `groups` giving its group sizes).

    base_conf, conflict0: (T,) int32; perm, seg_lo, seg_hi, wtxn: (Wr,)
    int32; w_valid: (Wr,) bool; lo, hi, leaf, rtxn: (R,) int32. Case A
    ranges [lo, hi) index rank order (0..Wr), segments [seg_lo, seg_hi)
    and leaves index n_leaves leaves, leaf < 0 meaning no stab."""
    kw = dict(perm=perm, lo=lo, hi=hi, seg_lo=seg_lo, seg_hi=seg_hi,
              n_leaves=n_leaves, leaf=leaf, rtxn=rtxn, wtxn=wtxn,
              w_valid=w_valid)
    if base_conf.device.type == "cpu":
        _check(it0, cap, n_leaves, _operands(base_conf, conflict0, kw))
        return phase2_rounds_ref(base_conf, conflict0, it0, cap,
                                 groups=groups, **kw)
    return (*phase2_rounds_launch(base_conf, conflict0, it0, cap, **kw), 0)


def _operands(base_conf, conflict0, kw: dict) -> dict:
    """The kernel's tensor operands by name, in the C entry point's order."""
    ts = dict(kw, base_conf=base_conf, conflict0=conflict0)
    return {k: ts[k] for k in _ROWS}


def phase2_rounds_launch(base_conf, conflict0, it0: int, cap: int, **kw):
    """Launch the kernel on CUDA tensors (phase2_rounds' operands):
    (conflict (T,), counter 0-d), views of one fresh device tensor,
    enqueued on the current stream of their device with no host read. A
    CPU tensor, a failed build or a refused launch raises."""
    global LAUNCHES
    n_leaves = kw["n_leaves"]
    ts = _operands(base_conf, conflict0, kw)
    T, R, Wr = _check(it0, cap, n_leaves, ts).values()
    dev = base_conf.device
    if dev.type != "cuda":
        raise ValueError(f"the phase-2 kernel needs CUDA tensors, got {dev}")
    lib = _lib()
    out = torch.empty(T + 1, dtype=I32, device=dev)   # conflict ++ counter
    scratch = torch.empty(lib.fdb_phase2_scratch_ints(T, Wr, n_leaves),
                          dtype=I32, device=dev)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fdb_phase2_rounds(
            *(t.data_ptr() for t in ts.values()), out.data_ptr(),
            out[T:].data_ptr(), scratch.data_ptr(), T, R, Wr, n_leaves,
            it0, cap, stream, ctypes.byref(grid),
        )
    if rc != 0:
        raise RuntimeError(
            f"phase-2 kernel launch failed on {dev} (cooperative grid of "
            f"{grid.value} blocks of {lib.fdb_phase2_block_threads()} "
            f"threads; T={T} R={R} Wr={Wr} n_leaves={n_leaves}): CUDA "
            f"error {rc} ({lib.fdb_cuda_error_string(rc).decode()})"
        )
    LAUNCHES += 1
    return out[:T], out[T]
