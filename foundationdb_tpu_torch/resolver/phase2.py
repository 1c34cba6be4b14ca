"""Phase 2's fixed point: the intra-batch conflicts.

The counterpart of foundationdb_tpu/resolver/tpu.py::_phase2_fixed_point
(the geometry at :358-365, the pointer-jumping seed at :385-417, then the
verification loop at :419-437, run by the block and dense kernels) and
foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl (the loop at
:223-253, no seed). Both loop bodies compute the same round on different
index arrays: per read, the least committed writer among the writes that
begin strictly inside its span (case A, a range-min over begin-rank
order) and among the writes whose segment covers the read's leaf (case
B, an interval-tree stab); evidence where that writer precedes the
reader; per txn, new = max(base_conf, evidence). The loop repeats while
anything changed and the round counter is below its cap. The seed runs
one such round with the commit mask dropped and composes each txn's
chain of least potential writers. The geometry (`geometry_ref`) derives
the case-A operands perm, lo and hi from the write begins' and reads'
endpoint slots; a caller that passes q_end in place of those three gets
it inside the same launch (gpu.py's; the rank-fed host computes them).

On a CUDA tensor `phase2_rounds` launches the hand-written kernel
csrc/phase2.cu (built by _build.py), seed and rounds in one launch with
no host read, as the JAX loop makes none; `choose_tier` picks, from the
shapes alone and before the launch, whether it runs in one thread block
(state and operands in its shared memory) or in a cooperative grid
(state in global memory). It counts the launch in LAUNCHES. On a CPU
tensor it runs `phase2_rounds_ref`, the plain torch version, which runs
the rounds in groups under a device `active` flag with one host read per
group and returns the number of reads it made.
"""

from __future__ import annotations

import ctypes

import torch

from ._ops import (
    I32,
    I32_INF,
    _arange,
    _build_table,
    _canonical_nodes_flat,
    _table_range_query,
    cumsum32,
    scatter_new,
)

LAUNCHES = 0  # kernel launches since the caller last reset it

_c_ptr = ctypes.c_void_p


def n_jump(T: int) -> int:
    """The seed's pointer-doubling jumps (tpu.py:409): the round counter
    the verification rounds start at."""
    return max((T - 1).bit_length(), 1)


def geometry_ref(s_begin, q_begin, q_end, P2: int):
    """Phase 2's geometry (tpu.py:358-365): (perm, lo, hi) of the case-A
    range-min from the write begins' endpoint slots s_begin (Wr,) and the
    reads' q_begin, q_end (R,) among P2 slots. wb_excl[p] counts the write
    begins at slots before p; a read's [lo, hi) is wb_excl at its begin
    and end, and perm the write at each begin rank (a scatter that is
    deterministic because every write row, pads included, owns a distinct
    begin slot, packing.py)."""
    is_wb = scatter_new(P2, 0, s_begin, 1, "set")
    wb_excl = cumsum32(is_wb) - is_wb   # #write-begins strictly before pos
    lo, hi = wb_excl[q_begin], wb_excl[q_end]
    rank_w = wb_excl[s_begin]             # rank of each write among wb's
    Wr = s_begin.shape[0]
    perm = scatter_new(Wr, 0, rank_w, _arange(Wr, s_begin.device), "set")
    return perm, lo, hi


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


def seed_ref(base_conf, min_writer, *, rtxn, wtxn, w_valid):
    """The pointer-doubling seed over the read -> min-potential-writer
    chain (tpu.py:385-417): one min-writer round with the commit mask
    dropped gives each txn's parent (the least earlier writer covering
    any of its reads; none: sentinel T); each txn's link table (a, b) =
    (f(parent committed = 0), f(1)) is const 0 at a base conflict, NOT
    along a live link, const 1 without a parent; n_jump doublings compose
    the chains. Returns max(base_conf, 1 - a)."""
    T = base_conf.shape[0]
    dev = base_conf.device
    inf = I32_INF
    pot = min_writer(torch.where(w_valid, wtxn, inf))
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
    for _ in range(n_jump(T)):
        ap, bp = a[ptr], b[ptr]
        a, b, ptr = (torch.where(ap == 1, b, a), torch.where(bp == 1, b, a),
                     ptr[ptr])
    return torch.maximum(base_conf, 1 - a[:T])


def phase2_rounds_ref(base_conf, conflict0, it0: int, cap: int, *,
                      perm=None, lo=None, hi=None, seg_lo, seg_hi,
                      n_leaves: int, leaf, rtxn, wtxn, w_valid, q_end=None,
                      seed: bool = False, groups=(1, 2, 4, 8)):
    """Plain torch version: with q_end, perm, lo and hi are geometry_ref's
    (seg_lo the write begins, leaf the read begins, n_leaves P2); with
    `seed`, the start vector is seed_ref's
    (conflict0 is not read); then lax.while_loop(changed & it < cap) in
    groups of rounds (`groups`, the last size repeating). A round applies
    only while `active`, so the conflict vector and the counter freeze
    after the first unchanged round (or at the cap) exactly where the JAX
    loop stops, with ONE `.item()` per group. Returns (conflict, it,
    reads)."""
    T = base_conf.shape[0]
    inf = I32_INF
    if q_end is not None:
        perm, lo, hi = geometry_ref(seg_lo, leaf, q_end, n_leaves)
    min_writer = min_writer_fn(perm=perm, lo=lo, hi=hi, seg_lo=seg_lo,
                               seg_hi=seg_hi, n_leaves=n_leaves, leaf=leaf)
    if seed:
        conflict0 = seed_ref(base_conf, min_writer, rtxn=rtxn, wtxn=wtxn,
                             w_valid=w_valid)

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


# ------------------------------------------------------------ the tiers

TIERS = ("grid", "block")         # the C entry point's tier numbers
MAX_T = 1 << 24                   # csrc/phase2.cu kMaxT (exclusive)
MAX_LEAVES = 1 << 25              # csrc/phase2.cu kMaxLeaves: n_leaves, Wr
GRID_THREADS = 256                # csrc/phase2.cu kGridThreads
BLOCK_THREADS = 1024              # csrc/phase2.cu kBlockThreads
# Items a thread of the block tier may take where the rule picks it:
# chip_smoke.py's [cluster] entries (NVIDIA H100 80GB HBM3, 700 W) had
# the block ahead of the grid on config-1 batches up to 4 a thread (T
# 832, R 4,096, Wr 1,664: 0.01634 ms vs 0.01954), the most one block
# held there; larger is untimed.
BLOCK_ITEMS = 4
_MISC_INTS = 4                    # csrc/phase2.cu kMisc


def geo_words(L: int) -> int:
    """The geometry's bit words of L slots (csrc/phase2.cu geo_words)."""
    return -(-L // 32)


def block_bytes(T: int, R: int, Wr: int, L: int, geo: bool = False) -> int:
    """Shared memory the block tier holds: the conflict vector (the
    seed's parents until its jumps end), the evidence and the seed's link
    words (T each), the case-A tree (2 Wr), the case-B tree (2 L), four
    words, and copies of the read-only operands (4 words a read, 4 a
    write, base_conf); with the geometry (`geo`) its bit words, their
    prefix and 32 words for their scan (csrc/phase2.cu
    fdb_phase2_block_bytes)."""
    return 4 * (3 * T + 2 * Wr + 2 * L + _MISC_INTS
                + 4 * R + 4 * Wr + T
                + (2 * geo_words(L) + 32 if geo else 0))


def choose_tier(T: int, R: int, Wr: int, L: int, limits: dict,
                tier: str | None = None,
                geo: bool = False) -> tuple[str, int, int]:
    """(tier, blocks, shared bytes) of one launch, from the shapes and
    the device's limits (device_limits: "sms", "smem_per_block",
    "grid_blocks_per_sm"), whichever the card measured faster: the block
    tier, one block of BLOCK_THREADS holding the state and copies of the
    operands in its shared memory, where that fits and each of its
    threads takes at most BLOCK_ITEMS reads, writes or txns; else the
    cooperative grid, one thread per read, write or txn up to every
    resident block. `geo`: the launch computes the geometry too (its
    shared words count). `tier` forces one, for the checks; a forced
    block tier the shape does not fit raises, naming the shapes."""
    if tier not in (None, *TIERS):
        raise ValueError(f"phase-2 tier {tier!r}: 'block' or 'grid'")
    if not 1 <= T < MAX_T:
        raise ValueError(f"phase 2 takes 1 <= T < {MAX_T}, got T={T}")
    smem = block_bytes(T, R, Wr, L, geo)
    fits = smem <= limits["smem_per_block"]
    small = max(T, R, Wr) <= BLOCK_ITEMS * BLOCK_THREADS
    if tier == "block" and not fits:
        raise ValueError(
            f"phase-2 block tier: T={T} R={R} Wr={Wr} n_leaves={L} take "
            f"{smem} bytes of shared memory, over the "
            f"{limits['smem_per_block']} one block may hold")
    if tier == "block" or (tier is None and fits and small):
        return "block", 1, smem
    resident = limits["sms"] * limits["grid_blocks_per_sm"]
    work = -(-max(T, R, Wr) // GRID_THREADS)
    return "grid", max(1, min(resident, work)), 0


_LIMITS: dict[int, dict] = {}     # device index -> its limits, queried once


def device_limits(dev) -> dict:
    """The limits choose_tier reads, queried from the card once per
    device (csrc/phase2.cu fdb_phase2_limits), which also sets the block
    kernel's shared memory limit on it."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    lim = _LIMITS.get(idx)
    if lim is None:
        lib = _lib()
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(idx):
            rc = lib.fdb_phase2_limits(out)
        if rc != 0:
            raise RuntimeError(
                f"phase-2 kernel: querying cuda:{idx} failed: CUDA error "
                f"{rc} ({lib.fdb_cuda_error_string(rc).decode()})")
        lim = _LIMITS[idx] = {"sms": out[0], "smem_per_block": out[1],
                              "grid_blocks_per_sm": out[2]}
    return lim


# The kernel's operands, in the C entry point's order, and the size each
# one's length is. With q_end (the geometry), perm, lo and hi are None.
_ROWS = {"base_conf": "T", "conflict0": "T", "perm": "Wr", "lo": "R",
         "hi": "R", "seg_lo": "Wr", "seg_hi": "Wr", "leaf": "R", "rtxn": "R",
         "wtxn": "Wr", "w_valid": "Wr", "q_end": "R"}
_GEOMETRY = ("perm", "lo", "hi")


def _check(it0: int, cap: int, n_leaves: int, ts: dict) -> dict:
    """Raise on what the kernel does not take; returns {T, R, Wr}."""
    dev = ts["base_conf"].device
    sizes = {k: ts[n].shape[0] if ts[n].dim() == 1 else -1
             for k, n in (("T", "base_conf"), ("R", "rtxn"), ("Wr", "wtxn"))}
    geo = ts["q_end"] is not None
    for name in _GEOMETRY:
        if (ts[name] is None) != geo:
            raise ValueError("phase 2 takes perm, lo and hi, or q_end for "
                             "the geometry, not both")
    for name, t in ts.items():
        if t is None:
            continue
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
    if sizes["T"] < 1 or not 1 <= n_leaves < MAX_LEAVES or (
            sizes["Wr"] >= MAX_LEAVES):
        raise ValueError(f"phase 2 needs T >= 1, 1 <= n_leaves < "
                         f"{MAX_LEAVES} and Wr < {MAX_LEAVES}, got "
                         f"T={sizes['T']} n_leaves={n_leaves} "
                         f"Wr={sizes['Wr']}")
    if not -2**31 <= it0 <= cap < 2**31:
        raise ValueError(f"round counter {it0} and cap {cap} must be int32, "
                         "it0 <= cap")
    return sizes


# The C entry points of csrc/phase2.cu: (restype, argtypes). Every pointer
# and the stream are c_void_p; as a c_int ctypes would cut them to 32 bits.
ENTRY_POINTS = {
    "fdb_phase2_rounds": (ctypes.c_int, [
        *([_c_ptr] * 15), *([ctypes.c_int] * 10), ctypes.c_longlong,
        _c_ptr]),
    "fdb_phase2_limits": (ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]),
    "fdb_phase2_scratch_ints": (ctypes.c_longlong, [ctypes.c_int] * 6),
    "fdb_phase2_block_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
    "fdb_phase2_block_threads": (ctypes.c_int, [ctypes.c_int]),
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


def phase2_rounds(base_conf, conflict0, it0: int, cap: int, *, perm=None,
                  lo=None, hi=None, seg_lo, seg_hi, n_leaves: int, leaf, rtxn,
                  wtxn, w_valid, q_end=None, seed: bool = False,
                  groups=(1, 2, 4, 8)):
    """The fixed point from conflict0 (with `seed`, from the pointer-
    jumping seed instead) with the round counter at it0: rounds until
    nothing changes or the counter reaches cap. Returns the conflict
    vector (T,) int32, the counter (0-d int32), both on the device, and
    the host reads made (0 on the card; the plain version's group reads
    on the CPU, `groups` giving its group sizes).

    base_conf, conflict0: (T,) int32; perm, seg_lo, seg_hi, wtxn: (Wr,)
    int32; w_valid: (Wr,) bool; lo, hi, leaf, rtxn: (R,) int32. Case A
    ranges [lo, hi) index rank order (0..Wr), segments [seg_lo, seg_hi)
    and leaves index n_leaves leaves, leaf < 0 meaning no stab; txn ids
    lie in [0, T). With q_end (R,) int32 in place of perm, lo and hi, the
    launch computes them first (geometry_ref): seg_lo is then the write
    begins' and leaf the read begins' slots among n_leaves = P2."""
    kw = dict(perm=perm, lo=lo, hi=hi, seg_lo=seg_lo, seg_hi=seg_hi,
              n_leaves=n_leaves, leaf=leaf, rtxn=rtxn, wtxn=wtxn,
              w_valid=w_valid, q_end=q_end, seed=seed)
    if base_conf.device.type == "cpu":
        _check(it0, cap, n_leaves, _operands(base_conf, conflict0, kw))
        return phase2_rounds_ref(base_conf, conflict0, it0, cap,
                                 groups=groups, **kw)
    return (*phase2_rounds_launch(base_conf, conflict0, it0, cap, **kw), 0)


def _operands(base_conf, conflict0, kw: dict) -> dict:
    """The kernel's tensor operands by name, in the C entry point's order
    (None for those the call leaves out)."""
    ts = dict(kw, base_conf=base_conf, conflict0=conflict0)
    return {k: ts.get(k) for k in _ROWS}


def phase2_rounds_launch(base_conf, conflict0, it0: int, cap: int, *,
                         seed: bool = False, tier: str | None = None, **kw):
    """Launch the kernel on CUDA tensors (phase2_rounds' operands):
    (conflict (T,), counter 0-d), views of one fresh device tensor,
    enqueued on the current stream of their device with no host read.
    The tier is choose_tier's for the shapes (`tier` forces one, for the
    checks). A CPU tensor, a failed build, a forced tier the shape does
    not fit or a refused launch raises."""
    global LAUNCHES
    n_leaves = kw["n_leaves"]
    ts = _operands(base_conf, conflict0, kw)
    T, R, Wr = _check(it0, cap, n_leaves, ts).values()
    dev = base_conf.device
    if dev.type != "cuda":
        raise ValueError(f"the phase-2 kernel needs CUDA tensors, got {dev}")
    geo = ts["q_end"] is not None
    name, size, smem = choose_tier(T, R, Wr, n_leaves, device_limits(dev),
                                   tier, geo)
    lib = _lib()
    out = torch.empty(T + 1, dtype=I32, device=dev)   # conflict ++ counter
    scratch = (torch.empty(
        lib.fdb_phase2_scratch_ints(T, R, Wr, n_leaves, size, int(geo)),
        dtype=I32, device=dev) if name == "grid" else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fdb_phase2_rounds(
            *(None if t is None else t.data_ptr() for t in ts.values()),
            out.data_ptr(),
            out[T:].data_ptr(),
            None if scratch is None else scratch.data_ptr(), T, R, Wr,
            n_leaves, it0, cap, int(seed), int(geo), TIERS.index(name), size,
            smem,
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"phase-2 kernel launch failed on {dev} ({name} tier of {size} "
            f"blocks of {lib.fdb_phase2_block_threads(TIERS.index(name))} "
            f"threads, {smem} shared bytes each; T={T} R={R} Wr={Wr} "
            f"n_leaves={n_leaves} seed={bool(seed)} geometry={geo}): CUDA "
            f"error {rc} "
            f"({lib.fdb_cuda_error_string(rc).decode()})"
        )
    LAUNCHES += 1
    return out[:T], out[T]
