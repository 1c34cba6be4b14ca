#!/usr/bin/env python3
"""Time builds of the compaction kernels (densify, ranks, dense_phase3,
redistribute) and of the block kernel's decode and phase 3 against each
other on one CUDA card.

    python3 compact_bench.py [--other NAME=path/to/compact.cu ...] \\
        [--other NAME=path/to/block.cu ...] [--batches 5] [--reps 2] \\
        [--paths full,cluster,sharded] [--families compact,block]

Builds foundationdb_tpu_torch/csrc/compact.cu ("compact") and block.cu
("block") and each --other source that exports the same C entry points
as one of them (an edited copy, or an earlier commit's source taken with
`git show`; it includes grid.cuh from its own directory; a source that
exports fdb_block_decode is a block build, else a compaction build)
through foundationdb_tpu_torch/_build.py, one nvcc each, all started
together. A compaction source whose ranks and redistribute entry points
take the pointers they took before their redesign (ranks without n and a
stamp buffer, redistribute without a stamp buffer, as in commit 95c7c65)
is driven that way, and so is a block source whose decode and phase 3
take no stamp buffer (as in commit 68534ef). Then it resolves that many
BASELINE config-5 batches (65,536 txns of 8,192-txn chunks, 2^21 slots)
through ConflictSetGPU and keeps the last compaction's and the last fast
step's operands (chip_smoke's CompactTap and BlockTap), and with --paths
also runs chip_smoke's [cluster] (config 1) and [sharded] (config 4)
phases for theirs. For each build, in turns (every build in order, then
in reverse), on each path, it holds each kernel of its family against its
plain version (a mismatch is printed, not raised, so that a deliberately
broken build can be timed), times it warm (timing.device_ms, 50 launches;
phase 3 on a restored copy of its state, the restore's own time
subtracted, as chip_smoke's block_timer) and reads its stage stamps (the
median of 11 launches; a build may stamp another number of stages, and
one with the earlier entry points stamps nothing there). Prints each
build's ptxas registers and one JSON line per (build, path, kernel).
Needs a CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.resolver import block, compact
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.timing import device_ms

FAMILIES = {"compact": ("densify", "ranks", "dense_phase3", "redistribute"),
            "block": ("decode", "phase3")}
MOST_STAMPS = 64

# block.cu's decode and phase 3 entry points before they took a stamp
# buffer (commit 68534ef): decode's 8 pointers, phase 3's 22
_c_ptr = ctypes.c_void_p
_LAYOUT = ctypes.POINTER(ctypes.c_longlong)
EARLIER_BLOCK = {
    "fdb_block_decode": (ctypes.c_int, [*([_c_ptr] * 8), _LAYOUT, _c_ptr]),
    "fdb_block_decode_scratch_ints": (ctypes.c_longlong, [_LAYOUT]),
    "fdb_block_phase3": (ctypes.c_int, [ctypes.POINTER(_c_ptr),
                                        *([ctypes.c_int] * 7), _c_ptr]),
    "fdb_block_phase3_scratch_ints": (ctypes.c_longlong, [ctypes.c_int] * 4),
}


def typed(name: str, entry_points=None):
    lib = _build.load(name)
    family = "block" if name.startswith("block") else "compact"
    eps = dict((block if family == "block" else compact).ENTRY_POINTS)
    eps.update(entry_points or {})
    for fname, (restype, argtypes) in eps.items():
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def family_of(path: Path) -> str:
    return ("block" if "fdb_block_decode(" in path.read_text()
            else "compact")


def earlier_block(path: Path) -> bool:
    """Whether the block source's decode takes no stamp buffer."""
    body = path.read_text().split('extern "C" int fdb_block_decode(')[-1]
    return "stamps" not in body.split("{")[0]


def earlier_block_launch(lib, kernel: str):
    """decode or phase 3 through the earlier entry points (no stamps),
    called as chip_smoke.block_run's `launch` is."""
    def decode(fused, *, lay):
        dev = fused.device
        W1, P2, R, Wr, T = lay.n_words + 1, lay.P2, lay.R, lay.Wr, lay.T
        lw = (ctypes.c_longlong * 18)(*block.layout_words(lay))
        smat = torch.empty((W1, P2), dtype=torch.int32, device=dev)
        ints = torch.empty(2 * R + Wr, dtype=torch.int32, device=dev)
        bools = torch.empty(Wr + T, dtype=torch.bool, device=dev)
        scratch = torch.empty(lib.fdb_block_decode_scratch_ints(lw),
                              dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fdb_block_decode(
            fused.data_ptr(), smat.data_ptr(), ints[:R].data_ptr(),
            ints[R: 2 * R].data_ptr(), ints[2 * R:].data_ptr(),
            bools[:Wr].data_ptr(), bools[Wr:].data_ptr(), scratch.data_ptr(),
            lw, stream)
        if rc:
            raise RuntimeError(f"decode: CUDA error {rc}")
        return (smat, *block._views(fused, lay)[:4], ints[:R],
                ints[R: 2 * R], ints[2 * R:], bools[:Wr], bools[Wr:],
                *block._scalars(fused, lay))

    def phase3(ts, *, K, NB, B):
        dev = ts["hmat"].device
        W1, P2 = ts["smat"].shape
        Wr, T = ts["s_begin"].shape[0], ts["conflict"].shape[0]
        n_out = torch.empty((), dtype=torch.int32, device=dev)
        st_aux = torch.empty(T + 6, dtype=torch.int8, device=dev)
        scratch = torch.empty(lib.fdb_block_phase3_scratch_ints(P2, Wr, K, B),
                              dtype=torch.int32, device=dev)
        ptrs = (_c_ptr * 22)(*(t.data_ptr() for t in ts.values()),
                             n_out.data_ptr(), st_aux.data_ptr(),
                             scratch.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fdb_block_phase3(ptrs, W1 - 1, P2, Wr, T, K, NB, B, stream)
        if rc:
            raise RuntimeError(f"phase3: CUDA error {rc}")
        return n_out, st_aux

    return {"decode": decode, "phase3": phase3}[kernel]


def earlier_pointers(path: Path) -> bool:
    """Whether the source's ranks entry point takes the 11 pointers it
    took before ranks read n and stamps (so redistribute takes 7)."""
    body = path.read_text().split("fdb_compact_ranks(void* const* ptrs")[-1]
    body = body.split('extern "C"')[0]
    return max(int(i) for i in re.findall(r"ptrs\[(\d+)\]", body)) == 10


def run_earlier(lib, kernel: str, cap: dict, st=None):
    """ranks or redistribute through the earlier entry points (no n, no
    stamps); redistribute on st (a copy of st_aux made here where none is
    given), returned after its outputs."""
    dev = cap["args"][0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = torch.int32
    if kernel == "ranks":
        hmat, _, smat, qb, qe, rsnap, rtxn, too_old = cap["args"]
        C = hmat.shape[1]
        W1, P2 = smat.shape
        R, T = qb.shape[0], too_old.shape[0]
        ub = torch.empty(P2, dtype=i32, device=dev)
        eq = torch.empty(P2, dtype=torch.bool, device=dev)
        base_conf = torch.empty(T, dtype=i32, device=dev)
        scratch = torch.empty(lib.fdb_compact_ranks_scratch_ints(C, P2),
                              dtype=i32, device=dev)
        ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
            hmat, smat, qb, qe, rsnap, rtxn, too_old, ub, eq, base_conf,
            scratch)))
        rc = lib.fdb_compact_ranks(ptrs, W1 - 1, C, P2, R, T, stream)
        out = (ub, eq, base_conf)
    else:
        hmat_d, new_n, st_aux = cap["args"]
        W2, C = hmat_d.shape
        NB, B = cap["NB_out"], cap["B"]
        st = st_aux.clone() if st is None else st
        out = (torch.empty((W2, NB * B), dtype=i32, device=dev),
               torch.empty(NB, dtype=i32, device=dev),
               torch.empty(2 * NB, dtype=i32, device=dev),
               torch.empty((W2 - 1, NB), dtype=i32, device=dev), st)
        ptrs = (ctypes.c_void_p * 7)(hmat_d.data_ptr(), new_n.data_ptr(),
                                     st.data_ptr(),
                                     *(t.data_ptr() for t in out[:4]))
        rc = lib.fdb_compact_redistribute(ptrs, W2 - 2, C, NB, B,
                                          st.shape[0] - 6, stream)
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc}")
    return out


def stage_ns(kernel: str, cap: dict, reps: int = 11) -> list:
    """Median ns between the stamps the build writes (however many)."""
    fam = block if kernel in FAMILIES["block"] else compact
    run = cs.block_run if fam is block else cs.compact_run
    buf = torch.zeros(MOST_STAMPS, dtype=torch.int64, device="cuda")
    real = fam._stamp_ptr
    fam._stamp_ptr = lambda st, n, dev: None if st is None else st.data_ptr()
    try:
        rows = []
        for _ in range(reps):
            buf.zero_()
            run(kernel, cap, stamps=buf)
            torch.cuda.synchronize()
            rows.append(buf.cpu().numpy().copy())
    finally:
        fam._stamp_ptr = real
    r = np.array(rows)
    k = int((r[0] > 0).sum())
    return [float(x) for x in np.median(np.diff(r[:, :k], axis=1), axis=0)]


def exact_and_timer(b: str, k: str, cap: dict, lib, old: bool, want):
    """(exact, timer for device_ms, stamped) of kernel k of build b."""
    if k in FAMILIES["block"]:
        launch = earlier_block_launch(lib, k) if old else None
        got = cs.block_run(k, cap, launch=launch)
        fn, restore = cs.block_timer(k, cap, launch=launch)
        exact = all(torch.equal(x, y) for x, y in zip(got, want))
        return exact, (fn, restore), not old
    old = old and k in ("ranks", "redistribute")
    if old:   # timed on one copy of st_aux, as compact_timer
        st = cap["args"][-1].clone()
        got = run_earlier(lib, k, cap)
        timer = (lambda: run_earlier(lib, k, cap, st))
    else:
        got = cs.compact_run(k, cap)
        timer = cs.compact_timer(k, cap)
    exact = all(torch.equal(x, y) for x, y in zip(got, want))
    return exact, (timer, None), not old


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--paths", default="full",
                    help="comma-separated: full, cluster, sharded")
    ap.add_argument("--families", default="compact,block",
                    help="comma-separated: compact, block")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    families = args.families.split(",")
    if not set(paths) <= {"full", "cluster", "sharded"}:
        ap.error(f"unknown path in --paths {args.paths}")
    if not set(families) <= set(FAMILIES):
        ap.error(f"unknown family in --families {args.families}")
    if not torch.cuda.is_available():
        print("compact_bench: CUDA is not available", file=sys.stderr)
        return 2

    builds = list(families)   # the tree's: "compact", "block"
    earlier = set()
    for spec in args.other:
        name, path = spec.split("=", 1)
        path = Path(path)
        fam = family_of(path)
        if fam not in families:
            continue
        key = f"{fam}-{name}"
        _build.SOURCES[key] = path.resolve()
        builds.append(key)
        if (earlier_block(path) if fam == "block"
                else earlier_pointers(path)):
            earlier.add(key)
    _build.build_all(builds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for b in builds:
        regs = _build.ptxas_summary(_build.BUILD_LOG.get(b, ""))
        print(f"ptxas {b}: {regs or 'built earlier, no log'}", flush=True)

    if set(paths) - {"full"}:   # the cluster phases serialize natively
        from foundationdb_tpu_torch import native
        from foundationdb_tpu_torch.storage_engine import _native

        _native.build_host_tier()
        native.prepare()
    caps = {p: capture(p, args.batches) for p in paths}
    kernels = [k for f in families for k in FAMILIES[f]]
    shape = {(p, k): (cs._block_shape(k, caps[p][k]) if k in FAMILIES["block"]
                      else cs.compact_shape(k, caps[p][k]))
             for p in paths for k in kernels}
    want = {(p, k): (cs.block_run(k, caps[p][k], plain=True)
                     if k in FAMILIES["block"]
                     else cs.compact_run(k, caps[p][k], plain=True))
            for p in paths for k in kernels}
    libs = {b: typed(b, EARLIER_BLOCK if b in earlier and
                     b.startswith("block") else None) for b in builds}
    real_lib = {"compact": compact._lib, "block": block._lib}
    try:
        for rep in range(args.reps):
            for b in builds if rep % 2 == 0 else builds[::-1]:
                fam = "block" if b.startswith("block") else "compact"
                (block if fam == "block" else compact)._lib = (
                    lambda lib=libs[b]: lib)
                for p in paths:
                    for k in FAMILIES[fam]:
                        cap = caps[p][k]
                        exact, (fn, restore), stamped = exact_and_timer(
                            b, k, cap, libs[b], b in earlier, want[p, k])
                        ms = device_ms(fn, n=50) - (
                            device_ms(restore, n=50) if restore else 0.0)
                        print(json.dumps({
                            "build": b, "path": p, "kernel": k,
                            "exact": exact, "ms": ms,
                            "stage_ns": stage_ns(k, cap) if stamped else [],
                            "smi": smi, **shape[p, k]}), flush=True)
                (block if fam == "block" else compact)._lib = real_lib[fam]
    finally:
        compact._lib, block._lib = real_lib["compact"], real_lib["block"]
    return 0


def capture(path: str, batches: int) -> dict:
    """The last compaction's and the last fast step's operands
    (chip_smoke's CompactTap and BlockTap), by kernel, of `batches`
    BASELINE config-5 batches through ConflictSetGPU (full), or of
    chip_smoke's [cluster] or [sharded] phase run whole."""
    if path in ("cluster", "sharded"):
        rng = np.random.default_rng(cs.SEED)
        got, key = ((cs.phase_cluster(rng, "", target=cs.CONFIG1_CHIP_TARGET),
                     "cluster-resolver") if path == "cluster"
                    else (cs.phase_sharded(rng, ""), "sharded"))
        return {**got[key]["compact"][0], **got[key]["block"][0]}
    SERVER_KNOBS.TPU_MAX_CHUNK_TXNS = 8192
    rng = np.random.default_rng(20261018)
    g = ConflictSetGPU(max_key_bytes=9, initial_capacity=1 << 21,
                       device="cuda")
    with cs.CompactTap() as tap, cs.BlockTap() as b_tap:
        for i in range(batches):
            v = 1_000_000 + i * 65536
            g.verdicts(g.submit(v, max(0, v - 131072),
                                cs.config5_batch(rng, 65536, v)))
        torch.cuda.synchronize()
    return {**tap.captured, **b_tap.captured}


if __name__ == "__main__":
    sys.exit(main())
