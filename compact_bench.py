#!/usr/bin/env python3
"""Time builds of the compaction kernels (densify, ranks, dense_phase3,
redistribute) against each other on one CUDA card.

    python3 compact_bench.py [--other NAME=path/to/compact.cu ...] \\
        [--batches 5] [--reps 2] [--paths full,cluster,sharded]

Builds foundationdb_tpu_torch/csrc/compact.cu ("compact") and each --other
source that exports the same C entry points (an edited copy, or an
earlier commit's compact.cu taken with `git show`; it includes grid.cuh
from its own directory) through foundationdb_tpu_torch/_build.py, one
nvcc each, all started together. A source whose ranks and redistribute
entry points take the pointers they took before their redesign (ranks
without n and a stamp buffer, redistribute without a stamp buffer, as in
commit 95c7c65) is driven that way. Then it resolves that many BASELINE
config-5 batches (65,536 txns of 8,192-txn chunks, 2^21 slots) through
ConflictSetGPU and keeps the last compaction's operands (chip_smoke's
CompactTap), and with --paths also runs chip_smoke's [cluster] (config
1) and [sharded] (config 4) phases for theirs. For each build, in turns
(every build in order, then in reverse), on each path, it holds each
kernel against its plain version (a mismatch is
printed, not raised, so that a deliberately broken build can be timed),
times it warm (timing.device_ms, 50 launches) and reads its stage stamps
(the median of 11 launches; a build may stamp another number of stages,
and one with the earlier pointers stamps no ranks or redistribute).
Prints each build's ptxas registers and one JSON line per (build,
kernel). Needs a CUDA card; run from the repo root.
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
from foundationdb_tpu_torch.resolver import compact
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.timing import device_ms

KERNELS = ("densify", "ranks", "dense_phase3", "redistribute")
MOST_STAMPS = 64


def typed(name: str):
    lib = _build.load(name)
    for fname, (restype, argtypes) in compact.ENTRY_POINTS.items():
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


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
    buf = torch.zeros(MOST_STAMPS, dtype=torch.int64, device="cuda")
    real = compact._stamp_ptr
    compact._stamp_ptr = lambda st, n, dev: None if st is None else st.data_ptr()
    try:
        rows = []
        for _ in range(reps):
            buf.zero_()
            cs.compact_run(kernel, cap, stamps=buf)
            torch.cuda.synchronize()
            rows.append(buf.cpu().numpy().copy())
    finally:
        compact._stamp_ptr = real
    r = np.array(rows)
    k = int((r[0] > 0).sum())
    return [float(x) for x in np.median(np.diff(r[:, :k], axis=1), axis=0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--paths", default="full",
                    help="comma-separated: full, cluster, sharded")
    args = ap.parse_args(argv)
    paths = args.paths.split(",")
    if not set(paths) <= {"full", "cluster", "sharded"}:
        ap.error(f"unknown path in --paths {args.paths}")
    if not torch.cuda.is_available():
        print("compact_bench: CUDA is not available", file=sys.stderr)
        return 2

    builds = ["compact"]
    earlier = set()
    for spec in args.other:
        name, path = spec.split("=", 1)
        _build.SOURCES[f"compact-{name}"] = Path(path).resolve()
        builds.append(f"compact-{name}")
        if earlier_pointers(Path(path)):
            earlier.add(f"compact-{name}")
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
    shape = {(p, k): cs.compact_shape(k, caps[p][k])
             for p in paths for k in KERNELS}
    want = {(p, k): cs.compact_run(k, caps[p][k], plain=True)
            for p in paths for k in KERNELS}
    libs = {b: typed(b) for b in builds}
    real_lib = compact._lib
    try:
        for rep in range(args.reps):
            for b in builds if rep % 2 == 0 else builds[::-1]:
                compact._lib = lambda lib=libs[b]: lib
                for p in paths:
                    for k in KERNELS:
                        cap = caps[p][k]
                        old = b in earlier and k in ("ranks", "redistribute")
                        if old:   # timed on one copy of st_aux, as
                            # compact_timer
                            st = cap["args"][-1].clone()
                            got = run_earlier(libs[b], k, cap)
                            timer = (lambda k=k, lib=libs[b], cap=cap, st=st:
                                     run_earlier(lib, k, cap, st))
                        else:
                            got = cs.compact_run(k, cap)
                            timer = cs.compact_timer(k, cap)
                        exact = all(torch.equal(x, y)
                                    for x, y in zip(got, want[p, k]))
                        ms = device_ms(timer, n=50)
                        print(json.dumps({
                            "build": b, "path": p, "kernel": k,
                            "exact": exact, "ms": ms,
                            "stage_ns": [] if old else stage_ns(k, cap),
                            "smi": smi, **shape[p, k]}), flush=True)
    finally:
        compact._lib = real_lib
    return 0


def capture(path: str, batches: int) -> dict:
    """The last compaction's operands (chip_smoke's CompactTap) of
    `batches` BASELINE config-5 batches through ConflictSetGPU (full), or
    of chip_smoke's [cluster] or [sharded] phase run whole."""
    if path == "cluster":
        return cs.phase_cluster(np.random.default_rng(cs.SEED), "",
                                target=cs.CONFIG1_CHIP_TARGET)[
            "cluster-resolver"]["compact"][0]
    if path == "sharded":
        return cs.phase_sharded(np.random.default_rng(cs.SEED), "")[
            "sharded"]["compact"][0]
    SERVER_KNOBS.TPU_MAX_CHUNK_TXNS = 8192
    rng = np.random.default_rng(20261018)
    g = ConflictSetGPU(max_key_bytes=9, initial_capacity=1 << 21,
                       device="cuda")
    with cs.CompactTap() as tap:
        for i in range(batches):
            v = 1_000_000 + i * 65536
            g.verdicts(g.submit(v, max(0, v - 131072),
                                cs.config5_batch(rng, 65536, v)))
        torch.cuda.synchronize()
    return tap.captured


if __name__ == "__main__":
    sys.exit(main())
