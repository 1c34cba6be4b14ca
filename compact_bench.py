#!/usr/bin/env python3
"""Time builds of the compaction kernels' densify and dense_phase3 against
each other on one CUDA card.

    python3 compact_bench.py [--other NAME=path/to/compact.cu ...] \\
        [--batches 5] [--reps 2]

Builds foundationdb_tpu_torch/csrc/compact.cu ("compact") and each --other
source that exports the same C entry points (an edited copy, or an
earlier commit's compact.cu taken with `git show`; it includes grid.cuh
from its own directory) through foundationdb_tpu_torch/_build.py, one
nvcc each, all started together. Then it resolves that many BASELINE
config-5 batches (65,536 txns of 8,192-txn chunks, 2^21 slots) through
ConflictSetGPU and keeps the last compaction's operands (chip_smoke's
CompactTap). For each build, in turns (every build in order, then in
reverse), it holds densify and dense_phase3 against their plain versions
(a mismatch is printed, not raised, so that a deliberately broken build
can be timed), times each warm (timing.device_ms, 50 launches) and reads
its stage stamps (the median of 11 launches; a build may stamp another
number of stages). Prints each build's ptxas registers and one JSON line
per (build, kernel). Needs a CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json
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

KERNELS = ("densify", "dense_phase3")
MOST_STAMPS = 64


def typed(name: str):
    lib = _build.load(name)
    for fname, (restype, argtypes) in compact.ENTRY_POINTS.items():
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_bench: CUDA is not available", file=sys.stderr)
        return 2

    builds = ["compact"]
    for spec in args.other:
        name, path = spec.split("=", 1)
        _build.SOURCES[f"compact-{name}"] = Path(path).resolve()
        builds.append(f"compact-{name}")
    _build.build_all(builds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for b in builds:
        regs = _build.ptxas_summary(_build.BUILD_LOG.get(b, ""))
        print(f"ptxas {b}: {regs or 'built earlier, no log'}", flush=True)

    SERVER_KNOBS.TPU_MAX_CHUNK_TXNS = 8192
    rng = np.random.default_rng(20261018)
    g = ConflictSetGPU(max_key_bytes=9, initial_capacity=1 << 21,
                       device="cuda")
    tap = cs.CompactTap().__enter__()
    for i in range(args.batches):
        v = 1_000_000 + i * 65536
        g.verdicts(g.submit(v, max(0, v - 131072),
                            cs.config5_batch(rng, 65536, v)))
    torch.cuda.synchronize()
    tap.__exit__()
    cap = tap.captured
    shape = {k: cs.compact_shape(k, cap[k]) for k in KERNELS}
    want = {k: cs.compact_run(k, cap[k], plain=True) for k in KERNELS}
    libs = {b: typed(b) for b in builds}
    real_lib = compact._lib
    try:
        for rep in range(args.reps):
            for b in builds if rep % 2 == 0 else builds[::-1]:
                compact._lib = lambda lib=libs[b]: lib
                for k in KERNELS:
                    got = cs.compact_run(k, cap[k])
                    exact = all(torch.equal(x, y)
                                for x, y in zip(got, want[k]))
                    ms = device_ms(lambda: cs.compact_run(k, cap[k]), n=50)
                    print(json.dumps({
                        "build": b, "kernel": k, "exact": exact, "ms": ms,
                        "stage_ns": stage_ns(k, cap[k]), "smi": smi,
                        **shape[k]}), flush=True)
    finally:
        compact._lib = real_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
