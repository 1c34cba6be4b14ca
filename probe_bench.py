#!/usr/bin/env python3
"""Time builds of the probe kernel against each other on one CUDA card.

    python3 probe_bench.py [--other NAME=path/to/probe.cu ...] \\
        [--shapes main,full] [--reps 9]

Builds foundationdb_tpu_torch/csrc/probe.cu ("probe") and each --other
source that exports the same C entry point (e.g. an earlier commit's
probe.cu, taken with `git show <commit>:foundationdb_tpu_torch/csrc/probe.cu`)
through foundationdb_tpu_torch/_build.py, one nvcc each, all started
together. Then for each shape (sorted queries from chip_smoke.probe_case;
main = one config-5 8K-txn chunk, W1 = 4, NB = 65,536, B = 32,
P2 = 114,688; full = the same state with P2 = 917,504; main-lead and
full-lead the same with a constant first word) it holds every build
bit-exact against the plain version and times it warm and cold
(timing.device_ms), in turns: every build in order, then in reverse.
Prints each build's ptxas registers and one JSON line per (shape, build).
Needs a CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import probe_bound, probe_case
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.resolver import probe
from foundationdb_tpu_torch.timing import device_ms, l2_flusher

# name: (W1, NB, B, P2, constant leading words); "-lead" shapes decide
# compares past word 0, as config 5's packed 8-byte keys do.
SHAPES = {
    "main": (4, 65536, 32, 114688, 0), "full": (4, 65536, 32, 917504, 0),
    "main-lead": (4, 65536, 32, 114688, 1),
    "full-lead": (4, 65536, 32, 917504, 1),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--shapes", default="main,full")
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_bench: CUDA is not available", file=sys.stderr)
        return 2

    builds = ["probe"]
    for spec in args.other:
        name, path = spec.split("=", 1)
        _build.SOURCES[f"probe-{name}"] = Path(path).resolve()
        builds.append(f"probe-{name}")
    _build.build_all(builds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    for b in builds:
        regs = _build.ptxas_summary(_build.BUILD_LOG.get(b, ""))
        print(f"ptxas {b}: {regs or 'built earlier, no log'}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    flush = l2_flusher(dev)
    for shape in args.shapes.split(","):
        W1, NB, B, P2, lead = SHAPES[shape]
        h, f, q = probe_case(rng, W1, NB, B, P2, lead=lead)
        q = q[:, np.lexsort(q[::-1])]
        h, f, q = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                   for a in (h, f, q))
        want = torch.stack(probe.probe_ranks_ref(h, f, q, NB=NB, B=B))
        bound, _ = probe_bound(W1, NB, B, P2, want[0].cpu().numpy())
        outs = {b: torch.empty((3, P2), dtype=torch.int32, device=dev)
                for b in builds}

        def launcher(b):
            return lambda: probe.probe_ranks_into(outs[b], h, f, q, NB=NB,
                                                  B=B, build=b)

        fns = {b: launcher(b) for b in builds}
        for b, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            if not torch.equal(outs[b], want):
                raise SystemExit(f"probe_bench: {b} disagrees with the "
                                 f"plain version at {shape}")
        warm = {b: [] for b in builds}
        cold = {b: [] for b in builds}
        for order in (builds, builds[::-1]):
            for b in order:
                warm[b].append(device_ms(fns[b], n=50, reps=args.reps))
                cold[b].append(device_ms(fns[b], reps=args.reps, flush=flush))
        for b in builds:
            row = dict(shape=shape, build=b, W1=W1, NB=NB, B=B, P2=P2,
                       warm_ms=warm[b], cold_ms=cold[b], bound_ms=bound,
                       bound_share_cold=bound / float(np.mean(cold[b])))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
