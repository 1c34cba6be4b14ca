#!/usr/bin/env python3
"""Time the deployed tier's load by the number of concurrent loaders.

    python3 multiprocess_load_bench.py [--runs 16:4,16:8,16:16,16:32,18:4] \\
        [--device cuda|cpu]

For each run LOG2:LOADERS: a fresh deployment of chip_smoke.mp_spec's
shape (config 4 as `configure double ssd`, every class a role-host
process started as `server.py -r fdbd -c <class>`, on a temporary
directory removed at the end), then 2^LOG2 of config 1's keys loaded
through multiprocess.connect in 1,000-key transactions, LOADERS at a
time (chip_smoke.load_through_client). Prints one JSON line per run: the
load's wall seconds and keys per second, the recoveries the controller
started (the txn host's ControllerRecovering events, its boot's one or
two included) and the proxy's commit stages; the card's name and
power limit first. Run from the repo root; without a card pass
--device cpu (every host then runs the plain torch versions).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import chip_smoke as cs
from foundationdb_tpu_torch.cluster import multiprocess as mp
from foundationdb_tpu_torch.core.runtime import loop_context
from foundationdb_tpu_torch.net.transport import real_loop_with_transport


def load_run(root: Path, log2: int, loaders: int, device) -> dict:
    ports = dict(zip(cs.MP_CLASSES, cs.mp_free_ports(len(cs.MP_CLASSES))))
    hosts = cs.RoleHosts(root, cs.mp_spec(1 << 20, ports), device)
    try:
        for cls in cs.MP_CLASSES:
            hosts.start(cls)
        info = hosts.wait_for(cs.MP_CLASSES)
        keys = cs.load_key_set(1 << 20, 1 << log2)
        loop, transport = real_loop_with_transport()
        with loop_context(loop):
            db = mp.connect(transport, hosts.cf)

            async def main():
                t0 = time.perf_counter()
                await cs.load_through_client(db, keys, loaders)
                load_s = time.perf_counter() - t0
                events = (await cs.mp_rpc(
                    transport, info["txn"], mp.WLTOKEN_TRACE,
                    mp.TraceEventsRequest(
                        event_type="ControllerRecovering")))["events"]
                status = await cs.mp_rpc(transport, info["txn"],
                                         mp.WLTOKEN_TXN_STATUS,
                                         mp.TxnStatusRequest())
                return load_s, len(events), status

            load_s, recovering, status = loop.run(main(),
                                                  timeout_sim_seconds=1800)
            transport.close()
        loop.shutdown()
        return {"keys": len(keys), "loaders": loaders,
                "load_s": round(load_s, 2),
                "keys_per_s": round(len(keys) / load_s, 1),
                "controller_recovering": recovering,
                "stages": status["proxy"]["commit_pipeline"]["stages"]}
    finally:
        hosts.stop()


def main() -> int:
    ap = argparse.ArgumentParser(prog="multiprocess_load_bench.py")
    ap.add_argument("--runs", default="16:4,16:8,16:16,16:32,18:4",
                    help="LOG2:LOADERS pairs, comma-separated")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        from foundationdb_tpu_torch import _build

        _build.build_all()
    from foundationdb_tpu_torch.storage_engine import _native

    _native.load()
    tmp = Path(tempfile.mkdtemp(prefix="fdbtpu_load_bench_"))
    try:
        for i, run in enumerate(args.runs.split(",")):
            log2, loaders = (int(x) for x in run.split(":"))
            root = tmp / str(i)
            root.mkdir()
            print(json.dumps(load_run(root, log2, loaders, args.device)),
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
