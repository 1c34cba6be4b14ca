"""The server entrypoint (ref: fdbserver/fdbserver.actor.cpp — one binary
hosting every role, selected by `-r`; knobs set via --knob NAME=VALUE).

    python -m foundationdb_tpu_torch.server -r simulation -f spec.json
    python -m foundationdb_tpu_torch.server -r fdbd -c <class> -C <cf> -d <dir>
    python -m foundationdb_tpu_torch.server -r fdbd -m <machine> -C <cf> -d <dir>
    python -m foundationdb_tpu_torch.server -r fdbd [--sharded ...]
    python -m foundationdb_tpu_torch.server -r cli [-C <cf>] [command ...]

each with [--knob NAME=VALUE] [--device cpu]. The port's copy of
foundationdb_tpu/server.py. Roles:

  simulation   run a spec file (the workloads/tester format, JSON) under
               the deterministic simulator on the CUDA card (or on the CPU
               with --device cpu) and print the result JSON, or
               {"ok": ..., "seeds": ...} for a randomized spec — exit 0
               iff every seed checked out.
  fdbd         with -c: ONE role host of a multi-process cluster
               (cluster/multiprocess.py): log / logN / storage / resolver /
               resolverN / txn / txnN, discovering its peers through the
               cluster file (-C) and keeping its files in -d, until
               SIGTERM/SIGINT. The storage, resolver and txn classes keep
               their windows and conflict sets on the CUDA card (or on the
               CPU with --device cpu); without a card they exit 2 before
               they publish their address. With -m: every class the spec's
               `machines` stanza gives that machine, as child processes of
               one shared-fate process group, each given the same
               --device. Without -c or -m: an in-process cluster
               (LocalCluster, or ShardedKVCluster with --sharded) on a
               real-clock loop, until SIGINT.
  cli          the operator shell (cli.py): an embedded sharded cluster
               on the CUDA card (or on the CPU with --device cpu; without
               a card and without it, exit 2 naming CUDA), or with -C
               attached to a deployed cluster, which holds no device. One
               command per line from stdin, or one positional command and
               exit.
"""

from __future__ import annotations

import argparse
import json
import sys

def _apply_knobs(knob_args: list[str]) -> None:
    from .core.knobs import CLIENT_KNOBS, SERVER_KNOBS

    for ka in knob_args:
        name, _, value = ka.partition("=")
        if not value:
            raise SystemExit(f"--knob {ka!r}: expected NAME=VALUE")
        name = name.upper()
        for knobs in (SERVER_KNOBS, CLIENT_KNOBS):
            try:
                knobs.set_knob(name, value)
                break
            except KeyError:
                continue
            except (TypeError, ValueError) as e:
                raise SystemExit(
                    f"bad value for knob {name}: {value!r} ({e})"
                )
        else:
            raise SystemExit(f"unknown knob {name}")
    # Value-level validation of enum-shaped knobs, EAGERLY at startup: a
    # typo'd CONFLICT_SET_IMPL (or the JAX package's "tpu") must
    # fail the process here with the known-impl list, not deep inside a
    # resolver's recruitment.
    from .resolver.factory import validate_conflict_set_impl
    from .storage_engine.factory import validate_storage_engine_impl

    try:
        validate_conflict_set_impl()
        validate_storage_engine_impl()
    except ValueError as e:
        raise SystemExit(str(e))


def _spec_from_file(path: str) -> dict:
    with open(path) as f:
        spec = json.load(f)
    # Byte-ish fields arrive as strings in JSON; shard boundaries are the
    # only ones the spec format needs.
    ckw = spec.get("cluster", {})
    if "shard_boundaries" in ckw:
        ckw["shard_boundaries"] = [
            b.encode() if isinstance(b, str) else b
            for b in ckw["shard_boundaries"]
        ]
    return spec


def run_simulation(path: str, device=None) -> int:
    from .workloads.tester import run_spec

    spec = _spec_from_file(path)
    if spec.get("randomized"):
        # Per-seed randomized SimulationConfig (sim/config.py): each seed
        # derives cluster shape + knobs + workload mix deterministically;
        # the printed config IS the reproduction recipe. Always emits the
        # one-line JSON contract, even on malformed specs.
        from .sim.config import run_randomized

        try:
            seeds = spec["seeds"]
            run_randomized(seeds, log=lambda m: print(m, file=sys.stderr),
                           device=device)
        except BaseException as e:  # noqa: BLE001 - CI parses stdout
            print(json.dumps(
                {"ok": False, "error": f"{type(e).__name__}: {e}"}
            ))
            return 1
        print(json.dumps({"ok": True, "seeds": seeds}))
        return 0
    result = run_spec(spec, device=device)
    print(json.dumps(result, default=str, indent=2))
    return 0 if result.get("ok") and result.get("sev_errors", 0) == 0 else 1


def _mode_replicas(mode: str) -> int:
    from .cluster.replication import policy_for_mode

    return policy_for_mode(mode).num_replicas()


def run_fdbd(sharded: bool, log_replication: str = "single",
             metrics_port: int = 0, device=None) -> int:
    from .core.runtime import EventLoop, loop_context

    loop = EventLoop()
    if metrics_port:
        # The exposition endpoint rides the loop's reactor; the embedded
        # fdbd has no transport, so attach one just for it.
        from .net.reactor import SelectReactor

        loop.reactor = SelectReactor()
    with loop_context(loop):
        if sharded:
            from .cluster.sharded_cluster import ShardedKVCluster

            cluster = ShardedKVCluster(
                log_replication=log_replication,
                n_logs=max(2, _mode_replicas(log_replication)),
                device=device,
            ).start()
        else:
            from .cluster.cluster import LocalCluster

            cluster = LocalCluster(device=device).start()
        if metrics_port:
            from .core.metrics import global_registry
            from .core.system_monitor import register_process_metrics
            from .net.http import TextHTTPServer

            registry = global_registry()
            register_process_metrics(registry)
            registry.start_sampler()
            http_metrics = TextHTTPServer(
                metrics_port, lambda: registry.prometheus_text(),
                content_type="text/plain; version=0.0.4",
            ).start()
            print(f"fdbtpu: metrics exposition on :{http_metrics.port}"
                  "/metrics", file=sys.stderr)
        print("fdbtpu: cluster serving (ctrl-c to stop)", file=sys.stderr)

        async def serve_forever():
            from .core.runtime import current_loop

            while True:
                await current_loop().delay(3600.0)

        try:
            loop.run(serve_forever())
        except KeyboardInterrupt:
            cluster.stop()
            print("fdbtpu: shutdown", file=sys.stderr)
    return 0


def run_role_host(args) -> int:
    """One multi-process role host (ref: fdbserver -c <machine class>):
    serves its role class over TCP, discovering peers via the cluster
    file, until SIGTERM/SIGINT."""
    import signal
    import threading

    from .cluster.multiprocess import run_role_host as _run

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    ready = threading.Event()

    def announce():
        ready.wait()
        print(f"fdbtpu[{args.process_class}]: serving at {ready.address}",
              file=sys.stderr, flush=True)

    threading.Thread(target=announce, daemon=True).start()
    _run(args.process_class, args.cluster_file, args.datadir,
         ready=ready, stop_event=stop, machine_id=args.machine_id or "",
         trace_dir=args.trace_dir or "",
         metrics_port=args.metrics_port or 0, device=args.device)
    return 0


def run_machine_host(args) -> int:
    """One MACHINE of a multi-process cluster (ref: fdbmonitor running a
    machine's fdbd fleet): every process class the spec assigns to this
    machine id, as one shared-fate process group."""
    import signal
    import threading

    from .cluster.multiprocess import run_machine

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    return run_machine(args.machine, args.cluster_file, args.datadir,
                       stop_event=stop, device=args.device)


def _device_ok(device) -> bool:
    """resolve_device(device), its message on stderr when it fails."""
    from .device import resolve_device

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="foundationdb_tpu_torch.server",
        description="Roles: simulation (a spec under the simulator), fdbd "
                    "(-c: one role host of a multi-process cluster, log / "
                    "logN / storage / resolver / resolverN / txn; -m: one "
                    "machine's classes; neither: an in-process cluster), "
                    "cli (the operator shell).",
    )
    ap.add_argument("-r", "--role", default="fdbd",
                    choices=["fdbd", "simulation", "cli"])
    ap.add_argument("-f", "--testfile", help="spec file for -r simulation")
    ap.add_argument("--sharded", action="store_true",
                    help="fdbd: start the sharded/replicated tier")
    ap.add_argument("--log-replication", default="single",
                    choices=["single", "double", "triple"],
                    help="fdbd --sharded: k-way log replication mode "
                         "(multi-process deployments set the spec's "
                         "log_replication key instead)")
    ap.add_argument("-c", "--class", dest="process_class",
                    help="fdbd: host ONE role class of a multi-process "
                         "cluster: log / logN (one failure domain of an "
                         "N-host log quorum) / storage / resolver / "
                         "resolverN / txn (requires --cluster-file and "
                         "--datadir)")
    ap.add_argument("-m", "--machine",
                    help="fdbd: run EVERY process class the spec's "
                         "`machines` stanza assigns to this machine id, "
                         "as ONE shared-fate process group (requires "
                         "--cluster-file and --datadir; a kill.sh is "
                         "written into the datadir)")
    ap.add_argument("--machine-id", default="",
                    help="fdbd --class: the machine/failure-domain id "
                         "reported in worker registration")
    ap.add_argument("-C", "--cluster-file",
                    help="shared cluster file (multi-process discovery)")
    ap.add_argument("-d", "--datadir", help="data directory (durable tier)")
    ap.add_argument("--trace-dir", default="",
                    help="fdbd --class: directory for this process's "
                         "rolling trace files (trace-<class>.jsonl; "
                         "default: <datadir>/trace.jsonl). The spec's "
                         "trace_dir key sets it fleet-wide.")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve the Prometheus text exposition of this "
                         "process's MetricRegistry over HTTP on this "
                         "port (real tier: fdbd and --class role hosts; "
                         "0 = off; the spec's metrics_ports map sets it "
                         "per class fleet-wide)")
    ap.add_argument("--knob", action="append", default=[],
                    metavar="NAME=VALUE", help="set a knob (repeatable)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the device backends run (default: the "
                         "CUDA card, which must be present); -m passes it "
                         "on to every child")
    ap.add_argument("command", nargs="*",
                    help="-r cli: one shell command to run before exiting "
                         "(e.g. `status json`)")
    args = ap.parse_args(argv)
    _apply_knobs(args.knob)

    if args.command and args.role != "cli":
        ap.error("a positional command is for -r cli only")
    if args.role == "cli":
        from .cli import main as cli_main

        argv_cli = ["--cluster-file", args.cluster_file] \
            if args.cluster_file else []
        if args.device is not None:
            argv_cli += ["--device", args.device]
        try:
            cli_main(argv_cli + args.command)
        except SystemExit as e:
            return e.code if isinstance(e.code, int) else 1
        return 0
    if args.role == "simulation":
        if not args.testfile:
            ap.error("-r simulation requires -f <spec.json>")
        if not _device_ok(args.device):
            return 2
        return run_simulation(args.testfile, device=args.device)
    if args.machine:
        if not args.cluster_file or not args.datadir:
            ap.error("--machine requires --cluster-file and --datadir")
        return run_machine_host(args)
    if args.process_class:
        if not args.cluster_file or not args.datadir:
            ap.error("--class requires --cluster-file and --datadir")
        from .cluster.multiprocess import holds_device

        if holds_device(args.process_class) and not _device_ok(args.device):
            return 2
        return run_role_host(args)
    if args.log_replication != "single" and not args.sharded:
        ap.error("--log-replication requires --sharded (the one-process "
                 "cluster has a single log)")
    if not _device_ok(args.device):
        return 2
    return run_fdbd(args.sharded, log_replication=args.log_replication,
                    metrics_port=args.metrics_port, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
