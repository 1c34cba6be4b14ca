"""Interactive CLI (ref: fdbcli/fdbcli.actor.cpp — the operator shell).

    python -m foundationdb_tpu_torch.cli [--device cpu]
    python -m foundationdb_tpu_torch.cli --cluster-file <cluster.json>

Without --cluster-file, runs an in-process SHARDED cluster (4 storage
servers, double replication, data distribution running) on a real-time
event loop and evaluates one command per line — so the management verbs
operate on a real fleet. WITH --cluster-file it ATTACHES to a DEPLOYED
multiprocess cluster over the control RPCs: data verbs ride the normal
client connection, `status`/`recruitment` pull the controller's
documents over WLTOKEN_CONTROLLER (the same shell, anywhere — ref:
fdbcli connecting through fdb.cluster). Keys/values accept Python
bytes-literal escapes (e.g. prefix\\x00suffix).

The port's copy of foundationdb_tpu/cli.py. The embedded cluster keeps
its conflict sets and storage windows on `--device` (default: the CUDA
card, which must be present; without one the shell exits 2 naming it,
unless `--device cpu` was given). Attached to a deployed cluster the
shell holds no device: the role hosts hold it.

Commands (the fdbcli core surface):
    get <key>                     read a key
    set <key> <value>             write a key
    clear <key>                   clear a key
    clearrange <begin> <end>      clear a range
    getrange <begin> <end> [lim]  list key/value pairs
    status [json]                 cluster status (summary or full JSON;
                                  attached: served by the controller)
    recruitment [json]            worker registry + recruitment stalls
                                  (attached: the controller's registry)
    trace <debug-id>              flight recorder: fetch the sampled
                                  transaction's micro events from every
                                  process and print the stitched timeline
                                  with per-hop deltas (follows its commit
                                  batch's attach edge)
    events [--type T] [--severity N] [--last N]
                                  tail the fleet's recent trace events
    metrics [pattern]             one-shot metrics query: every process's
                                  registry entries matching the fnmatch
                                  pattern (e.g. `metrics proxy.*`)
    top [--iterations N] [--interval S]
                                  live per-role rates (commits/s, GRV/s,
                                  resolver percentiles, tlog qbytes,
                                  pipeline depth) from consecutive
                                  scrapes of every process, plus the hot
                                  commit band's exemplar debug ID (jump
                                  to `trace <id>`); N=0 refreshes until
                                  Ctrl-C
    configure <k=v> ...           set replicated configuration (\xff/conf)
    configuration                 show replicated configuration
    exclude [tag ...]             exclude storage servers (no args: list);
                                  data distribution drains them
    include <tag ...|all>         re-include excluded servers
    move-machine <id>             drain one machine end-to-end: exclude
                                  its storage (DD re-seeds the teams),
                                  demote + re-replicate its logs onto a
                                  recruited replacement, re-place the
                                  txn bundle, then retire it role-free
                                  (embedded --topology clusters)
    coordinators                  list the coordination quorum
    throttle <tps|off>            manual ratekeeper cap (fdbcli throttle)
    backup <url>                  snapshot into a container (fdbbackup)
    restore <url> [version]       restore a container snapshot (fdbrestore)
    backups <url>                 list a container's snapshot versions
    writemode <on|off>            guard mutations like fdbcli does
    help / exit
"""

from __future__ import annotations

import json
import sys

from .client.database import Database
from .cluster import LocalCluster
from .cluster.status import cluster_status
from .core.runtime import EventLoop, loop_context


def _backup_mod():
    from . import backup as _backup

    return _backup


def _b(token: str) -> bytes:
    return token.encode("utf-8").decode("unicode_escape").encode("latin-1")


def _p(raw: bytes) -> str:
    return repr(raw)[2:-1]  # b'...' -> ... with escapes


class Cli:
    def __init__(self, sharded: bool = True, cluster_file: str = None,
                 topology: bool = False, device=None):
        self.cluster_file = cluster_file
        self.write_mode = False
        self._transport = None
        self._ctrl = None
        self._ctrl_addr = None
        if cluster_file is not None:
            # ATTACH to a deployed multiprocess cluster: real transport,
            # client endpoints from the shared cluster file, and a
            # control stream to the controller's registry endpoint.
            from .cluster import multiprocess as mp
            from .net.transport import real_loop_with_transport

            self.loop, self._transport = real_loop_with_transport()
            self._ctx = loop_context(self.loop)
            self._ctx.__enter__()
            info = self._run(self._wait_deployment(), timeout=60)
            self.db: Database = mp.connect(self._transport, cluster_file)
            ctrl_addr = info.get("controller") or info["txn"]
            self._ctrl = self._transport.remote_stream(
                ctrl_addr, mp.WLTOKEN_CONTROLLER
            )
            self._ctrl_addr = ctrl_addr
            self.cluster = None
            self.dd = None
            return
        from .device import resolve_device

        resolve_device(device)
        self.loop = EventLoop()  # real clock: an interactive tool
        self._ctx = loop_context(self.loop)
        self._ctx.__enter__()
        if topology:
            # Machine-placed embedded cluster: the recoverable sharded
            # tier over a machine fault topology, with a controller, the
            # worker registry and data distribution running — what the
            # machine-lifecycle verbs (`move-machine`, `recruitment`)
            # operate on.
            from .cluster.recovery import RecoverableShardedCluster
            from .sim.topology import MachineTopology

            topo_kw = {"n_dcs": 1, "machines_per_dc": 6}
            self.cluster = RecoverableShardedCluster(
                n_storage=6, n_logs=2, replication="double",
                log_replication="double", shard_boundaries=[b"m"],
                topology=topo_kw, device=device,
            ).start()
            topo = MachineTopology(self.cluster, **topo_kw)
            self.cluster.sim_topology = topo
            self.dd = self.cluster.start_data_distribution(interval=0.2)
            self.cluster.start_controller("cli")
            self.db = self.cluster.database()
            return
        if sharded:
            # The management verbs (exclude/include + DD draining) need a
            # storage fleet; this is the fdbcli-against-a-real-cluster
            # shape.
            from .cluster.sharded_cluster import ShardedKVCluster

            self.cluster = ShardedKVCluster(
                n_storage=4, replication="double", device=device
            ).start()
            self.dd = self.cluster.start_data_distribution(interval=0.2)
        else:
            self.cluster = LocalCluster(device=device).start()
            self.dd = None
        self.db: Database = self.cluster.database()

    async def _wait_deployment(self) -> dict:
        """Poll the cluster file until the deployment's client-facing
        keys exist (txn publishes after its first recovery)."""
        from .cluster.multiprocess import read_cluster_file
        from .core.runtime import current_loop

        loop = current_loop()
        while True:
            info = read_cluster_file(self.cluster_file) or {}
            if "txn" in info and "storage" in info:
                return info
            await loop.delay(0.2)

    def _run(self, coro, timeout: float = 30):
        task = self.loop.spawn(coro, name="cli")
        return self.loop.run_until(task.done, timeout_sim_seconds=timeout)

    def _controller_rpc(self, req):
        """One request/reply against the controller endpoint (attached
        mode only). The controller address is re-resolved from the
        cluster file per call: a controller FAILOVER re-points the
        `controller` key at the new leaseholder, and the shell must
        follow it to keep reading status/recruitment from the live
        seat."""
        from .cluster.multiprocess import WLTOKEN_CONTROLLER, read_cluster_file
        from .core.actors import timeout_error

        info = read_cluster_file(self.cluster_file) or {}
        addr = info.get("controller") or info.get("txn")
        if addr and addr != self._ctrl_addr:
            self._ctrl = self._transport.remote_stream(
                addr, WLTOKEN_CONTROLLER
            )
            self._ctrl_addr = addr

        async def rpc():
            self._ctrl.send(req)
            return await timeout_error(req.reply.future, 15)

        return self._run(rpc())

    # -- flight recorder (trace / events verbs) --
    def _trace_addresses(self) -> dict:
        """role -> address of every process of the attached deployment
        (cluster-file keys holding host:port strings; the controller
        alias duplicates the txn host and is dropped)."""
        from .cluster.multiprocess import read_cluster_file

        info = read_cluster_file(self.cluster_file) or {}
        out = {}
        seen = set()
        for k in sorted(info):
            v = info[k]
            if k in ("spec", "controller") or not isinstance(v, str) \
                    or ":" not in v:
                continue
            if v in seen:
                continue
            seen.add(v)
            out[k] = v
        return out

    def fetch_trace_events(self, **kw) -> list[tuple[str, dict]]:
        """(process, event) pairs matching a TraceEventsRequest filter,
        pulled from every process of the deployment (attached) or from
        the embedded cluster's global sink. Unreachable processes are
        skipped — a dead host must not hide the survivors' evidence."""
        if self._ctrl is None:
            from .core.trace import global_sink

            req_dbg = kw.get("debug_id")
            req_type = kw.get("event_type")
            req_sev = kw.get("min_severity", 0)
            out = []
            for e in global_sink().events:
                if req_dbg is not None and (
                    e.get("DebugID") != req_dbg and e.get("To") != req_dbg
                ):
                    continue
                if req_type is not None and e.get("Type") != req_type:
                    continue
                if req_sev and e.get("Severity", 0) < req_sev:
                    continue
                out.append(("local", e))
            if kw.get("last"):
                out = out[-kw["last"]:]
            return out
        from .cluster import multiprocess as mp
        from .core.actors import timeout

        out = []
        for role, addr in self._trace_addresses().items():
            req = mp.TraceEventsRequest(**kw)
            stream = self._transport.remote_stream(addr, mp.WLTOKEN_TRACE)

            async def rpc(req=req, stream=stream):
                stream.send(req)
                return await timeout(req.reply.future, 10, None)

            reply = self._run(rpc(), timeout=15)
            if reply is None:
                continue
            proc = reply.get("process") or role
            for e in reply.get("events", []):
                out.append((proc, e))
        return out

    # -- metrics plane (metrics / top verbs) --
    def fetch_metrics(self, pattern: str = "",
                      series: bool = False) -> dict[str, list]:
        """{process: [metric entries]} scraped from every process of the
        deployment (attached: MetricsRequest over WLTOKEN_METRICS) or
        from the embedded cluster's per-loop registry. Unreachable
        processes are skipped, like the trace fan-out."""
        if self._ctrl is None:
            from .core.metrics import global_registry

            snap = global_registry().snapshot(
                volatile=True, pattern=pattern or "", series=series
            )
            return {"local": json.loads(json.dumps(snap, default=str))}
        from .cluster import multiprocess as mp
        from .core.actors import timeout

        out: dict[str, list] = {}
        for role, addr in self._trace_addresses().items():
            req = mp.MetricsRequest(pattern=pattern or "", series=series)
            stream = self._transport.remote_stream(addr, mp.WLTOKEN_METRICS)

            async def rpc(req=req, stream=stream):
                stream.send(req)
                return await timeout(req.reply.future, 10, None)

            reply = self._run(rpc(), timeout=15)
            if reply is None:
                continue
            out[reply.get("process") or role] = reply.get("metrics", [])
        return out

    @staticmethod
    def _metric_map(entries: list) -> dict:
        """(name, labels) -> entry, for rate math between two scrapes."""
        return {
            (e["name"], tuple(sorted((e.get("labels") or {}).items()))): e
            for e in entries
        }

    @staticmethod
    def _bands_percentile(value: dict, q: float):
        """Approximate percentile from a cumulative LatencyBands status
        value: the smallest edge covering fraction q (None if empty)."""
        total = value.get("total") or 0
        if not total:
            return None
        need = q * total
        for edge, acc in value.get("bands_ms", {}).items():
            if edge != "inf" and acc >= need:
                return float(edge)
        return float("inf")

    def _render_top_frame(self, prev: dict, cur: dict, dt: float) -> str:
        """One `top` frame: per-process rates (from consecutive counter
        scrapes), pipeline gauges, resolver percentiles, and the hot
        commit band's exemplar debug ID (the jump-off to `trace <id>`)."""
        lines = [f"fdbtpu top — {len(cur)} process(es), "
                 f"window {dt:.1f}s  (rates are per second)"]
        hot_exemplar = None
        hot_edge = None
        for proc in sorted(cur):
            cm = self._metric_map(cur[proc])
            pm = self._metric_map(prev.get(proc, []))

            def rate(name, cm=cm, pm=pm):
                tot = sum(e["value"] for (n, _), e in cm.items()
                          if n == name and isinstance(e["value"], (int, float)))
                was = sum(e["value"] for (n, _), e in pm.items()
                          if n == name and isinstance(e["value"], (int, float)))
                return (tot - was) / dt if dt > 0 else 0.0

            def gauge(name, cm=cm):
                vals = [e["value"] for (n, _), e in cm.items() if n == name
                        and isinstance(e["value"], (int, float))]
                return sum(vals) if vals else None

            cells = []
            if any(n == "proxy.txns_committed" for n, _ in cm):
                cells.append(f"commits/s {rate('proxy.txns_committed'):8.1f}")
                cells.append(f"grv/s {rate('proxy.grvs_served'):8.1f}")
                cells.append(
                    f"conflicts/s {rate('proxy.txns_conflicted'):6.1f}")
                d = gauge("proxy.commit_inflight_depth")
                if d is not None:
                    cells.append(f"pipeline depth {int(d)}")
            for (n, _), e in sorted(cm.items()):
                if n == "proxy.commit_ms" and isinstance(e["value"], dict):
                    ex = e["value"].get("exemplars") or {}
                    for edge in sorted(
                        ex, key=lambda k: float("inf") if k == "inf"
                        else float(k)
                    ):
                        hot_exemplar, hot_edge = ex[edge], edge
            if any(n == "resolver.batch_ms" for n, _ in cm):
                vals = [e["value"] for (n, _), e in cm.items()
                        if n == "resolver.batch_ms"]
                p50 = self._bands_percentile(vals[0], 0.5)
                p99 = self._bands_percentile(vals[0], 0.99)
                cells.append(f"resolve p50<= {p50}ms p99<= {p99}ms")
                cells.append(
                    f"resolved/s {rate('resolver.txns_count'):8.1f}")
            qb = gauge("tlog.queue_bytes")
            if qb is not None:
                cells.append(f"tlog qbytes {int(qb)}")
            dv = gauge("storage.data_version")
            if dv is not None:
                cells.append(f"storage v {int(dv)}")
            rss = gauge("process.resident_bytes")
            if rss is not None:
                cells.append(f"rss {int(rss) >> 20}MB")
            # r18: per-connection wire I/O (transport.bytes_in/out totals;
            # per-peer splits live under transport.peer.* for scrapes).
            if any(n == "transport.bytes_in" for n, _ in cm):
                cells.append(
                    f"net in/out KB/s "
                    f"{rate('transport.bytes_in') / 1024:7.1f}/"
                    f"{rate('transport.bytes_out') / 1024:7.1f}")
            lines.append(f"  [{proc:<28}] " + "  ".join(cells))
        if hot_exemplar:
            lines.append(
                f"  hot commit band (<= {hot_edge} ms) exemplar: "
                f"{hot_exemplar}  — `trace {hot_exemplar}` for its "
                "cross-process timeline"
            )
        return "\n".join(lines)

    def top(self, iterations: int = 1, interval: float = 1.0,
            echo=None) -> str:
        """Live per-role view: scrape, wait `interval`, scrape again,
        render rates; repeat `iterations` times (0 = until Ctrl-C).
        Returns the last frame (intermediate frames go to `echo`)."""
        from .core.runtime import current_loop

        async def pause():
            await current_loop().delay(interval)

        prev = self.fetch_metrics()
        frame = ""
        i = 0
        while True:
            self._run(pause(), timeout=interval + 30)
            cur = self.fetch_metrics()
            frame = self._render_top_frame(prev, cur, interval)
            prev = cur
            i += 1
            if iterations and i >= iterations:
                return frame
            if echo is not None:
                echo("\x1b[2J\x1b[H" + frame)

    def trace_timeline(self, debug_id: str) -> list[tuple[str, dict]]:
        """The stitched flight-recorder timeline of one debug ID: its own
        events, plus (following TransactionAttach edges both ways) the
        commit batches it joined — sorted by event time."""
        events = self.fetch_trace_events(debug_id=debug_id)
        related = {
            e.get("To") for _, e in events
            if e.get("Type") == "TransactionAttach"
            and e.get("DebugID") == debug_id and e.get("To")
        }
        related |= {
            e.get("DebugID") for _, e in events
            if e.get("Type") == "TransactionAttach"
            and e.get("To") == debug_id and e.get("DebugID")
        }
        related.discard(debug_id)
        for rid in sorted(related):
            events.extend(self.fetch_trace_events(debug_id=rid))
        seen = set()
        uniq = []
        for proc, e in events:
            key = (proc, json.dumps(e, sort_keys=True, default=str))
            if key not in seen:
                seen.add(key)
                uniq.append((proc, e))
        uniq.sort(key=lambda pe: (pe[1].get("Time") or 0.0))
        return uniq

    @staticmethod
    def _render_event_line(t0, prev, proc: str, e: dict) -> str:
        t = e.get("Time") or 0.0
        hop = e.get("Location") or e.get("Type")
        extras = " ".join(
            f"{k}={e[k]}" for k in sorted(e)
            if k not in ("Time", "Type", "Severity", "Location", "DebugID")
        )
        return (f"  {t - t0:10.6f}s  (+{(t - prev) * 1e3:9.3f} ms)  "
                f"[{proc:<24}] {hop:<22} {extras}")

    def _render_timeline(self, debug_id: str) -> str:
        timeline = self.trace_timeline(debug_id)
        if not timeline:
            return (f"no flight-recorder events for {debug_id} — was the "
                    "transaction sampled (client:COMMIT_SAMPLE_RATE) and "
                    "recent enough for the in-memory windows?")
        t0 = timeline[0][1].get("Time") or 0.0
        lines = [f"flight recorder: {debug_id} "
                 f"({len(timeline)} events, "
                 f"{len({p for p, _ in timeline})} processes)"]
        prev = t0
        for proc, e in timeline:
            lines.append(self._render_event_line(t0, prev, proc, e))
            prev = e.get("Time") or prev
        return "\n".join(lines)

    def execute(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0].lower(), parts[1:]
        try:
            return self._dispatch(cmd, args)
        except Exception as e:  # noqa: BLE001 — the shell reports, not dies
            return f"ERROR: {type(e).__name__}: {e}"

    def _need_write_mode(self):
        if not self.write_mode:
            raise RuntimeError(
                "writemode must be enabled to modify the database "
                "(`writemode on`)"
            )

    def _dispatch(self, cmd: str, args: list[str]) -> str:
        db = self.db
        if cmd == "get":
            (key,) = args
            v = self._run(db.get(_b(key)))
            return f"`{key}' is `{_p(v)}'" if v is not None else f"`{key}': not found"
        if cmd == "set":
            key, value = args
            self._need_write_mode()
            self._run(db.set(_b(key), _b(value)))
            return "Committed"
        if cmd == "clear":
            (key,) = args
            self._need_write_mode()
            self._run(db.clear(_b(key)))
            return "Committed"
        if cmd == "clearrange":
            begin, end = args
            self._need_write_mode()

            async def body(tr):
                tr.clear_range(_b(begin), _b(end))

            self._run(db.transact(body))
            return "Committed"
        if cmd == "getrange":
            begin, end = args[0], args[1]
            limit = int(args[2]) if len(args) > 2 else 25

            async def body(tr):
                return await tr.get_range(_b(begin), _b(end), limit=limit)

            rows = self._run(db.transact(body))
            lines = [f"`{_p(k)}' is `{_p(v)}'" for k, v in rows]
            return "\n".join(lines) if lines else "Range empty"
        if cmd == "status":
            if self._ctrl is not None:
                from .cluster.interfaces import ClusterStatusRequest

                st = self._controller_rpc(ClusterStatusRequest())
            else:
                st = cluster_status(self.cluster)
            if args and args[0] == "json":
                return json.dumps(st, indent=2, default=str)
            c = st["cluster"]
            w = c["workload"]["transactions"]
            return (
                f"Recovery state: {c['recovery_state']['name']}\n"
                f"Latest version: {c['latest_version']}\n"
                f"Committed:      {w['committed']} txns "
                f"({w['conflicted']} conflicted)\n"
                f"Roles:          "
                + (", ".join(r["role"] for r in c["roles"]) or "(none)")
            )
        if cmd == "recruitment":
            if self._ctrl is None:
                topo = getattr(self.cluster, "sim_topology", None)
                if topo is None:
                    return ("This deployment has no worker registry "
                            "(embedded in-process cluster); attach to a "
                            "deployed cluster with --cluster-file")
                rec = topo.registry.status()
            else:
                from .cluster.interfaces import RecruitmentStatusRequest

                rec = self._controller_rpc(RecruitmentStatusRequest())
            if args and args[0] == "json":
                return json.dumps(rec, indent=2, default=str)
            lines = []
            state = rec.get("recovery_state")
            if state:
                lines.append(f"Recovery state: {state}")
            for w in rec["workers"]:
                lines.append(
                    f"worker {w['id']:<28} class={w['class']:<10} "
                    f"machine={w['machine'] or '-':<8} "
                    f"{'live' if w['live'] else 'DEAD'} "
                    f"(beat {w['age_s']}s ago)"
                )
            for role, wid in sorted(rec.get("recruited", {}).items()):
                lines.append(f"recruited {role} -> {wid}")
            stalls = rec.get("stalls", {})
            details = rec.get("stall_details", {})
            if stalls:
                for role, since in sorted(stalls.items()):
                    d = details.get(role, {})
                    awaiting = d.get("awaiting") or role
                    cands = d.get("candidates")
                    why = f"awaiting {awaiting}"
                    if cands is not None:
                        why += f", {cands} candidate(s)"
                    if d.get("detail"):
                        why += f" — {d['detail']}"
                    lines.append(
                        f"STALL recruiting_{role} for {since}s ({why})"
                    )
            else:
                lines.append("No recruitment stalls.")
            return "\n".join(lines)
        if cmd == "trace":
            if len(args) != 1:
                return "usage: trace <debug-id>"
            return self._render_timeline(args[0])
        if cmd == "metrics":
            pattern = args[0] if args else ""
            per_proc = self.fetch_metrics(pattern=pattern)
            lines = []
            for proc in sorted(per_proc):
                for e in per_proc[proc]:
                    lbl = "".join(
                        f"{{{k}={v}}}" for k, v in
                        sorted((e.get("labels") or {}).items())
                    )
                    v = e["value"]
                    if isinstance(v, dict):
                        v = json.dumps(v, sort_keys=True)
                    lines.append(
                        f"[{proc:<28}] {e['name']}{lbl} = {v}"
                    )
            return "\n".join(lines) if lines else (
                f"no metrics match {pattern!r}"
            )
        if cmd == "top":
            iterations, interval = 1, 1.0
            it = iter(args)
            for a in it:
                if a == "--iterations":
                    iterations = int(next(it))
                elif a == "--interval":
                    interval = float(next(it))
                else:
                    return "usage: top [--iterations N] [--interval S]"
            return self.top(iterations=iterations, interval=interval,
                            echo=print)
        if cmd == "events":
            kw: dict = {}
            last = 20
            it = iter(args)
            for a in it:
                if a == "--type":
                    kw["event_type"] = next(it)
                elif a == "--severity":
                    kw["min_severity"] = int(next(it))
                elif a == "--last":
                    last = int(next(it))
                else:
                    return "usage: events [--type T] [--severity N] [--last N]"
            evs = self.fetch_trace_events(**kw)
            evs.sort(key=lambda pe: (pe[1].get("Time") or 0.0))
            evs = evs[-last:]
            if not evs:
                return "no matching events"
            t0 = evs[0][1].get("Time") or 0.0
            lines = []
            prev = t0
            for proc, e in evs:
                lines.append(self._render_event_line(t0, prev, proc, e))
                prev = e.get("Time") or prev
            return "\n".join(lines)
        if cmd == "configure":
            self._need_write_mode()
            from .cluster import management

            settings = dict(a.split("=", 1) for a in args)
            self._run(management.configure(self.db, **settings))
            return "Configuration changed"
        if cmd == "configuration":
            from .cluster import management

            conf = self._run(management.get_configuration(self.db))
            return "\n".join(f"{k} = {v}" for k, v in sorted(conf.items())) \
                or "(defaults)"
        if cmd == "exclude":
            from .cluster import management

            if not args:
                ex = self._run(management.get_excluded_servers(self.db))
                return ("Excluded servers: "
                        + (", ".join(map(str, sorted(ex))) or "(none)"))
            self._need_write_mode()
            tags = [int(a) for a in args]
            self._run(management.exclude_servers(self.db, tags))
            return (f"Excluded {', '.join(map(str, tags))}; data "
                    "distribution will drain them (watch `status json`)")
        if cmd == "move-machine":
            if len(args) != 1:
                return "usage: move-machine <machine-id>  (e.g. m0)"
            self._need_write_mode()
            if self.cluster is None or getattr(
                self.cluster, "sim_topology", None
            ) is None:
                return ("move-machine needs a machine-placed cluster "
                        "(run the shell with --topology; deployed "
                        "clusters drain via exclude + machine kill.sh)")
            from .cluster import management

            s = self._run(
                management.move_machine(self.db, self.cluster, args[0]),
                timeout=180,
            )
            return (f"machine {s['machine']} drained and retired: "
                    f"storage {s['excluded_storage']} excluded, "
                    f"logs {s['demoted_logs']} demoted and "
                    "re-replicated (watch `status json` machines)")
        if cmd == "include":
            self._need_write_mode()
            from .cluster import management

            tags = None if args == ["all"] or not args else [
                int(a) for a in args
            ]
            self._run(management.include_servers(self.db, tags))
            return "Included"
        if cmd == "coordinators":
            if self.cluster is None:
                return ("Coordinators live in the txn host's datadir on "
                        "a deployed cluster; see `status json`")
            coords = getattr(self.cluster, "coordinators", None)
            if not coords:
                return ("This deployment runs without a coordination "
                        "quorum (single-process cluster)")
            return "\n".join(
                f"{c.name}: {'available' if c.available else 'DOWN'}"
                for c in coords
            )
        if cmd == "throttle":
            rk = getattr(self.cluster, "ratekeeper", None)
            if rk is None:
                return "No ratekeeper reachable from this shell"
            if not args or args[0] == "off":
                rk.manual_limit = None
                return "Throttle cleared (automatic rate control)"
            rk.manual_limit = float(args[0])
            return f"Manual throttle: {rk.manual_limit} TPS cap"
        if cmd == "backup":
            if len(args) != 1:
                return "usage: backup <container-url>  (file://dir | memory://name)"
            v = self._run(_backup_mod().backup_to_container(self.db, args[0]))
            return f"backup complete at version {v}"
        if cmd == "restore":
            self._need_write_mode()
            if not 1 <= len(args) <= 2:
                return "usage: restore <container-url> [version]"
            ver = int(args[1]) if len(args) == 2 else None
            n = self._run(_backup_mod().restore_from_container(
                self.db, args[0], ver))
            return f"restored {n} rows"
        if cmd == "backups":
            if len(args) != 1:
                return "usage: backups <container-url>"
            from .backup_container import open_container
            snaps = open_container(args[0]).list_snapshots()
            return "\n".join(str(s) for s in snaps) or "(none)"
        if cmd == "writemode":
            self.write_mode = args and args[0] == "on"
            return f"writemode {'on' if self.write_mode else 'off'}"
        if cmd == "help":
            return __doc__.split("Commands")[1]
        if cmd in ("exit", "quit"):
            raise SystemExit(0)
        return f"ERROR: unknown command `{cmd}' (try help)"

    def close(self):
        if self.cluster is not None:
            self.cluster.stop()
        if self._transport is not None:
            self._transport.close()
        self._ctx.__exit__(None, None, None)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="foundationdb_tpu_torch.cli")
    ap.add_argument("-C", "--cluster-file",
                    help="attach to a DEPLOYED multiprocess cluster via "
                         "its shared cluster file instead of starting an "
                         "embedded one")
    ap.add_argument("--topology", action="store_true",
                    help="embedded mode: start a MACHINE-PLACED "
                         "recoverable cluster (worker registry, "
                         "controller, data distribution) so the machine "
                         "lifecycle verbs — move-machine, recruitment — "
                         "operate on real placement")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="embedded mode: where the cluster's conflict "
                         "sets and storage windows run (default: the "
                         "CUDA card, which must be present)")
    ap.add_argument("command", nargs="*",
                    help="one-shot: run a single shell command (e.g. "
                         "`trace <debug-id>`, `events --severity 30`, "
                         "`status json`) and exit")
    args = ap.parse_args(argv)
    if args.cluster_file is None:
        from .device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"fdbtpu-cli: {e}", file=sys.stderr)
            raise SystemExit(2)
    cli = Cli(cluster_file=args.cluster_file, topology=args.topology,
              device=args.device)
    if args.command:
        # One-shot verb: scriptable operator path (the acceptance tests'
        # `cli.py trace <debug-id>` invocation shape).
        try:
            out = cli.execute(" ".join(args.command))
            if out:
                print(out)
        finally:
            cli.close()
        return
    if args.cluster_file:
        print(f"fdbtpu-cli: attached to {args.cluster_file} (type help)")
    elif args.topology:
        print("fdbtpu-cli: machine-placed cluster started: 6 machines / "
              "6 storage / double replication + double log replication "
              "(type help)")
    else:
        print("fdbtpu-cli: sharded cluster started: 4 storage / double replication (type help)")
    try:
        while True:
            try:
                line = input("fdbtpu> ")
            except EOFError:
                break
            out = cli.execute(line)
            if out:
                print(out)
    except SystemExit:
        pass
    finally:
        cli.close()


if __name__ == "__main__":
    main()
