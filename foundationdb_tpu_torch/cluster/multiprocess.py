"""Multi-process deployment: the sharded tier split across OS processes
riding the real FlowTransport (ref: every fdbd role boundary is a
RequestStream over FlowTransport — fdbrpc/FlowTransport.actor.cpp; the
worker hosts a role subset per process class, worker.actor.cpp:593).

Three process classes (the reference's machine-class split):

    log      hosts the DurableTaggedTLogs (fsync on the commit path);
             serves per-log commit + control (peek/pop/lock/...) endpoints
    storage  hosts the engine-backed storage fleet; serves per-tag read +
             control (rollback/status) endpoints; PULLS the mutation
             stream from the log host over TCP
    txn      hosts coordinators, the controller, and the per-generation
             master/resolver/proxy/ratekeeper; serves the client-facing
             GRV/commit/location endpoints (stable across recoveries via
             EndpointRef) and a read forwarder for single-address wire
             clients (the C client)

Topology (shard boundaries, teams, tag->log routing) is DERIVED, not
exchanged: every host computes `derive_layout` from the same deployment
spec (the cluster file carries the spec), the reference's equivalent of
every worker reading the same conf.

Recovery is the same masterCore sequence as the in-process tiers, with
the lock / truncate / skip / rollback steps as awaited RPCs to the log
and storage hosts.

The port's copy of foundationdb_tpu/cluster/multiprocess.py. The device
state lives where the JAX package's does, on `device` (None: the CUDA
card; "cpu" runs the plain torch versions): the storage host's MVCC
windows (KeyValueStoreGPU, one per tag), the resolver host's per-
generation ConflictSetGPUs, and the conflict set a txn host recruits in
its own process when the deployment has no resolver class. The log hosts
hold no device state. Each host on the card is a CUDA context of its own;
`run_role_host` builds the kernels and warms the card before the host
announces itself (`warm_device`). Every role host's MetricRegistry reads
the probe's launch count in its process as the gauge
`probe.launches_total`, and its CUDA context and the bytes its caching
allocator holds on the card as `device.contexts_count` and
`device.memory_reserved_bytes` (port additions, scraped over
WLTOKEN_METRICS: nvidia-smi inside a container may not map a card's
memory to the processes that hold it)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

from ..core.actors import (
    ActorCollection,
    PromiseStream,
    all_of,
    serve_requests,
    timeout,
)
from ..core.errors import OperationFailed, RequestMaybeDelivered
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import Promise, TaskPriority, current_loop, spawn
from ..core.serialize import register_message
from ..core.trace import TraceEvent
from ..kv.keys import KeyRange
from .interfaces import (
    GetRangeRequest,
    GetValueRequest,
    TLogCommitRequest,
    WatchValueRequest,
)
from .log_system import TaggedMutation

# -- well-known tokens (extending net/service.py's client-facing trio) --
WLTOKEN_LOCATION = 13
WLTOKEN_COMMIT_BATCH = 14    # columnar CommitBatchRequest (commit_wire.py)
WLTOKEN_TXN_STATUS = 15      # TxnStatusRequest: commit-plane status pull
WLTOKEN_CONTROLLER = 16      # worker registration + status/recruitment pulls
WLTOKEN_TRACE = 17           # TraceEventsRequest: flight-recorder queries
WLTOKEN_METRICS = 18         # MetricsRequest: per-process registry scrapes
WLTOKEN_LOG_BASE = 100       # +2*i commit, +2*i+1 control
WLTOKEN_STORAGE_BASE = 300   # +2*tag read, +2*tag+1 control
WLTOKEN_RESOLVER_BASE = 500  # host control; +1+idx per-resolver resolve


# -- wire messages for the role-to-role hops --
@dataclass
class TLogPeekRequest:
    """(ref: TLogPeekRequest, TLogInterface.h — per-tag cursor pull)."""

    tag: int
    from_version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogPopRequest:
    """(ref: TLogPopRequest — per-tag durability ack)."""

    tag: int
    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogLockRequest:
    """(ref: TLogLockResult gathering in epochEnd)."""

    epoch: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogTruncateRequest:
    """Quorum truncation at epoch end (ref: epochEnd's recovery version)."""

    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogSkipToRequest:
    """Recovery gap-skip (see MemoryTLog.skip_to)."""

    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class InitResolversRequest:
    """Recovery -> resolver host: recruit a fresh per-generation resolver
    fleet at the recovery version (ref: the master's InitializeResolver
    dispatch; resolver state is per-generation by design)."""

    generation: int
    start_version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class ResolverSkipWindowRequest:
    """Proxy failure-path compensation over the wire (ResolverRole.
    skip_window: advance the version chain past a failed batch). Carries
    the generation fence like the resolve stream."""

    idx: int
    prev_version: int
    version: int
    epoch: int = 0
    reply: Promise = field(default_factory=Promise)


@dataclass
class ResolverStatusRequest:
    """Balancer input: (keys_resolved, key sample) of one resolver (ref:
    ResolutionMetricsRequest / key-load samples, Resolver.actor.cpp:
    148-152)."""

    idx: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class ResolveBatchReply:
    """Wire form of a resolve verdict: per-txn statuses + the catch-up
    state payload (Resolver.actor.cpp:171-190) lifted into the reply."""

    statuses: tuple
    state_mutations: tuple = ()


@dataclass
class TLogHostDurableRequest:
    """Host-level durability floor: min entry-durable across the LOGS THIS
    HOST SERVES. Storage hosts combine the per-host floors into the system
    flush horizon (every per-host value is a true past value of a monotone
    quantity, so the min over hosts is always a safe lower bound)."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogConfirmEpochRequest:
    """GRV epoch-liveness probe (ref: confirmEpochLive,
    TagPartitionedLogSystem.actor.cpp:553). Replies with the log's locked
    epoch; the caller compares against its own generation."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class TLogStatusRequest:
    """(ref: TLogQueuingMetricsRequest — ratekeeper's log-side input)."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class StorageRollbackRequest:
    """Epoch-end rollback (ref: storageServerRollbackRebooter)."""

    version: int
    reply: Promise = field(default_factory=Promise)


@dataclass
class StorageStatusRequest:
    """(ref: StorageQueuingMetricsRequest — ratekeeper's storage input)."""

    reply: Promise = field(default_factory=Promise)


@dataclass
class TraceEventsRequest:
    """Flight-recorder query served by EVERY role host (WLTOKEN_TRACE):
    matching events from the process's in-memory trace window. `cli.py
    trace <debug-id>` fans one per process and stitches the replies into
    a cross-process timeline; `cli.py events` tails the fleet's recent
    events by type/severity. A debug-ID query matches events carrying
    the ID (DebugID) AND attach edges pointing at it (To), so the caller
    can follow a transaction into its commit batch's scope."""

    debug_id: Optional[str] = None
    event_type: Optional[str] = None
    min_severity: int = 0
    last: int = 0
    reply: Promise = field(default_factory=Promise)


@dataclass
class MetricsRequest:
    """Metrics scrape served by EVERY role host (WLTOKEN_METRICS): the
    process's MetricRegistry snapshot — name/labels/kind/value per
    registered instrument, optionally with the ring-buffer recent
    history (TDMetric-style fine+coarse series). `pattern` is an fnmatch
    glob over dotted names (empty = everything). `cli.py top` fans one
    per process and renders live rates from consecutive scrapes;
    `cli.py metrics <pattern>` is the one-shot query; `bench.py
    --commit-plane` records the series per ramp stage."""

    pattern: str = ""
    series: bool = False
    reply: Promise = field(default_factory=Promise)


@dataclass
class TxnStatusRequest:
    """Operator/bench pull of the txn host's commit-plane status: the
    proxy's `commit_pipeline` block (grv/form/resolve/tlog stage p50+p99,
    in-flight commit-version depth, GRV cache hit split) over the wire —
    how `bench.py --commit-plane` attributes its per-stage breakdown and
    an attached shell reads the deployed proxy."""

    reply: Promise = field(default_factory=Promise)


for _cls in (
    TLogPeekRequest, TLogPopRequest, TLogLockRequest, TLogTruncateRequest,
    TLogSkipToRequest, TLogStatusRequest, TLogConfirmEpochRequest,
    TLogHostDurableRequest, StorageRollbackRequest, StorageStatusRequest,
    TxnStatusRequest, TraceEventsRequest, MetricsRequest, TaggedMutation,
    InitResolversRequest, ResolverSkipWindowRequest, ResolverStatusRequest,
    ResolveBatchReply,
):
    register_message(_cls)


def start_trace_service(transport, tasks: ActorCollection) -> None:
    """Serve TraceEventsRequest from this process's global TraceSink —
    the per-process leg of the flight recorder's control-RPC query path
    (every role host calls this; the in-memory window is bounded by the
    sink's memory_limit, and `count()` stays exact past it)."""
    import json as _json

    stream: PromiseStream = PromiseStream()
    transport.register_endpoint(stream, WLTOKEN_TRACE)

    async def serve(req: TraceEventsRequest):
        from ..core.trace import global_sink

        sink = global_sink()

        def match(e: dict) -> bool:
            if req.debug_id is not None and (
                e.get("DebugID") != req.debug_id
                and e.get("To") != req.debug_id
            ):
                return False
            if req.event_type is not None and e.get("Type") != req.event_type:
                return False
            if req.min_severity and e.get("Severity", 0) < req.min_severity:
                return False
            return True

        out = [e for e in sink.events if match(e)]
        if req.last:
            out = out[-req.last:]
        out = out[-5000:]  # reply bound: a flood must not melt the RPC
        # Details may hold arbitrary objects; the JSON round trip pins
        # them to codec-safe primitives exactly as the trace file would.
        out = [_json.loads(_json.dumps(e, default=str)) for e in out]
        return {"process": sink.process_name, "events": out}

    tasks.add(serve_requests(stream, serve, TaskPriority.DEFAULT,
                             "traceQuery"))


def start_metrics_service(transport, tasks: ActorCollection) -> None:
    """Serve MetricsRequest from this process's MetricRegistry — the
    per-process leg of the scrape plane (every role host calls this; the
    HTTP text-exposition endpoint is the same registry re-rendered)."""
    import json as _json

    stream: PromiseStream = PromiseStream()
    transport.register_endpoint(stream, WLTOKEN_METRICS)

    async def serve(req: MetricsRequest):
        from ..core.metrics import global_registry
        from ..core.trace import global_sink

        snap = global_registry().snapshot(
            volatile=True, pattern=req.pattern or "",
            series=bool(req.series),
        )
        # Pin values to codec-safe primitives exactly like the trace
        # query path (gauges may return arbitrary objects).
        snap = _json.loads(_json.dumps(snap, default=str))
        return {"process": global_sink().process_name, "metrics": snap}

    tasks.add(serve_requests(stream, serve, TaskPriority.DEFAULT,
                             "metricsQuery"))


# Importing the module registers CommitBatchRequest with the wire codec —
# the txn host must be able to DECODE a client's columnar commit batch
# before any handler-local import runs.
from .commit_wire import CommitBatchRequest  # noqa: E402,F401


# -- cluster file: the deployment's single shared document --
def write_cluster_file(path: str, updates: dict) -> None:
    """Merge `updates` into the cluster file atomically. Concurrent hosts
    merge under an advisory lock (every role host writes its own address
    at boot), with a per-writer temp name so replaces never collide."""
    import fcntl

    lock_path = path + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cur = read_cluster_file(path) or {}
        cur.update(updates)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def read_cluster_file(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError:
            return None  # mid-replace read; caller retries


def _spec_kw(spec: dict) -> dict:
    from ..resolver.factory import validate_conflict_set_impl
    from .replication import policy_for_mode

    # Caught at spec parse: every host class eventually recruits a
    # conflict set via the factory, and an unknown impl used to surface
    # only as an opaque per-generation recruitment failure inside the
    # resolver host.
    validate_conflict_set_impl(
        spec.get("conflict_set_impl")
        if spec.get("conflict_set_impl") is not None else None
    )
    n_logs = spec.get("n_logs", 2)
    n_log_hosts = spec.get("n_log_hosts", 1)
    if n_log_hosts > n_logs:
        # Caught at parse: a host owning zero logs would compute its
        # durable floor as min() of nothing (crash) — or worse, report 0
        # forever and pin the whole system's durability horizon there.
        raise ValueError(
            f"n_log_hosts={n_log_hosts} exceeds n_logs={n_logs}: every "
            "log host must own at least one log (lower n_log_hosts or "
            "raise n_logs)"
        )
    log_replication = spec.get("log_replication", "single")
    factor = policy_for_mode(log_replication).num_replicas()
    if factor > n_logs:
        # Caught at parse rather than wedging recovery: push could never
        # assemble a k-replica set per tag, so no commit would ever ack
        # and every lock would keep computing an unsatisfiable quorum.
        raise ValueError(
            f"log_replication={log_replication!r} needs {factor} logs; "
            f"spec has n_logs={n_logs} (raise n_logs or lower the mode)"
        )
    if spec.get("regions"):
        topo = spec.get("topology") or {}
        if int(topo.get("n_dcs", 1)) < 2:
            raise ValueError(
                "two-region spec needs topology.n_dcs >= 2 (the remote "
                "log set lives in the second DC)"
            )
        if n_log_hosts < 2:
            # A remote log set with no host of its own would silently
            # co-locate both regions' logs in one failure domain — the
            # exact loss the region config exists to rule out.
            raise ValueError(
                "two-region spec lacks a second DC's log hosts: set "
                "n_log_hosts >= 2 so the remote set has its own failure "
                "domain"
            )
        raise ValueError(
            "two-region log shipping is a sim-tier feature today "
            "(cluster kind recoverable_sharded + topology); deploy the "
            "multiprocess tier single-region with k-way log_replication"
        )
    return dict(
        n_storage=spec.get("n_storage", 4),
        n_logs=n_logs,
        n_log_hosts=n_log_hosts,
        log_replication=log_replication,
        n_resolvers=spec.get("n_resolvers", 1),
        replication=spec.get("replication", "double"),
        shard_boundaries=[
            b.encode() if isinstance(b, str) else b
            for b in spec.get("shard_boundaries", [])
        ],
        seed=spec.get("seed", 1),
        # Machine/DC topology (sim/topology.py): shapes the derived
        # localities, so every host must parse it or team layouts diverge.
        topology=spec.get("topology"),
    )


def log_host_classes(n_log_hosts: int) -> list[str]:
    """Cluster-file keys / process-class names of the log hosts. A single
    host keeps the historical plain "log" name."""
    if n_log_hosts <= 1:
        return ["log"]
    return [f"log{j}" for j in range(n_log_hosts)]


def resolver_host_classes(n_resolver_hosts: int) -> list[str]:
    """Process-class names of the resolver hosts (same numbering scheme
    as the log failure domains). Recruitment picks ONE live host per
    generation via the worker registry — extra hosts are warm spares the
    controller fails over to when the serving host's lease lapses."""
    if n_resolver_hosts <= 1:
        return ["resolver"]
    return [f"resolver{j}" for j in range(n_resolver_hosts)]


def is_resolver_class(role_class: str) -> bool:
    return role_class == "resolver" or (
        role_class.startswith("resolver") and role_class[8:].isdigit()
    )


def txn_host_classes(n_txn_hosts: int) -> list[str]:
    """Process-class names of the CONTROLLER CANDIDATES (txn hosts).
    Every candidate runs coordination + the controller election over the
    spec's shared `coordination_dir`; the leaseholder recruits and serves
    the transaction system, the others stand by — losing the incumbent's
    machine moves the seat, and the worker registry is rebuilt from
    re-registrations against the new `controller` address."""
    if n_txn_hosts <= 1:
        return ["txn"]
    return [f"txn{j}" for j in range(n_txn_hosts)]


def is_txn_class(role_class: str) -> bool:
    return role_class == "txn" or (
        role_class.startswith("txn") and role_class[3:].isdigit()
    )


def machine_for_class(spec: dict, role_class: str) -> str:
    """The failure-domain id of a role class: the spec's `machines`
    stanza ({machine_id: [class, ...]}) when present, else the class is
    its own single-process machine (the historical layout)."""
    machines = spec.get("machines") or {}
    for mid in sorted(machines):
        if role_class in machines[mid]:
            return mid
    return role_class


def log_owner(log_id: int, n_log_hosts: int) -> int:
    """Which log host serves log `log_id` (round-robin across failure
    domains — the reference places tlog replicas across machines,
    TagPartitionedLogSystem.actor.cpp:339)."""
    return log_id % max(1, n_log_hosts)


# ---------------------------------------------------------------------------
# log host
# ---------------------------------------------------------------------------
class LogHost:
    """Serves the subset of the deployment's tlogs owned by one failure
    domain (host `host_index` of `n_log_hosts`; ref: the reference places
    tlog replicas across machines and computes durability across them,
    TagPartitionedLogSystem.actor.cpp:339). With one host the subset is
    the whole quorum (the historical v1 topology)."""

    @property
    def LONG_POLL_S(self) -> float:
        """Parked-peek bound so dead clients cannot leak handlers; a knob
        (randomized under sim) rather than a constant — VERDICT weak #7."""
        return SERVER_KNOBS.TLOG_PEEK_LONG_POLL_WINDOW

    def __init__(self, transport, datadir: str, n_logs: int,
                 host_index: int = 0, n_log_hosts: int = 1):
        from .durable_tlog import DurableTaggedTLog

        os.makedirs(datadir, exist_ok=True)
        self.owned = [
            i for i in range(n_logs)
            if log_owner(i, n_log_hosts) == host_index
        ]
        # Datadir names follow the GLOBAL log id: a host restarted with a
        # different index must not adopt another log's disk.
        self.logs = {
            i: DurableTaggedTLog(f"{datadir}/log{i}") for i in self.owned
        }
        self._tasks = ActorCollection()
        for i, log in self.logs.items():
            log.register_metrics(labels=(("log", str(i)),))
            commit_stream: PromiseStream = PromiseStream()
            ctrl_stream: PromiseStream = PromiseStream()
            transport.register_endpoint(commit_stream,
                                        WLTOKEN_LOG_BASE + 2 * i)
            transport.register_endpoint(ctrl_stream,
                                        WLTOKEN_LOG_BASE + 2 * i + 1)
            self._tasks.add(serve_requests(
                commit_stream,
                lambda req, log=log: self._commit(log, req),
                TaskPriority.TLOG_COMMIT, f"logCommit{i}",
            ))
            self._tasks.add(serve_requests(
                ctrl_stream,
                lambda req, log=log: self._control(log, req),
                TaskPriority.TLOG_COMMIT, f"logCtrl{i}",
            ))

    async def _commit(self, log, req: TLogCommitRequest):
        if getattr(req, "wire", None) is not None:
            from .commit_wire import unpack_tagged_mutations

            muts = unpack_tagged_mutations(req.wire)
        else:
            muts = list(req.mutations)
        await log.commit(req.prev_version, req.version, muts,
                         epoch=req.epoch,
                         debug_id=getattr(req, "debug_id", None))
        return None

    async def _control(self, log, req):
        if isinstance(req, TLogPeekRequest):
            if log.available_from > req.from_version:
                # This log cannot cover the cursor: the window below
                # available_from was wiped with a destroyed datadir (and
                # recovered past by the lock quorum) or already popped.
                # Reply NOW — parking would stall the replicated cursor's
                # failover to a covering peer (log_system.TagView's gap
                # contract over the wire).
                return ([], self.durable_all(), log.available_from)
            # LONG POLL (ref: tLogPeekMessages blocks until messages
            # arrive, TLogServer.actor.cpp:903): the reply parks until the
            # tag has durable data, bounded so a vanished peer cannot leak
            # a parked handler forever; an empty timeout reply tells the
            # client to re-arm immediately.
            t = spawn(log.peek_tag(req.tag, req.from_version),
                      TaskPriority.TLOG_COMMIT, name="peekLongPoll")
            entries = await timeout(t.done, self.LONG_POLL_S, _LOST)
            if entries is _LOST:
                t.cancel()
                entries = []
            if entries and SERVER_KNOBS.TLOG_PEEK_WIRE:
                # Columnar peek reply: ONE TaggedMutationBatch buffer
                # instead of per-object entries through the recursive
                # encoder (the peek-side twin of TLOG_WIRE_BATCH). An
                # empty reply stays a bare list — its falsiness is the
                # client's long-poll re-arm signal.
                from .commit_wire import TaggedMutationBatch

                entries = TaggedMutationBatch.from_entries(
                    entries
                ).to_bytes()
            return (entries, self.durable_all(), log.available_from)
        if isinstance(req, TLogPopRequest):
            log.pop_tag(req.tag, req.version)
            return None
        if isinstance(req, TLogLockRequest):
            d = log.lock(req.epoch)
            return (d, log.version.get())
        if isinstance(req, TLogTruncateRequest):
            log.truncate_above(req.version)
            return None
        if isinstance(req, TLogSkipToRequest):
            log.skip_to(req.version)
            return None
        if isinstance(req, TLogStatusRequest):
            # queue_bytes counts SPILLED backlog too (the un-popped queue
            # does not shrink just because it moved to disk, and
            # ratekeeper backpressure must keep seeing it).
            return (log.version.get(), log.durable.get(),
                    log.queue_bytes())
        if isinstance(req, TLogConfirmEpochRequest):
            return log.locked_epoch
        if isinstance(req, TLogHostDurableRequest):
            return self.durable_all()
        raise TypeError(f"unknown log request {type(req)}")

    def durable_all(self) -> int:
        # entry_durable of THIS HOST'S logs, not the raw durable cursor:
        # see TagPartitionedLogSystem.durable_version — the awaited RPC
        # gap between lock/truncate and the storage rollbacks makes the
        # distinction LOAD-BEARING here (a flush tick can fire inside it).
        # System-level durability = min over hosts, combined by the
        # storage hosts' DurabilityTracker.
        return min(log.quorum_durable() for log in self.logs.values())

    def stop(self) -> None:
        self._tasks.cancel_all()
        for log in self.logs.values():
            log.close()


# ---------------------------------------------------------------------------
# storage host
# ---------------------------------------------------------------------------
class LogAddressBook:
    """The storage host's CURRENT view of the log hosts' addresses.
    Log re-recruitment can re-point a class at a spare on a different
    address (the spare publishes its class key at boot; the controller
    re-publishes after recruiting it): consumers resolve every stream
    through the book, and a background refresher follows the shared
    cluster file — the same document the re-pointing was published to —
    so replicated tag cursors fail over onto the recruited host without
    a storage restart. Streams are cached per (address, token); the
    steady state is one dict lookup."""

    def __init__(self, transport, log_addrs: list[str],
                 cluster_file: Optional[str] = None):
        self.transport = transport
        self.addrs = list(log_addrs)
        self.cluster_file = cluster_file
        self._cache: dict = {}

    def stream(self, host: int, token: int):
        key = (self.addrs[host], token)
        s = self._cache.get(key)
        if s is None:
            s = self._cache[key] = self.transport.remote_stream(*key)
        return s

    def refresh(self) -> bool:
        if not self.cluster_file:
            return False
        info = read_cluster_file(self.cluster_file) or {}
        changed = False
        for j, cls in enumerate(log_host_classes(len(self.addrs))):
            addr = info.get(cls)
            if addr and addr != self.addrs[j]:
                TraceEvent("LogAddressRepointed").detail(
                    "Class", cls
                ).detail("From", self.addrs[j]).detail("To", addr).log()
                self.addrs[j] = addr
                changed = True
        return changed

    def start_refresher(self, tasks: ActorCollection) -> None:
        async def refresher():
            loop = current_loop()
            while True:
                await loop.delay(SERVER_KNOBS.WORKER_HEARTBEAT_INTERVAL)
                try:
                    self.refresh()
                except BaseException:  # noqa: BLE001 — mid-replace read
                    pass

        tasks.add(spawn(refresher(), TaskPriority.DEFAULT,
                        name="logAddrRefresh"))


class DurabilityTracker:
    """System flush horizon across N log hosts: latest known per-host
    entry-durable floor, combined with min. Every cached value is a true
    past value of a monotone per-host quantity, so the combined min is
    always a SAFE lower bound — staleness only delays flushes, never
    un-writes them. Peek replies feed the owning host's slot for free; a
    background poller covers hosts this storage holds no tags on."""

    def __init__(self, transport, log_addrs, book: Optional[LogAddressBook]
                 = None):
        if book is None:
            book = LogAddressBook(transport, log_addrs)
        self.book = book
        self.n_hosts = len(book.addrs)
        self._floor = [0] * self.n_hosts

    def feed(self, host: int, value: int) -> None:
        self._floor[host] = max(self._floor[host], value)

    def system_durable(self) -> int:
        return min(self._floor)

    def start_polling(self, tasks: ActorCollection) -> None:
        async def poll():
            loop = current_loop()
            while True:
                for j in range(self.n_hosts):
                    req = TLogHostDurableRequest()
                    # Host j's lowest-id owned log is log j (round-robin
                    # ownership), resolved through the address book so a
                    # recruited replacement host is followed live.
                    self.book.stream(
                        j, WLTOKEN_LOG_BASE + 2 * j + 1
                    ).send(req)
                    got = await timeout(
                        req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT,
                        _LOST,
                    )
                    if got is not _LOST:
                        self.feed(j, got)
                await loop.delay(SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL)

        tasks.add(spawn(poll(), TaskPriority.DEFAULT, name="durablePoll"))


class RemoteTagView:
    """The storage server's log handle over TCP: same duck type as
    TagView (peek/pop/quorum_durable). Peeks are LONG-POLL: the server
    parks the reply until the tag has data (bounded by its poll window),
    so the idle cost is one parked request per tag, not a retry timer.

    Under k-way log replication the view holds a control stream to EVERY
    replica log of its tag (the replica set is DERIVED — the same
    replica_set_for_tag both tiers route pushes by, so the cursor can
    never look for its slice on a log the proxy never fed) and FAILS OVER
    between them: a replica whose available_from is past the cursor (a
    destroyed datadir recovered past it by the lock quorum) replies
    immediately instead of parking, and the cursor moves on; when NO
    replica covers the cursor the window was lost beyond the replication
    budget (or popped) and the cursor jumps the gap via the least-gapped
    replica (log_system.TagView's contract, over the wire)."""

    def __init__(self, transport, log_addrs, tag: int,
                 n_logs: int, tracker: DurabilityTracker,
                 log_replication: str = "single", topology=None,
                 book: Optional[LogAddressBook] = None):
        from .log_system import log_replicas, replica_set_for_tag
        from .replication import policy_for_mode

        self.tag = tag
        if book is None:
            book = LogAddressBook(transport, log_addrs)
        self.book = book
        policy = policy_for_mode(log_replication)
        self._replica_ids = replica_set_for_tag(
            tag % n_logs, log_replicas(n_logs, topology), policy
        )
        self._hosts = [log_owner(i, len(book.addrs))
                       for i in self._replica_ids]
        self._pref = 0  # serving replica (index into the replica set)
        self._tracker = tracker

    def _ctrl(self, k: int):
        # Resolved through the address book per send: a recruited
        # replacement log host is followed the moment its class key
        # re-points, with no storage restart.
        return self.book.stream(
            self._hosts[k], WLTOKEN_LOG_BASE + 2 * self._replica_ids[k] + 1
        )

    @property
    def _ctrls(self) -> list:
        return [self._ctrl(k) for k in range(len(self._replica_ids))]

    async def peek(self, from_version: int):
        loop = current_loop()
        gaps: dict[int, int] = {}  # replica -> its available_from > cursor
        while True:
            k = self._pref
            req = TLogPeekRequest(self.tag, from_version)
            self._ctrl(k).send(req)
            try:
                entries, durable_all, available_from = await req.reply.future
            except BaseException:  # noqa: BLE001 — conn loss: the host may
                # be down; a covering replica on another host can serve.
                await loop.delay(0.2)
                self._pref = (self._pref + 1) % len(self._ctrls)
                continue
            self._tracker.feed(self._hosts[k], durable_all)
            if isinstance(entries, (bytes, bytearray)):
                # Columnar peek reply (TLOG_PEEK_WIRE on the serving log
                # host): decode the single buffer back into the exact
                # entry list the object path would have sent.
                from .commit_wire import TaggedMutationBatch

                entries = TaggedMutationBatch.from_bytes(
                    bytes(entries)
                ).to_entries()
            if entries:
                return entries
            if available_from > from_version:
                gaps[k] = available_from
                if len(gaps) == len(self._ctrls):
                    # No replica covers the cursor: jump the gap from the
                    # least-gapped copy (same shape as a purged-version
                    # skip; entries carry their versions, so the storage
                    # cursor follows).
                    best = min(gaps, key=lambda i: (gaps[i], i))
                    self._pref = best
                    from_version = gaps[best]
                    gaps = {}
                    continue
                self._pref = (self._pref + 1) % len(self._ctrls)
                continue
            # Empty reply == the server's long-poll window elapsed with no
            # data for this tag: re-arm immediately (no client timer).
            gaps.pop(k, None)

    def pop(self, upto_version: int) -> None:
        # Every replica holds this tag's slice: all must learn the pop or
        # the non-serving copies would retain their prefixes forever.
        for ctrl in self._ctrls:
            ctrl.send(TLogPopRequest(self.tag, upto_version))

    def quorum_durable(self) -> int:
        return self._tracker.system_durable()


class StorageHost:
    def __init__(self, transport, datadir: str, spec: dict, log_addrs,
                 cluster_file: Optional[str] = None, device=None):
        from .sharded_cluster import (
            _all_false_map,
            _make_engine,
            derive_layout,
        )
        from .storage import StorageServer

        if isinstance(log_addrs, str):
            log_addrs = [log_addrs]
        os.makedirs(datadir, exist_ok=True)
        kw = _spec_kw(spec)
        layout = derive_layout(kw["n_storage"], kw["replication"],
                               kw["shard_boundaries"], kw["seed"],
                               topology=kw["topology"])
        self.storages = []
        self._tasks = ActorCollection()
        # ONE address book shared by the tracker and every tag cursor:
        # log re-recruitment re-points a class key in the cluster file
        # and the refresher follows it live.
        self.log_book = LogAddressBook(transport, log_addrs,
                                       cluster_file=cluster_file)
        self.log_book.start_refresher(self._tasks)
        self.durability = DurabilityTracker(transport, log_addrs,
                                            book=self.log_book)
        self.durability.start_polling(self._tasks)
        for tag in range(kw["n_storage"]):
            view = RemoteTagView(transport, log_addrs, tag, kw["n_logs"],
                                 self.durability,
                                 log_replication=kw["log_replication"],
                                 topology=kw["topology"],
                                 book=self.log_book)
            eng = _make_engine(spec.get("engine", "memory"),
                               f"{datadir}/storage{tag}")
            s = StorageServer(view, 0, tag=tag, engine=eng, device=device)
            s.register_metrics(labels=(("tag", str(tag)),))
            s.owned = _all_false_map()
            s.assigned = _all_false_map()
            for lo, hi, team in layout:
                if tag in team:
                    s.set_owned(lo, hi, True)
                    s.set_assigned(lo, hi, True)
            transport.register_endpoint(s.read_stream,
                                        WLTOKEN_STORAGE_BASE + 2 * tag)
            ctrl: PromiseStream = PromiseStream()
            transport.register_endpoint(ctrl,
                                        WLTOKEN_STORAGE_BASE + 2 * tag + 1)
            self._tasks.add(serve_requests(
                ctrl, lambda req, s=s: self._control(s, req),
                TaskPriority.STORAGE, f"storageCtrl{tag}",
            ))
            s.start()
            self.storages.append(s)

    async def _control(self, s, req):
        if isinstance(req, StorageRollbackRequest):
            s.rollback_to(req.version)
            return None
        if isinstance(req, StorageStatusRequest):
            return (s.version.get(), s.engine_durable)
        raise TypeError(f"unknown storage request {type(req)}")

    def stop(self) -> None:
        from .sharded_cluster import close_durable_tier

        self._tasks.cancel_all()
        for s in self.storages:
            s.stop()
        close_durable_tier(self.storages, [])


# ---------------------------------------------------------------------------
# resolver host
# ---------------------------------------------------------------------------
class ResolverHost:
    """One process hosting the resolver fleet (process class `resolver`):
    per-generation ResolverRoles recruited by the recovery's
    InitResolversRequest, each serving its resolve stream over the real
    transport — the proxy's phase-2 fan-out and the master's balancing
    samples ride RPC, as in the reference's separate resolver processes
    (fdbserver/Resolver.actor.cpp)."""

    def __init__(self, transport, spec: dict, device=None):
        kw = _spec_kw(spec)
        self.device = device
        self.n_resolvers = kw["n_resolvers"]
        self.generation = 0
        self.roles: list = []
        self._tasks = ActorCollection()
        ctrl: PromiseStream = PromiseStream()
        transport.register_endpoint(ctrl, WLTOKEN_RESOLVER_BASE)
        self._tasks.add(serve_requests(
            ctrl, self._control, TaskPriority.RESOLVER, "resolverCtrl",
        ))
        for i in range(self.n_resolvers):
            s: PromiseStream = PromiseStream()
            transport.register_endpoint(s, WLTOKEN_RESOLVER_BASE + 1 + i)
            self._tasks.add(serve_requests(
                s, lambda req, i=i: self._resolve(i, req),
                TaskPriority.RESOLVER, f"resolve{i}",
            ))

    async def _control(self, req):
        if isinstance(req, InitResolversRequest):
            if req.generation < self.generation:
                raise OperationFailed(
                    f"init from old generation {req.generation} "
                    f"(serving {self.generation})"
                )
            from ..resolver.factory import make_conflict_set
            from .resolver_role import ResolverRole

            self.generation = req.generation
            self.roles = [
                ResolverRole(make_conflict_set(req.start_version,
                                               device=self.device),
                             init_version=req.start_version,
                             metrics_labels=(("resolver", str(i)),))
                for i in range(self.n_resolvers)
            ]
            TraceEvent("ResolverHostRecruited").detail(
                "Generation", req.generation
            ).detail("StartVersion", req.start_version).detail(
                "Count", self.n_resolvers
            ).log()
            return None
        if isinstance(req, ResolverStatusRequest):
            r = self.roles[req.idx]
            return (r.keys_resolved, tuple(r.key_sample()),
                    r.pipeline_status())
        if isinstance(req, ResolverSkipWindowRequest):
            self._fence(req.epoch)
            await self.roles[req.idx].skip_window(req.prev_version,
                                                  req.version)
            return None
        raise TypeError(f"unknown resolver request {type(req)}")

    def _fence(self, epoch: int) -> None:
        """The resolve endpoints are reused across generations (unlike a
        per-generation role object): a deposed proxy's in-flight batch
        must not merge into the successor's conflict state (the tlog
        carries the same fence on its commit stream)."""
        if epoch < self.generation:
            from ..core.errors import TLogStopped

            raise TLogStopped(
                f"resolver host serving generation {self.generation}; "
                f"request from {epoch} refused"
            )

    async def _resolve(self, i, req):
        if not self.roles:
            raise OperationFailed("resolver host not recruited yet")
        self._fence(getattr(req, "epoch", 0))
        res = await self.roles[i].resolve_batch(req)
        return ResolveBatchReply(
            tuple(res.statuses),
            tuple(getattr(res, "state_mutations", ())),
        )

    def stop(self) -> None:
        self._tasks.cancel_all()


class RemoteResolver:
    """Txn-host-side handle to one remote resolver: the same duck type the
    proxy's multi-resolver phase 2 and the ResolutionBalancer consume
    (resolve_batch / skip_window / keys_resolved / key_sample), with the
    hops as awaited RPCs and the balancer inputs cached from periodic
    status pulls."""

    def __init__(self, transport, addr: str, idx: int, generation: int = 0):
        self.idx = idx
        self.generation = generation
        self._resolve_s = transport.remote_stream(
            addr, WLTOKEN_RESOLVER_BASE + 1 + idx
        )
        self._ctrl = transport.remote_stream(addr, WLTOKEN_RESOLVER_BASE)
        self.keys_resolved = 0
        self._sample: tuple = ()
        self.pipeline = None

    async def _rpc(self, stream, req):
        stream.send(req)
        got = await timeout(
            req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST
        )
        if got is _LOST:
            raise RequestMaybeDelivered(
                f"{type(req).__name__} reply not received"
            )
        return got

    async def resolve_batch(self, br):
        from ..resolver.types import ConflictBatchResult

        if getattr(br, "wire", None) is not None and br.transactions:
            # The wire bytes ARE the batch; shipping the object list too
            # would double the RPC payload (the proxy keeps its own txn
            # list — this request's copy is redundant on the wire).
            br.transactions = []
        reply = await self._rpc(self._resolve_s, br)
        out = ConflictBatchResult(list(reply.statuses))
        out.state_mutations = reply.state_mutations
        return out

    async def skip_window(self, prev_version: int, version: int) -> None:
        await self._rpc(
            self._ctrl,
            ResolverSkipWindowRequest(self.idx, prev_version, version,
                                      epoch=self.generation),
        )

    async def refresh_status(self) -> None:
        kr, sample, *rest = await self._rpc(
            self._ctrl, ResolverStatusRequest(self.idx)
        )
        self.keys_resolved = kr
        self._sample = sample
        # Pipeline breakdown of the REMOTE role (pack/h2d/device/d2h +
        # in-flight depth), for the txn host's status json.
        self.pipeline = rest[0] if rest else None

    def key_sample(self) -> list:
        return list(self._sample)


# ---------------------------------------------------------------------------
# txn host
# ---------------------------------------------------------------------------
class RemoteLogSystem:
    """The proxy/recovery-side view of the log quorum over TCP: push fans
    one TLogCommitRequest per log (every log gets every version), lock /
    truncate / skip are awaited control RPCs (ref: push :339 + epochEnd
    :107 of TagPartitionedLogSystem, with the RPC hop made explicit).

    Routing rides the SAME replica_set_for_tag/route_batches the
    in-process tier pushes by (derived from the shared deployment spec),
    so a tag's mutations land on the same k policy-distinct logs no
    matter which tier computed the fan-out, and the epoch-end recovery
    version is the same k-1-excludable quorum order statistic."""

    def __init__(self, transport, log_addrs, n_logs: int,
                 log_replication: str = "single", topology=None):
        from .log_system import log_replicas
        from .replication import policy_for_mode

        if isinstance(log_addrs, str):  # single-host convenience
            log_addrs = [log_addrs]
        assert len(log_addrs) <= n_logs, "more log hosts than logs"
        self.n_logs = n_logs
        self.log_replication = log_replication
        self.policy = policy_for_mode(log_replication)
        self.rep_factor = self.policy.num_replicas()
        self.replicas = log_replicas(n_logs, topology)
        self._tag_sets: dict[int, tuple[int, ...]] = {}
        addr_of = lambda i: log_addrs[log_owner(i, len(log_addrs))]
        self._commit = [
            transport.remote_stream(addr_of(i), WLTOKEN_LOG_BASE + 2 * i)
            for i in range(n_logs)
        ]
        self._ctrl = [
            transport.remote_stream(addr_of(i), WLTOKEN_LOG_BASE + 2 * i + 1)
            for i in range(n_logs)
        ]
        self._durable_cache = 0
        self._queue_bytes_cache = 0

    def replica_set_for_tag(self, tag: int) -> tuple[int, ...]:
        from .log_system import replica_set_for_tag

        key = tag % len(self.replicas)
        cached = self._tag_sets.get(key)
        if cached is None:
            cached = replica_set_for_tag(key, self.replicas, self.policy)
            self._tag_sets[key] = cached
        return cached

    async def push(self, prev_version: int, version: int,
                   tagged_mutations, epoch: int = 0, debug_id=None) -> None:
        from .commit_wire import pack_tagged_mutations
        from .log_system import route_batches

        per_log = route_batches(tagged_mutations, self.n_logs,
                                self.replica_set_for_tag)
        wire_on = bool(SERVER_KNOBS.TLOG_WIRE_BATCH)
        reqs = []
        for stream, batch in zip(self._commit, per_log):
            if wire_on:
                # Columnar push: one packed buffer per log instead of N
                # TaggedMutation objects through the recursive encoder.
                req = TLogCommitRequest(
                    prev_version, version, (), epoch=epoch,
                    wire=pack_tagged_mutations(tuple(batch)),
                    debug_id=debug_id,
                )
            else:
                req = TLogCommitRequest(prev_version, version,
                                        tuple(batch), epoch=epoch,
                                        debug_id=debug_id)
            stream.send(req)
            reqs.append(req)
        got = await timeout(
            all_of([r.reply.future for r in reqs]),
            SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST,
        )
        if got is _LOST:
            raise RequestMaybeDelivered("tlog push reply not received")

    async def _control_all(self, make_req):
        reqs = []
        for stream in self._ctrl:
            req = make_req()
            stream.send(req)
            reqs.append(req)
        got = await timeout(
            all_of([r.reply.future for r in reqs]),
            SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST,
        )
        if got is _LOST:
            raise OperationFailed("log host control RPC timed out")
        return [r.reply.future.get() for r in reqs]

    async def lock(self, epoch: int) -> tuple[int, int]:
        """Returns (recovery_version, max received version) after fencing
        and QUORUM-TRUNCATING every log. Under k-way replication the k-1
        worst durable cursors are excludable (a destroyed log datadir
        recovers at 0 and loses nothing acked — every acked commit waited
        the FULL fsync quorum, so it is durable on every log that kept
        its state; see TagPartitionedLogSystem.lock)."""
        results = await self._control_all(lambda: TLogLockRequest(epoch))
        budget = min(self.rep_factor - 1, self.n_logs - 1)
        recovery_version = sorted(d for d, _v in results)[budget]
        received = max(v for _d, v in results)
        await self._control_all(
            lambda: TLogTruncateRequest(recovery_version)
        )
        return recovery_version, received

    async def skip_to(self, version: int) -> None:
        await self._control_all(lambda: TLogSkipToRequest(version))

    async def confirm_epoch_live(self, epoch: int) -> None:
        """(ref: confirmEpochLive :553.) Under k-way replication a
        successor recovers from any n-(k-1) logs, so liveness needs
        confirmation from at least n-(k-1) UNLOCKED logs — any set that
        large intersects every possible successor quorum. A log fenced by
        a newer generation fails the probe outright; fewer than n-(k-1)
        answers (unreachable hosts) means a successor's quorum cannot be
        ruled out and the GRV must stall rather than risk a stale read."""
        from ..core.errors import TLogStopped

        reqs = []
        for stream in self._ctrl:
            req = TLogConfirmEpochRequest()
            stream.send(req)
            reqs.append(req)
        await timeout(
            all_of([r.reply.future for r in reqs]),
            SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST,
        )
        confirms = 0
        for r in reqs:
            if not r.reply.future.is_ready():
                continue  # dark host: proves nothing either way
            locked = r.reply.future.get()
            if locked > epoch:
                raise TLogStopped(
                    f"epoch {epoch} fenced by generation {locked}"
                )
            confirms += 1
        need = self.n_logs - (self.rep_factor - 1)
        if confirms < need:
            raise OperationFailed(
                f"confirmEpochLive: only {confirms}/{self.n_logs} logs "
                f"answered (need {need}); a successor's quorum cannot be "
                "ruled out"
            )

    async def refresh_status(self) -> None:
        results = await self._control_all(lambda: TLogStatusRequest())
        self._durable_cache = min(d for _v, d, _q in results)
        self._queue_bytes_cache = sum(q for _v, _d, q in results)

    # Ratekeeper-facing (sync, cached by refresh_status's poller).
    def durable_version(self) -> int:
        return self._durable_cache

    def queue_bytes(self) -> int:
        return self._queue_bytes_cache


_LOST = object()


class _RemoteStorageStatus:
    """Ratekeeper's view of one remote storage server (poller-refreshed)."""

    class _V:
        def __init__(self):
            self.v = 0

        def get(self):
            return self.v

    def __init__(self, tag: int, ctrl):
        self.tag = tag
        self.ctrl = ctrl
        self.version = self._V()

    async def refresh(self):
        req = StorageStatusRequest()
        self.ctrl.send(req)
        got = await timeout(req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT,
                            None)
        if got is not None:
            self.version.v = max(self.version.v, got[0])


class TxnHost:
    """Coordinators + controller + the per-generation transaction system,
    one process (ref: the cluster-controller/master machine class)."""

    def __init__(self, transport, datadir: Optional[str], spec: dict,
                 log_addrs, storage_addr: str, resolver_addr=None,
                 want_resolvers: Optional[bool] = None,
                 cluster_file: Optional[str] = None, device=None):
        from .coordination import (
            CoordinatedState,
            CoordinatorRegister,
            FileCoordinatorRegister,
            LeaderElection,
        )
        from .recovery import EndpointRef
        from .recruitment import WorkerRegistry
        from .sharded_cluster import derive_layout
        from .shards import ShardMap

        self.transport = transport
        self.cluster_file = cluster_file
        # Where a conflict set recruited in this process runs (no
        # resolver class in the deployment).
        self.device = device
        kw = _spec_kw(spec)
        self._kw = kw
        self.n_logs = kw["n_logs"]
        self.n_storage = kw["n_storage"]
        self.n_resolvers = kw["n_resolvers"]
        self.resolver_addr = resolver_addr
        self.resolver_boundaries = [
            b.encode() if isinstance(b, str) else b
            for b in spec.get("resolver_boundaries", [])
        ]
        # Default partition: evenly split the byte space for any split
        # points the spec does not name.
        while len(self.resolver_boundaries) < self.n_resolvers - 1:
            i = len(self.resolver_boundaries)
            self.resolver_boundaries.append(
                bytes([(256 * (i + 1)) // self.n_resolvers])
            )
        self.balancer = None
        # The controller's worker registry: resolver hosts (and every
        # other role host) register over WLTOKEN_CONTROLLER; recovery
        # recruits the best-fitness live worker instead of a spec-frozen
        # address. A legacy explicit resolver_addr seeds one
        # registration (it must keep heartbeating to stay a candidate).
        self.registry = WorkerRegistry()
        self.want_resolvers = bool(want_resolvers) or resolver_addr is not None
        self.recovery_state = "booting"
        self.recruited: dict[str, str] = {}   # role -> serving worker_id
        if resolver_addr is not None:
            # Pinned: a directly-constructed TxnHost has no registration
            # loop refreshing this entry — the explicit address is the
            # caller taking liveness into its own hands.
            self.registry.register(
                f"resolver@{resolver_addr}", process_class="resolver",
                address=resolver_addr, pinned=True,
            )
        self.log_addrs = ([log_addrs] if isinstance(log_addrs, str)
                          else list(log_addrs))
        self.storage_addr = storage_addr
        self.log_system = RemoteLogSystem(
            transport, list(self.log_addrs), self.n_logs,
            log_replication=kw["log_replication"], topology=kw["topology"],
        )
        # The txn host's view of the log quorum on the metrics plane
        # (poller-refreshed caches — the same numbers ratekeeper reads).
        from ..core.metrics import global_registry as _greg

        _reg = _greg()
        _reg.register_gauge("log_system.queue_bytes",
                            self.log_system.queue_bytes, replace=True)
        _reg.register_gauge("log_system.durable_version",
                            self.log_system.durable_version, replace=True)
        self._bind_storage_streams()
        self.shard_map = ShardMap(default_team=())
        for lo, hi, team in derive_layout(
            self.n_storage, kw["replication"], kw["shard_boundaries"],
            kw["seed"], topology=kw["topology"],
        ):
            self.shard_map.set_team(KeyRange(lo, hi), team)
        coordination_dir = spec.get("coordination_dir")
        if coordination_dir:
            # Multi-candidate controller failover: every txn host shares
            # ONE coordination quorum through flock-serialized on-disk
            # registers, so the leader seat (and the generation fence)
            # survives the incumbent machine's death.
            from .coordination import SharedFileCoordinatorRegister

            os.makedirs(coordination_dir, exist_ok=True)
            self.coordinators = [
                SharedFileCoordinatorRegister(
                    f"coord{i}",
                    os.path.join(coordination_dir, f"coord{i}.json"),
                )
                for i in range(3)
            ]
        elif datadir is not None:
            os.makedirs(datadir, exist_ok=True)
            self.coordinators = [
                FileCoordinatorRegister(f"coord{i}",
                                        f"{datadir}/coord{i}.json")
                for i in range(3)
            ]
        else:
            self.coordinators = [
                CoordinatorRegister(f"coord{i}") for i in range(3)
            ]
        self.cstate = CoordinatedState(self.coordinators, key="generation")
        self.election = LeaderElection(
            CoordinatedState(self.coordinators, key="leader"),
        )
        self.generation = 0
        self.recoveries_done = 0
        self.config_values: dict[str, str] = {}
        self.excluded: set[int] = set()
        self.metadata_version = 0
        # Client-facing endpoints: stable tokens, repointed per generation.
        self.grv_ref = EndpointRef()
        self.commit_ref = EndpointRef()
        self.location_ref = EndpointRef()
        from ..net.service import WLTOKEN_COMMIT, WLTOKEN_GRV, WLTOKEN_READ

        transport.register_endpoint(self.grv_ref, WLTOKEN_GRV)
        transport.register_endpoint(self.commit_ref, WLTOKEN_COMMIT)
        transport.register_endpoint(self.location_ref, WLTOKEN_LOCATION)
        # Single-address wire clients (the C client) read THROUGH this
        # host: a forwarder routes by key to the owning storage.
        self._read_fwd: PromiseStream = PromiseStream()
        transport.register_endpoint(self._read_fwd, WLTOKEN_READ)
        # Columnar commit batches (commit_wire.CommitBatchRequest): one
        # buffer of N client commits unpacked here and fed to the current
        # generation's commit stream — the client->txn-host twin of the
        # proxy->resolver wire path. Permanent endpoints (like the read
        # forwarder): they outlive generations, routing through the refs.
        self._commit_batch_s: PromiseStream = PromiseStream()
        transport.register_endpoint(self._commit_batch_s,
                                    WLTOKEN_COMMIT_BATCH)
        self._status_s: PromiseStream = PromiseStream()
        transport.register_endpoint(self._status_s, WLTOKEN_TXN_STATUS)
        self.master = None
        self.resolver = None
        self.proxy = None
        self.ratekeeper = None
        self._gen_tasks = ActorCollection()
        self._controllers = ActorCollection()
        self._tasks = ActorCollection()
        self._tasks.add(serve_requests(
            self._read_fwd, self._forward_read, TaskPriority.STORAGE,
            "readForwarder",
        ))
        self._tasks.add(serve_requests(
            self._commit_batch_s, self._serve_commit_batch,
            TaskPriority.PROXY_COMMIT, "commitBatchForwarder",
        ))
        self._tasks.add(serve_requests(
            self._status_s, self._serve_txn_status,
            TaskPriority.DEFAULT, "txnStatus",
        ))
        # Controller endpoint: worker registration/heartbeats + the
        # operator shell's status/recruitment pulls (cli --cluster-file).
        self._controller_s: PromiseStream = PromiseStream()
        transport.register_endpoint(self._controller_s, WLTOKEN_CONTROLLER)
        self._tasks.add(serve_requests(
            self._controller_s, self._serve_controller,
            TaskPriority.COORDINATION, "controllerRegistry",
        ))
        self.registry.start()
        # The controller's own process is a worker too (class txn hosts
        # the transaction bundle); pinned — its lease is its life.
        self.registry.register(
            f"txn@{transport.local_address}", process_class="txn",
            address=transport.local_address, pinned=True,
        )

    # -- batched commits (columnar client->proxy hop) --
    async def _serve_commit_batch(self, req):
        """Unpack one CommitWireBatch into individual commit requests on
        the current generation's stream and gather per-txn outcomes via
        reply callbacks under ONE deadline (a timer per transaction would
        be pure per-commit overhead; the proxy's reply chain hands the
        outcomes back in commit-version order anyway). Replies the
        pipeline never produces (mid-recovery drop) become
        maybe-committed — the error the direct path's client timeout maps
        to. The outcome vector ships packed (pack_outcomes), one bytes
        value on the wire."""
        from ..core.errors import (
            CommitUnknownResult,
            NotCommitted,
            TransactionTooOld,
        )
        from ..core.knobs import CLIENT_KNOBS
        from .commit_wire import (
            OUTCOME_COMMITTED,
            OUTCOME_CONFLICT,
            OUTCOME_FAILED,
            OUTCOME_MAYBE_COMMITTED,
            OUTCOME_TOO_OLD,
            CommitWireBatch,
            pack_outcomes,
        )

        subs = CommitWireBatch.from_bytes(req.payload).to_reqs()
        outs: list = [None] * len(subs)
        done = Promise()
        remaining = len(subs)

        def on_reply(i):
            def cb(f):
                nonlocal remaining
                err = f.error()
                if err is None:
                    cid = f.get()
                    outs[i] = (OUTCOME_COMMITTED, cid.version,
                               cid.versionstamp, "")
                elif isinstance(err, NotCommitted):
                    outs[i] = (OUTCOME_CONFLICT, 0, b"", str(err))
                elif isinstance(err, TransactionTooOld):
                    outs[i] = (OUTCOME_TOO_OLD, 0, b"", str(err))
                elif isinstance(err, CommitUnknownResult):
                    outs[i] = (OUTCOME_MAYBE_COMMITTED, 0, b"", str(err))
                else:
                    outs[i] = (OUTCOME_FAILED, 0, b"", str(err))
                remaining -= 1
                if remaining == 0 and not done.future.is_set():
                    done.send(None)
            return cb

        for i, r in enumerate(subs):
            r.reply.future.add_callback(on_reply(i))
        for r in subs:
            self.commit_ref.send(r)
        if remaining:
            await timeout(done.future, CLIENT_KNOBS.COMMIT_TIMEOUT, _LOST)
        for i in range(len(outs)):
            if outs[i] is None:
                outs[i] = (OUTCOME_MAYBE_COMMITTED, 0, b"",
                           "commit reply not received")
        return pack_outcomes(outs)

    async def _serve_txn_status(self, req):
        p = self.proxy
        return {
            "generation": self.generation,
            "recoveries_done": self.recoveries_done,
            "proxy": None if p is None else {
                "txns_committed": p.txns_committed,
                "txns_conflicted": p.txns_conflicted,
                "txns_too_old": p.txns_too_old,
                "grvs_throttled": p._c_grv_throttled.total,
                "commit_pipeline": p.commit_pipeline_status(),
            },
        }

    # -- controller registry endpoint (worker registration + operator pulls) --
    async def _serve_controller(self, req):
        from .interfaces import (
            ClusterStatusRequest,
            RecruitmentStatusRequest,
            RegisterWorkerRequest,
        )

        if isinstance(req, RegisterWorkerRequest):
            return self.registry.register(
                req.worker_id, process_class=req.process_class,
                address=req.address, machine_id=req.machine_id,
            )
        if isinstance(req, RecruitmentStatusRequest):
            return self._recruitment_status()
        if isinstance(req, ClusterStatusRequest):
            from .status import multiprocess_status

            return multiprocess_status(self)
        raise TypeError(f"unknown controller request {type(req)}")

    def _recruitment_status(self) -> dict:
        st = self.registry.status()
        st["recruited"] = dict(sorted(self.recruited.items()))
        st["recovery_state"] = self.recovery_state
        return st

    def _bind_storage_streams(self) -> None:
        self.storage_ctrl = {
            tag: self.transport.remote_stream(
                self.storage_addr, WLTOKEN_STORAGE_BASE + 2 * tag + 1
            )
            for tag in range(self.n_storage)
        }
        self.storage_reads = {
            tag: self.transport.remote_stream(
                self.storage_addr, WLTOKEN_STORAGE_BASE + 2 * tag
            )
            for tag in range(self.n_storage)
        }

    # -- durable-role re-recruitment (log + storage hosts) --
    def _lowest_owned_log(self, host_idx: int) -> int:
        return min(i for i in range(self.n_logs)
                   if log_owner(i, len(self.log_addrs)) == host_idx)

    async def _probe_log_host(self, addr: str, host_idx: int) -> bool:
        """One durability-floor RPC against a log host: answers iff the
        host is live and serving its logs (the recruitment confirm)."""
        req = TLogHostDurableRequest()
        self.transport.remote_stream(
            addr, WLTOKEN_LOG_BASE + 2 * self._lowest_owned_log(host_idx) + 1
        ).send(req)
        got = await timeout(req.reply.future,
                            SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST)
        return got is not _LOST

    async def _recruit_log_hosts(self, detail: str) -> bool:
        """Convert an unreachable-log-quorum lock failure into
        RE-RECRUITMENT: probe every log host, and for each dead one rank
        the live registered spares of the SAME class (the spare serves
        the same global log ids from its own — empty — datadir; the
        epoch-end quorum excludes its zeroed cursors within the
        replication budget and the replicated tag cursors fail over to
        the surviving copies, PR 6's machinery, so the tail re-replicates
        forward). Returns True when any host was re-pointed (the caller
        retries the lock); raises RecruitmentStalled when a dead host has
        no live spare — the recovery parks in recruiting_log and the
        status json names the awaited class."""
        from .recruitment import Fitness, RecruitmentStalled, select_workers

        classes = log_host_classes(len(self.log_addrs))
        dead = [j for j in range(len(self.log_addrs))
                if not await self._probe_log_host(self.log_addrs[j], j)]
        if not dead:
            return False
        replaced = False
        for j in dead:
            cls = classes[j]
            cands = [w for w in self.registry.live_workers()
                     if w.process_class == cls and w.address]
            got = select_workers(cands, "log", 1, max_fitness=Fitness.BEST)
            if not got:
                self.recovery_state = "recruiting_log"
                self.registry.note_stall(
                    "log", awaiting=cls, candidates=0,
                    detail=f"log host {cls}@{self.log_addrs[j]} "
                           f"unreachable; no live spare ({detail})",
                )
                raise RecruitmentStalled(
                    "log", f"log host {cls} dead; no spare registered"
                )
            w = got[0]
            if not await self._probe_log_host(w.address, j):
                # Lease said live but the spare is gone (mid-SIGKILL):
                # forget it so the next attempt ranks the survivors —
                # it must NOT be re-selected before re-registering.
                self.registry.forget(w.worker_id)
                raise OperationFailed(
                    f"log spare {w.worker_id} did not confirm recruitment"
                )
            self.log_addrs[j] = w.address
            self.recruited[cls] = w.worker_id
            replaced = True
            TraceEvent("LogHostRecruited").detail("Class", cls).detail(
                "Worker", w.worker_id
            ).detail("Address", w.address).log()
        if replaced:
            self.log_system = RemoteLogSystem(
                self.transport, list(self.log_addrs), self.n_logs,
                log_replication=self._kw["log_replication"],
                topology=self._kw["topology"],
            )
            if self.cluster_file:
                # Publish the re-pointed addresses so storage hosts'
                # cursors re-resolve off the shared document too.
                write_cluster_file(self.cluster_file, {
                    classes[j]: self.log_addrs[j] for j in dead
                })
            self.registry.note_resumed("log")
        return replaced

    async def _rollback_one(self, tag: int, recovery_version: int) -> bool:
        """Rollback confirm with knob-configured backoff between the
        attempts (STORAGE_ROLLBACK_RETRY_DELAY, sim-randomized): three
        back-to-back sends used to hot-loop against a dead host."""
        loop = current_loop()
        for attempt in range(3):
            if attempt:
                await loop.delay(
                    SERVER_KNOBS.STORAGE_ROLLBACK_RETRY_DELAY
                    * (0.5 + loop.random.random01())
                )
            req = StorageRollbackRequest(recovery_version)
            self.storage_ctrl[tag].send(req)
            got = await timeout(
                req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST
            )
            if got is not _LOST:
                return True
        return False

    async def _recruit_storage_host(self, tag: int) -> None:
        """Re-point the storage fleet's endpoints at a live registered
        spare of class `storage` (the unreachable-rollback park converted
        into recruitment). The spare starts from its own datadir and
        re-pulls the logs' retained windows; raises RecruitmentStalled
        when no spare exists — the recovery parks in recruiting_storage
        with the awaited class and candidate count in status json."""
        from .recruitment import Fitness, RecruitmentStalled, select_workers

        cands = [w for w in self.registry.live_workers()
                 if w.process_class == "storage" and w.address]
        got = select_workers(cands, "storage", 1, max_fitness=Fitness.BEST)
        if not got:
            self.recovery_state = "recruiting_storage"
            self.registry.note_stall(
                "storage", awaiting="storage", candidates=0,
                detail=f"storage {tag} unreachable; no live spare",
            )
            raise RecruitmentStalled(
                "storage", f"storage {tag} unreachable; no spare registered"
            )
        w = got[0]
        probe = StorageStatusRequest()
        self.transport.remote_stream(
            w.address, WLTOKEN_STORAGE_BASE + 2 * tag + 1
        ).send(probe)
        confirmed = await timeout(probe.reply.future,
                                  SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST)
        if confirmed is _LOST:
            self.registry.forget(w.worker_id)
            raise OperationFailed(
                f"storage spare {w.worker_id} did not confirm recruitment"
            )
        if w.address != self.storage_addr:
            self.storage_addr = w.address
            self._bind_storage_streams()
            if self.cluster_file:
                write_cluster_file(self.cluster_file,
                                   {"storage": w.address})
        self.recruited["storage"] = w.worker_id
        self.registry.note_resumed("storage")
        TraceEvent("StorageHostRecruited").detail(
            "Worker", w.worker_id
        ).detail("Address", w.address).log()

    # -- read forwarding (by-key routing like the client's location cache) --
    async def _forward_read(self, req):
        if isinstance(req, GetValueRequest):
            return await self._fwd_to_team(
                self.shard_map.team_for_key(req.key),
                GetValueRequest(req.key, req.version),
            )
        if isinstance(req, WatchValueRequest):
            return await self._fwd_to_team(
                self.shard_map.team_for_key(req.key),
                WatchValueRequest(req.key, req.value, req.version),
            )
        if isinstance(req, GetRangeRequest):
            # Split per shard (a storage refuses ranges crossing out of
            # its ownership) and stitch, honoring limit/reverse — the
            # forwarder-side analogue of the client's location-cache scan.
            slices = self.shard_map.intersecting(
                KeyRange(req.begin, req.end)
            )
            if req.reverse:
                slices = list(reversed(slices))
            out = []
            for lo, hi, team in slices:
                b = max(lo, req.begin)
                e = req.end if hi is None else min(hi, req.end)
                if b >= e:
                    continue
                left = req.limit - len(out) if req.limit else 0
                rows = await self._fwd_to_team(
                    team,
                    GetRangeRequest(b, e, req.version, left, req.reverse),
                )
                out.extend(rows)
                if req.limit and len(out) >= req.limit:
                    break
            return out
        raise TypeError(f"unknown read request {type(req)}")

    async def _fwd_to_team(self, team, fwd):
        if not team:
            raise OperationFailed("no team for key")
        self.storage_reads[team[0]].send(fwd)
        return await fwd.reply.future

    def _apply_metadata(self, m, version: int = 0) -> None:
        from .sharded_cluster import ShardedKVCluster

        ShardedKVCluster._apply_metadata(self, m, version)

    # -- recovery (masterCore over RPC) --
    async def recover(self) -> None:
        from .master import Master
        from .proxy import CommitProxy
        from .ratekeeper import Ratekeeper
        from .recovery import (
            _bump_generation,
            _seal_generation,
            _send_recovery_txn,
        )
        from .resolver_role import ResolverRole
        from ..resolver.factory import make_conflict_set

        from .recruitment import RecruitmentStalled

        self.recovery_state = "locking_logs"
        generation = _bump_generation(self.cstate)
        for lock_attempt in range(4):
            try:
                recovery_version, received = await self.log_system.lock(
                    generation
                )
                break
            except OperationFailed as e:
                # A log host beyond the replication budget is
                # unreachable. RE-RECRUIT: a live registered spare of the
                # dead class takes over its logs (fresh datadir; the
                # epoch-end truncate + replicated-cursor failover
                # re-replicates the surviving tail onto it) and the lock
                # retries. Only when no spare exists — or the failure is
                # not a dead host at all — does the recovery park as a
                # NAMED stall (status json shows recruiting_log), resumed
                # the instant a log worker (re)registers; never a hot
                # crash loop against a dead quorum.
                if lock_attempt == 3 \
                        or not await self._recruit_log_hosts(str(e)):
                    self.recovery_state = "recruiting_log"
                    self.registry.note_stall("log", detail=str(e))
                    raise RecruitmentStalled("log", str(e)) from e
        self.registry.note_resumed("log")
        # Every storage must CONFIRM its rollback before the new
        # generation starts: an un-rolled-back replica above the quorum
        # truncation would diverge from its team. An unreachable storage
        # host is first RE-RECRUITED from the registry's spares; only
        # when none exists does this recovery park as a named stall the
        # controller resumes when a storage worker registers.
        for tag in sorted(self.storage_ctrl):
            if await self._rollback_one(tag, recovery_version):
                continue
            await self._recruit_storage_host(tag)
            if not await self._rollback_one(tag, recovery_version):
                self.recovery_state = "recruiting_storage"
                self.registry.note_stall(
                    "storage", awaiting="storage", candidates=None,
                    detail=f"storage {tag} unreachable",
                )
                raise RecruitmentStalled(
                    "storage",
                    f"storage {tag} did not confirm rollback to "
                    f"{recovery_version}",
                )
        self.registry.note_resumed("storage")
        start_version = max(recovery_version, received)
        await self.log_system.skip_to(start_version)

        self._gen_tasks.cancel_all()
        if self.proxy is not None:
            self.proxy.stop()
        if self.ratekeeper is not None:
            self.ratekeeper.stop()
        self.generation = generation
        self.master = Master(init_version=start_version)
        resolvers = resolver_config = None
        if self.want_resolvers:
            # RECRUIT the resolver host: rank the live registered
            # workers by fitness (recruitment.select_workers) instead of
            # a spec-frozen address; no live candidate parks this
            # recovery in recruiting_resolver until one registers (ref:
            # the master's InitializeResolver dispatch onto controller-
            # chosen workers).
            from .recruitment import Fitness
            from .resolution import ResolutionBalancer, ResolverConfig

            self.recovery_state = "recruiting_resolver"
            # BEST fitness only: a role host serves only its own class's
            # endpoints, so only resolver-class workers can host the
            # fleet (the ladder still orders multiple resolver hosts).
            worker = self.registry.recruit(
                "resolver", 1, max_fitness=Fitness.BEST
            )[0]
            init = InitResolversRequest(generation, start_version)
            ctrl = self.transport.remote_stream(
                worker.address, WLTOKEN_RESOLVER_BASE
            )
            ctrl.send(init)
            got = await timeout(
                init.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT, _LOST
            )
            if got is _LOST:
                # Lease said live but the host is gone (mid-SIGKILL):
                # forget it so the next attempt ranks the survivors; the
                # worker re-registers on its next beat if it was a blip.
                self.registry.forget(worker.worker_id)
                raise OperationFailed(
                    f"resolver host {worker.worker_id} did not confirm "
                    "recruitment"
                )
            self.recruited["resolver"] = worker.worker_id
            resolvers = [
                RemoteResolver(self.transport, worker.address, i,
                               generation=generation)
                for i in range(self.n_resolvers)
            ]
            resolver_config = ResolverConfig(self.resolver_boundaries)
            self.balancer = ResolutionBalancer(resolver_config, resolvers)
            self.resolver = resolvers[0]
        else:
            self.resolver = ResolverRole(
                make_conflict_set(start_version, device=self.device),
                init_version=start_version,
            )
        storage_statuses = [
            _RemoteStorageStatus(tag, ctrl)
            for tag, ctrl in self.storage_ctrl.items()
        ]
        self.ratekeeper = Ratekeeper(self.log_system, storage_statuses)
        self.ratekeeper.set_excluded(self.excluded)
        self.proxy = CommitProxy(
            self.master, self.resolver, tlog=None,
            ratekeeper=self.ratekeeper, generation=generation,
            log_system=self.log_system, shard_map=self.shard_map,
            resolvers=resolvers, resolver_config=resolver_config,
        )
        self.proxy.metadata_hook = self._apply_metadata
        self.ratekeeper.start()
        self.proxy.start()
        self._gen_tasks.add(spawn(
            self._status_poller(storage_statuses), TaskPriority.DEFAULT,
            name="statusPoller",
        ))
        if resolvers is not None:
            self._gen_tasks.add(spawn(
                self._balancer_loop(resolvers), TaskPriority.DEFAULT,
                name="resolutionBalancer",
            ))
        self.grv_ref.target = self.proxy.grv_stream
        self.commit_ref.target = self.proxy.commit_stream
        self.location_ref.target = self.proxy.location_stream
        _send_recovery_txn(self.commit_ref, start_version)
        _seal_generation(self.cstate, generation, recovery_version)
        # Discard never-durable \xff effects (same contract as
        # RecoverableShardedCluster._rebuild_metadata_caches): clamp the
        # watermark to a reachable version, then re-derive the caches from
        # durable storage.
        self.metadata_version = min(self.metadata_version, start_version)
        self._gen_tasks.add(spawn(
            self._rebuild_metadata_caches(start_version),
            TaskPriority.DEFAULT, name="metadataRebuild",
        ))
        self.recoveries_done += 1
        self.recovery_state = "fully_recovered"
        TraceEvent("RecoveryComplete").detail(
            "Generation", generation
        ).detail("RecoveryVersion", recovery_version).detail(
            "MultiProcess", True
        ).log()

    async def _rebuild_metadata_caches(self, recovery_version: int) -> None:
        from ..kv.keys import strinc
        from .system_data import (
            CONF_PREFIX,
            EXCLUDED_PREFIX,
            decode_config_key,
            decode_excluded_server_key,
        )

        loop = current_loop()
        generation = self.generation
        begin, end = CONF_PREFIX, strinc(CONF_PREFIX)
        while self.generation == generation:
            target = max(recovery_version, self.metadata_version)
            try:
                rows = await self._forward_read(
                    GetRangeRequest(begin, end, target)
                )
            except BaseException:  # noqa: BLE001 — storage still catching up
                await loop.delay(0.2)
                continue
            if self.generation != generation:
                return
            if self.metadata_version > target:
                continue  # a commit raced the read; re-derive
            excluded: set[int] = set()
            conf: dict[str, str] = {}
            for k, v in rows:
                if k.startswith(EXCLUDED_PREFIX):
                    excluded.add(decode_excluded_server_key(k))
                elif k.startswith(CONF_PREFIX):
                    conf[decode_config_key(k)] = v.decode()
            self.excluded.clear()
            self.excluded.update(excluded)
            self.config_values.clear()
            self.config_values.update(conf)
            if self.ratekeeper is not None:
                self.ratekeeper.set_excluded(self.excluded)
            TraceEvent("MetadataCachesRebuilt").detail(
                "Version", target
            ).detail("MultiProcess", True).log()
            return

    async def _balancer_loop(self, resolvers) -> None:
        """Master-side resolutionBalancing over the wire (ref:
        masterserver.actor.cpp:896): pull each remote resolver's load +
        key sample, then let the balancer move a hot boundary; proxies
        route the next windows under the updated shared config."""
        loop = current_loop()
        while True:
            await loop.delay(SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL)
            try:
                for r in resolvers:
                    await r.refresh_status()
                self.balancer.step(self.master.version)
            except GeneratorExit:
                raise
            except BaseException as e:  # noqa: BLE001 — transient RPC loss
                from ..core.errors import ActorCancelled

                if isinstance(e, ActorCancelled):
                    raise
                TraceEvent("ResolutionBalancerSkipped",
                           severity=20).error(e).log()

    async def _status_poller(self, storage_statuses) -> None:
        loop = current_loop()
        while True:
            try:
                await self.log_system.refresh_status()
                for st in storage_statuses:
                    await st.refresh()
            except GeneratorExit:
                raise
            except BaseException:  # noqa: BLE001 — transient RPC loss
                pass
            await loop.delay(SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL)

    def _stop_transaction_system(self) -> None:
        self._gen_tasks.cancel_all()
        if self.proxy is not None:
            self.proxy.stop()
        if self.ratekeeper is not None:
            self.ratekeeper.stop()
        self.master = self.resolver = self.proxy = self.ratekeeper = None
        self.grv_ref.target = None
        self.commit_ref.target = None
        self.location_ref.target = None

    def start_controller(self, name: str = "cc0", on_lead=None,
                         on_recovered=None) -> None:
        """Same election + health-probe + recover loop as the in-process
        tiers (RecoverableCluster.start_controller), with the recovery
        steps awaited over RPC and recruitment stalls PARKED: a
        RecruitmentStalled recovery waits on the registry's registration
        event (bounded by RECRUITMENT_STALL_RETRY_DELAY) instead of
        crash-looping, and resumes the instant a worker registers.

        Controller FAILOVER: several candidates (txn hosts across
        machines, sharing a `coordination_dir` quorum) may run this loop;
        the lease arbitrates. `on_lead` fires when THIS candidate takes
        the seat (publish the controller address so workers re-register
        here — the registry is rebuilt from exactly those
        re-registrations); `on_recovered` fires after each completed
        recovery (publish the client-facing txn alias). A deposed leader
        tears its transaction system down — its generation is fenced by
        the successor's locks anyway, and a fenced corpse must not keep
        answering status as if it served."""
        from ..core.errors import ActorCancelled
        from .recruitment import RecruitmentStalled

        async def controller():
            loop = current_loop()
            lease = None
            while True:
                await loop.delay(
                    SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL
                    * (0.8 + 0.4 * loop.random.random01())
                )
                try:
                    if lease is None:
                        lease = self.election.try_become_leader(name)
                        if lease is None:
                            continue
                        TraceEvent("ControllerSeatTaken").detail(
                            "Name", name
                        ).detail("Epoch", lease.epoch).log()
                        if on_lead is not None:
                            on_lead()
                    else:
                        renewed = self.election.heartbeat(lease)
                        if renewed is None:
                            TraceEvent("ControllerDeposed",
                                       severity=30).detail(
                                "Name", name
                            ).log()
                            lease = None
                            self._stop_transaction_system()
                            self.recovery_state = "deposed"
                            continue
                        lease = renewed
                    if not await self._txn_system_healthy():
                        TraceEvent("ControllerRecovering",
                                   severity=30).detail("Name", name).detail(
                            "Generation", self.generation
                        ).log()
                        await self.recover()
                        if on_recovered is not None:
                            on_recovered()
                except (ActorCancelled, GeneratorExit):
                    raise
                except RecruitmentStalled:
                    # Parked, not errored: the stall is already recorded
                    # (status json shows recruiting_<role>); wake on the
                    # next registration or the stall-retry delay.
                    await self.registry.wait_for_worker()
                except BaseException as e:  # noqa: BLE001
                    TraceEvent("ControllerError", severity=30).error(e).log()

        self._controllers.add(
            spawn(controller(), TaskPriority.COORDINATION,
                  name=f"controller:{name}")
        )

    async def _txn_system_healthy(self) -> bool:
        from .recovery import RecoverableCluster

        # A recruited worker whose lease lapsed takes its role down with
        # it (the SIGKILLed resolver host): unhealthy regardless of what
        # the commit probe says — the commit path's errored replies would
        # otherwise read as "pipeline answers" forever (ref: the
        # controller's WaitFailureClient on every recruited interface).
        for role in sorted(self.recruited):
            wid = self.recruited[role]
            if not self.registry.is_live(wid):
                TraceEvent("RecruitedWorkerFailed", severity=30).detail(
                    "Role", role
                ).detail("Worker", wid).log()
                return False
        return await RecoverableCluster._txn_system_healthy(self)

    def stop(self) -> None:
        self._controllers.cancel_all()
        self._stop_transaction_system()
        self.registry.stop()
        self._tasks.cancel_all()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------
def connect(transport, cluster_file: str):
    """Build a Database against a multi-process deployment: GRV/commit/
    location at the txn host, reads direct to the storage host by tag
    (ref: the client's two-hop architecture — proxies for the txn path,
    storage servers for reads)."""
    from ..client.connection import ShardedConnection
    from ..client.database import Database
    from ..net.service import WLTOKEN_COMMIT, WLTOKEN_GRV

    info = read_cluster_file(cluster_file)
    if not info or "txn" not in info:
        raise OperationFailed(f"cluster file {cluster_file} incomplete")
    spec = info.get("spec", {})
    n_storage = spec.get("n_storage", 4)
    conn = ShardedConnection(
        transport.remote_stream(info["txn"], WLTOKEN_GRV),
        transport.remote_stream(info["txn"], WLTOKEN_COMMIT),
        transport.remote_stream(info["txn"], WLTOKEN_LOCATION),
        {
            tag: transport.remote_stream(
                info["storage"], WLTOKEN_STORAGE_BASE + 2 * tag
            )
            for tag in range(n_storage)
        },
        commit_batch_endpoint=transport.remote_stream(
            info["txn"], WLTOKEN_COMMIT_BATCH
        ),
    )
    return Database(None, conn=conn)


# ---------------------------------------------------------------------------
# process entrypoints (server.py -r fdbd --class ...)
# ---------------------------------------------------------------------------
def start_worker_registration(transport, cluster_file: str, role_class: str,
                              machine_id: str, stopping):
    """Register this host with the controller on the heartbeat interval
    (ref: worker.actor.cpp:481 registrationClient — workers re-register
    forever; registration IS the lease heartbeat). The controller
    address comes from the cluster file's `controller` key, which the
    txn host publishes BEFORE its first recovery so a stalled boot
    recruitment can be un-stalled by exactly this loop."""
    from .interfaces import RegisterWorkerRequest

    async def reg():
        loop = current_loop()
        worker_id = f"{role_class}@{transport.local_address}"
        ctrl = ctrl_addr = None
        while not stopping():
            info = read_cluster_file(cluster_file) or {}
            addr = info.get("controller") or info.get("txn")
            if addr is None:
                await loop.delay(0.1)
                continue
            if addr != ctrl_addr:
                ctrl = transport.remote_stream(addr, WLTOKEN_CONTROLLER)
                ctrl_addr = addr
            req = RegisterWorkerRequest(
                worker_id, role_class, transport.local_address, machine_id
            )
            ctrl.send(req)
            # The reply carries the controller's expected interval; a
            # lost reply just means beating again at our own cadence.
            await timeout(req.reply.future,
                          SERVER_KNOBS.WORKER_HEARTBEAT_INTERVAL, _LOST)
            await loop.delay(
                SERVER_KNOBS.WORKER_HEARTBEAT_INTERVAL
                * (0.75 + 0.5 * loop.random.random01())
            )

    return spawn(reg(), TaskPriority.COORDINATION,
                 name=f"register:{role_class}")


def holds_device(role_class: str) -> bool:
    """Whether a role class keeps state on the device: the storage host's
    windows, the resolver host's conflict sets and the txn host's
    in-process conflict set. The log hosts do not."""
    return (role_class == "storage" or is_resolver_class(role_class)
            or is_txn_class(role_class))


def warm_device(device=None):
    """Resolve `device` (None: the CUDA card; RuntimeError naming CUDA when
    there is none) and warm it for a role host: on the card, build the
    kernels, create this process's CUDA context and run a small conflict
    set's resolve paths and a window's read batch once. Recruitment and
    the first resolve are RPCs bounded by ROLE_RPC_TIMEOUT, which a first
    build or a cold context inside them would overrun. Returns the
    torch.device."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    import torch

    from .. import _build
    from ..resolver.gpu import ConflictSetGPU
    from ..storage_engine.gpu_engine import KeyValueStoreGPU

    _build.build_all()
    ConflictSetGPU(0, device=dev).warmup(shapes=[(8, 40, 16)])
    window = KeyValueStoreGPU(device=dev)
    window.set(b"warm", b"up", 1)
    window.read_verdicts(window.submit_reads([(b"warm", 1)], []))
    torch.cuda.synchronize(dev)
    return dev


def _register_device_gauges(registry) -> None:
    """This process's device use, for scrapes from another one: the
    probe's launches (the kernel wrapper counts them), whether it holds a
    CUDA context, and the bytes its caching allocator reserves."""
    import torch

    from ..resolver import probe

    def reserved() -> int:
        return (torch.cuda.memory_reserved()
                if torch.cuda.is_initialized() else 0)

    for name, fn in (
        ("probe.launches_total", lambda: probe.LAUNCHES),
        ("device.contexts_count", lambda: int(torch.cuda.is_initialized())),
        ("device.memory_reserved_bytes", reserved),
    ):
        registry.register_gauge(name, fn, replace=True)


def run_role_host(role_class: str, cluster_file: str, datadir: str,
                  port: int = 0, ready=None, stop_event=None,
                  machine_id: str = "", trace_dir: str = "",
                  metrics_port: int = 0, device=None) -> None:
    """Run one role host on a real-clock loop until stop_event. The host
    merges its listen address into the cluster file; hosts needing peers
    wait for the peers' addresses to appear (discovery via the shared
    file, the reference's cluster-file contract). Every host registers
    with the controller (worker registry) under `machine_id` — its
    shared-fate failure domain (--machine-id / the spec's `machines`
    stanza). A class that holds device state (`holds_device`) resolves
    and warms `device` (None: the CUDA card) first, so without a card it
    raises before it publishes anything."""
    from ..net.transport import real_loop_with_transport

    dev = warm_device(device) if holds_device(role_class) else None
    spec = None
    while spec is None:
        info = read_cluster_file(cluster_file)
        spec = (info or {}).get("spec")
        if spec is None:
            import time as _t

            # fdblint: allow[det-sleep] -- real-OS-process startup: polls the shared cluster file before any event loop exists; this host entry point only ever runs on the real-clock multiprocess tier.
            _t.sleep(0.05)
    # A pinned per-class port (spec["ports"]) keeps the address stable
    # across process restarts, so peers' cached addresses stay valid (the
    # reference pins fdbd listen addresses in its conf the same way).
    port = spec.get("ports", {}).get(role_class, port)
    # Spec-carried knob overrides ("server:NAME"/"client:NAME" -> value,
    # the sim tester's format): every role host applies the same set from
    # the shared cluster file, so a deployment tunes its commit plane
    # (pipeline depth, GRV cache, batch targets) in ONE document instead
    # of per-process --knob flags that can diverge.
    from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS

    regs = {"server": SERVER_KNOBS, "client": CLIENT_KNOBS}
    for key, value in (spec.get("knobs") or {}).items():
        reg_name, _, name = key.partition(":")
        if reg_name not in regs:
            raise ValueError(f"spec knob key {key!r}: registry must be "
                             "'server' or 'client'")
        regs[reg_name].set_knob(name, str(value))
    # Per-process trace file (the reference's fdbd writes one per process)
    # with size-based rolling + retained-file pruning (ref: openTraceFile):
    # operators and tests read role behavior from the datadir (or a
    # shared --trace-dir / spec trace_dir, where files are named per
    # class). The in-memory window stays ON (bounded) — it is what the
    # WLTOKEN_TRACE flight-recorder queries answer from.
    from ..core.trace import TraceSink, set_global_sink

    os.makedirs(datadir, exist_ok=True)
    trace_dir = trace_dir or spec.get("trace_dir") or ""
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace_path = os.path.join(trace_dir, f"trace-{role_class}.jsonl")
    else:
        trace_path = os.path.join(datadir, "trace.jsonl")
    sink = set_global_sink(TraceSink(
        path=trace_path, keep_in_memory=True, memory_limit=50_000,
        roll_size=SERVER_KNOBS.TRACE_ROLL_SIZE_BYTES,
        max_retained=SERVER_KNOBS.TRACE_RETAINED_FILES,
    ))
    loop, transport = real_loop_with_transport(port=port)
    sink.process_name = f"{role_class}@{transport.local_address}"
    # Slow-task detection + the sampling profiler feeding its stack
    # snapshots (ref: Net2's slow-task accounting :570): real-clock role
    # hosts only — simulated loops never arm the threshold.
    prof = None
    if SERVER_KNOBS.SLOW_TASK_THRESHOLD_MS > 0:
        loop.slow_task_threshold = SERVER_KNOBS.SLOW_TASK_THRESHOLD_MS / 1e3
        from ..core.profiler import Profiler

        prof = Profiler()
        try:
            prof.start(0.02)
            loop.profiler = prof
        except Exception:  # pragma: no cover - restricted environments
            prof = None
    with _loop_ctx(loop):

        def stopping() -> bool:
            return stop_event is not None and stop_event.is_set()

        n_log_hosts = spec.get("n_log_hosts", 1)
        log_keys = log_host_classes(n_log_hosts)

        async def _all_log_addrs():
            addrs = []
            for key in log_keys:
                a = await _wait_for(cluster_file, key, stopping)
                if a is None:
                    return None
                addrs.append(a)
            return addrs

        mid = machine_id or machine_for_class(spec, role_class)

        async def main():
            host = None
            reg_task = None
            http_metrics = None
            # Flight-recorder query endpoint: EVERY role host serves its
            # in-memory trace window over WLTOKEN_TRACE so `cli.py trace`
            # / `events` can stitch cross-process timelines.
            trace_tasks = ActorCollection()
            start_trace_service(transport, trace_tasks)
            # Metrics plane: every role host serves its MetricRegistry
            # over WLTOKEN_METRICS, samples the ring-buffer series, and
            # surfaces process health (RSS/FDs/CPU/loop lag) as volatile
            # gauges; an optional HTTP port serves the Prometheus text
            # exposition (--metrics-port / the spec's metrics_ports map).
            from ..core.metrics import global_registry
            from ..core.system_monitor import SystemMonitor

            registry = global_registry()
            _register_device_gauges(registry)
            start_metrics_service(transport, trace_tasks)
            registry.start_sampler()
            sysmon = SystemMonitor()
            sysmon.register_metrics(registry)
            sysmon.start()
            mport = (spec.get("metrics_ports", {}) or {}).get(
                role_class, metrics_port
            )
            if mport:
                from ..net.http import TextHTTPServer

                http_metrics = TextHTTPServer(
                    int(mport),
                    lambda: registry.prometheus_text(),
                    content_type="text/plain; version=0.0.4",
                )
                http_metrics.start()
                TraceEvent("MetricsHTTPServing").detail(
                    "Port", http_metrics.port
                ).log()
            if role_class in log_keys:
                idx = log_keys.index(role_class)
                host = LogHost(transport, f"{datadir}/log",
                               spec.get("n_logs", 2), host_index=idx,
                               n_log_hosts=n_log_hosts)
            elif role_class == "storage":
                log_addrs = await _all_log_addrs()
                if log_addrs is None:
                    return
                host = StorageHost(transport, f"{datadir}/storage", spec,
                                   log_addrs, cluster_file=cluster_file,
                                   device=dev)
            elif is_resolver_class(role_class):
                host = ResolverHost(transport, spec, device=dev)
            elif is_txn_class(role_class):
                log_addrs = await _all_log_addrs()
                storage_addr = await _wait_for(cluster_file, "storage",
                                               stopping)
                if log_addrs is None or storage_addr is None:
                    return
                want_res = any(is_resolver_class(c)
                               for c in spec.get("ports", {}))
                host = TxnHost(transport, f"{datadir}/txn", spec,
                               log_addrs, storage_addr,
                               want_resolvers=want_res,
                               cluster_file=cluster_file, device=dev)
                addr = transport.local_address

                def on_lead():
                    # Publish the CONTROLLER address the moment this
                    # candidate takes the seat — BEFORE any recovery, so
                    # workers (re-)register HERE and a stalled
                    # recruitment can be un-stalled by exactly their
                    # registration; after a failover the registry is
                    # rebuilt from those re-registrations.
                    write_cluster_file(cluster_file, {"controller": addr})

                def on_recovered():
                    # The client-facing alias stays RECOVERY-GATED: a
                    # client that sees "txn" can commit immediately.
                    write_cluster_file(cluster_file, {"txn": addr})

                # Every txn host is a controller CANDIDATE: the election
                # over the (optionally shared) coordination quorum
                # arbitrates; the winner runs the boot recovery from
                # inside the controller loop (an unhealthy probe — no
                # proxy yet — IS the boot trigger), standbys park on the
                # lease until the incumbent dies.
                host.start_controller(f"{role_class}:{addr}",
                                      on_lead=on_lead,
                                      on_recovered=on_recovered)
            else:
                raise ValueError(f"unknown process class {role_class!r}")
            # Every host — txn candidates included — heartbeats into the
            # serving controller's worker registry (class + machine/
            # failure-domain id): the registry is how recovery finds
            # recruits and how their death is detected (lease lapse). The
            # loop follows the cluster file's `controller` key, so a
            # controller failover re-points every worker's registration.
            reg_task = start_worker_registration(
                transport, cluster_file, role_class, mid, stopping
            )
            # Publish the address only once the endpoints are LIVE — a
            # peer reading the cluster file must never race this host's
            # registration. The legacy single-candidate class "txn" keeps
            # its key recovery-gated (it doubles as the client alias the
            # on_recovered callback owns).
            if role_class != "txn":
                write_cluster_file(cluster_file,
                                   {role_class: transport.local_address})
            if ready is not None:
                ready.address = transport.local_address
                ready.set()
            ppid = os.getppid()
            try:
                while stop_event is None or not stop_event.is_set():
                    # Orphan watch: role hosts are children of a launcher
                    # (fdbmonitor / a test harness); if it dies without
                    # tearing us down (kill -9 on the parent), exit rather
                    # than leak forever (observed: orphaned fdbd hosts
                    # from crashed pytest runs alive hours later).
                    if spec.get("exit_when_orphaned", True) and \
                            os.getppid() != ppid:
                        TraceEvent("RoleHostOrphaned", severity=30).log()
                        break
                    await current_loop().delay(0.05)
            finally:
                if reg_task is not None:
                    reg_task.cancel()
                sysmon.stop()
                registry.stop_sampler()
                if http_metrics is not None:
                    http_metrics.stop()
                trace_tasks.cancel_all()
                host.stop()

        loop.run(main())
        transport.close()
    if prof is not None:
        prof.stop()
    sink.close()


def run_machine(machine_id: str, cluster_file: str, datadir: str,
                stop_event=None, device=None) -> int:
    """Run EVERY process class of one spec machine as child OS processes
    sharing THIS launcher's process group — the multiprocess tier's
    shared-fate failure domain, mirroring sim/topology.SimMachine (one
    kill takes every resident role at one instant; ref: sim2's
    MachineInfo + fdbmonitor supervising a machine's fdbd fleet).

    Shared fate holds in BOTH directions: SIGKILL of the process group
    (the generated `<datadir>/kill.sh`) destroys the launcher and every
    role host at one instant, and any single resident process dying
    takes the rest of the machine down with it. Returns 0 on clean stop,
    else the first dead child's exit status. Each child is this package's
    server, given `device` ("cuda" | "cpu"; None: its default, the card)
    as --device."""
    import subprocess
    import sys as _sys
    import time as _time

    spec = None
    while spec is None and not (stop_event is not None
                                and stop_event.is_set()):
        info = read_cluster_file(cluster_file)
        spec = (info or {}).get("spec")
        if spec is None:
            # fdblint: allow[det-sleep] -- real-OS machine launcher: polls the shared cluster file before any event loop exists; this entry point only runs on the real-clock multiprocess tier.
            _time.sleep(0.05)
    if spec is None:
        return 0
    machines = spec.get("machines") or {}
    if machine_id not in machines:
        raise ValueError(
            f"machine {machine_id!r} not in the spec's machines stanza "
            f"(have: {sorted(machines)})"
        )
    classes = list(machines[machine_id])
    os.makedirs(datadir, exist_ok=True)
    # The shared-fate kill script: kill -9 of the GROUP is the machine
    # dying — launcher and every resident role host at one instant.
    pgid = os.getpgid(0)
    kill_sh = os.path.join(datadir, "kill.sh")
    with open(kill_sh, "w") as f:
        f.write(
            "#!/bin/sh\n"
            f"# shared-fate kill of machine {machine_id!r}: every role\n"
            "# host shares the launcher's process group.\n"
            f"kill -9 -- -{pgid}\n"
        )
    os.chmod(kill_sh, 0o755)
    procs = []
    for cls in classes:
        # NO new session: children inherit the launcher's process group,
        # which IS the machine's failure domain.
        procs.append(subprocess.Popen(
            [_sys.executable, "-m", "foundationdb_tpu_torch.server", "-r",
             "fdbd", "-c", cls, "-C", cluster_file,
             "-d", os.path.join(datadir, cls), "--machine-id", machine_id]
            + ([] if device is None else ["--device", str(device)]),
        ))
    try:
        while True:
            if stop_event is not None and stop_event.is_set():
                for p in procs:
                    p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=20)
                    except subprocess.TimeoutExpired:
                        p.kill()
                return 0
            for p in procs:
                code = p.poll()
                if code is not None:
                    # One resident died: the machine dies with it.
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    for q in procs:
                        try:
                            q.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            pass
                    return code or 1
            # fdblint: allow[det-sleep] -- real-OS machine launcher supervision loop (no event loop in this process); multiprocess tier only.
            _time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


async def _wait_for(cluster_file: str, key: str,
                    stopping=lambda: False) -> Optional[str]:
    """Poll the cluster file for a peer's address; None once `stopping`."""
    loop = current_loop()
    while not stopping():
        info = read_cluster_file(cluster_file)
        if info and key in info:
            return info[key]
        await loop.delay(0.05)
    return None


def _loop_ctx(loop):
    from ..core.runtime import loop_context

    return loop_context(loop)
