"""Recovery generations: a coordinated, fenced rebuild of the transaction
system over the surviving log (ref: fdbserver/masterserver.actor.cpp
masterCore :1077 / recoverFrom :705; ClusterController's
clusterWatchDatabase :985 recruits a new master when the old one dies).

The recovery sequence, exactly the reference's shape:

  1. A controller holding the coordination lease bumps the generation in
     the coordinated state (the fence: older generations can no longer
     write it).
  2. Epoch end: lock the log at the new generation
     (TagPartitionedLogSystem::epochEnd) — in-flight commits from the old
     generation now fail, and the durable version becomes the RECOVERY
     VERSION: everything at or below it is kept, everything above never
     happened.
  3. Recruit fresh stateless roles: a new master (version authority
     starting at the recovery version), a new resolver whose conflict
     history is re-seeded AT the recovery version (any transaction with an
     older snapshot conflicts — the reference initializes recovered
     resolvers the same way), and a new proxy tagged with the generation.
  4. Publish the new endpoints; clients' retry loops (timeouts +
     commit_unknown_result) land on the new generation transparently.

Storage and the log survive role death here (the common FDB failure mode:
stateless roles die, tlogs' durable state persists); full log-server loss
is the domain of log replication, a later tier.

The port's copy of foundationdb_tpu/cluster/recovery.py. Each
generation's resolvers are recruited through make_conflict_set, which
reads SERVER_KNOBS.CONFLICT_SET_IMPL ("gpu" by default: a fresh
ConflictSetGPU on `device`, None meaning the CUDA card, which must be
present; "cpu" runs its plain torch version), and the storage windows are
KeyValueStoreGPU (SERVER_KNOBS.STORAGE_ENGINE_IMPL) on the same device.
A dead generation's roles are dropped whole, so its conflict set and the
device memory behind it are released. With a datadir the sharded tier
is durable (the DiskQueue tlogs, the storage engines, FileCoordinatorRegister
coordinators): a new incarnation over the same datadir cold-boots, its
storage windows restored from their engines onto `device`.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..core.actors import ActorCollection
from ..core.errors import TLogStopped
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import TaskPriority, current_loop, spawn
from ..core.trace import TraceEvent
from ..resolver.factory import make_conflict_set
from .coordination import CoordinatedState, CoordinatorRegister, LeaderElection
from .master import Master
from .proxy import CommitProxy
from .ratekeeper import Ratekeeper
from .resolver_role import ResolverRole
from .storage import StorageServer
from .tlog import MemoryTLog


class EndpointRef:
    """Indirection clients hold instead of a concrete stream: recovery
    repoints it at the new generation's endpoint (ref: MonitorLeader's
    re-resolution of cluster interfaces)."""

    def __init__(self, target=None):
        self.target = target

    def send(self, req) -> None:
        if self.target is not None:
            self.target.send(req)
        # No target (mid-recovery): the message is dropped; the client's
        # timeout/retry machinery handles it like any lost request.


class MultiEndpoint:
    """Round-robin over a proxy fleet's identical endpoints (ref: the
    client spreading GRV/commit across proxies,
    fdbclient/NativeAPI.actor.cpp getReadVersion/commit load balance)."""

    def __init__(self, targets):
        self.targets = list(targets)
        self._i = 0

    def send(self, req) -> None:
        if not self.targets:
            return
        self._i = (self._i + 1) % len(self.targets)
        self.targets[self._i].send(req)


def _bump_generation(cstate) -> int:
    """Step 1 of every recovery: fence older generations in the
    coordinated state (shared by both recoverable tiers)."""

    def bump(cur):
        gen = (cur or {"generation": 0})["generation"] + 1
        return {"generation": gen, "recovery_version": None}

    _, st = cstate.read_modify_write(bump)
    return st["generation"]


def _seal_generation(cstate, generation: int, recovery_version: int) -> None:
    """Final step: record the generation's recovery version unless an even
    newer generation already fenced us."""

    def seal(cur):
        if cur is None or cur["generation"] != generation:
            return cur
        return {"generation": generation,
                "recovery_version": recovery_version}

    cstate.read_modify_write(seal)


def _send_recovery_txn(commit_ref, start_version: int) -> None:
    """The recovery transaction: an empty commit driving the first version
    of the new generation through the log so chains + GRVs converge (ref:
    masterserver.actor.cpp:124)."""
    from .interfaces import CommitTransactionRequest

    commit_ref.send(CommitTransactionRequest(
        read_snapshot=start_version, read_conflict_ranges=(),
        write_conflict_ranges=(), mutations=(),
    ))


class _RecoveryStateRecorder:
    """Coverage hook shared by the recoverable tiers: `recovery_state`
    stays a plain read/write attribute, but every state the incarnation
    ever enters is also recorded (first-entry order) in
    `recovery_states_seen` — workloads/tester.py folds the set into the
    per-spec coverage summary, where the swarm's signature buckets on
    which recovery phases a seed actually reached."""

    @property
    def recovery_state(self) -> str:
        return self.__dict__.get("_recovery_state", "booting")

    @recovery_state.setter
    def recovery_state(self, value: str) -> None:
        self.__dict__["_recovery_state"] = value
        seen = self.__dict__.setdefault("recovery_states_seen", [])
        if value not in seen:
            seen.append(value)


class RecoverableCluster(_RecoveryStateRecorder):
    """A cluster whose transaction system can die and be re-recruited.

    The storage node and the log are long-lived; master/proxy/resolver/
    ratekeeper are per-generation. `database()` hands out connections bound
    to EndpointRefs, so clients transparently follow recoveries.
    """

    def __init__(
        self,
        conflict_set_factory: Optional[Callable[[int], object]] = None,
        n_coordinators: int = 3,
        device=None,
    ):
        self.conflict_set_factory = conflict_set_factory or (
            lambda v: make_conflict_set(v, device=device)
        )
        self.coordinators = [
            CoordinatorRegister(f"coord{i}") for i in range(n_coordinators)
        ]
        self.cstate = CoordinatedState(self.coordinators, key="generation")
        self.election = LeaderElection(
            CoordinatedState(self.coordinators, key="leader"),
        )
        self.tlog = MemoryTLog(0)
        self.storage = StorageServer(self.tlog, 0, device=device)
        self.generation = 0
        self.recoveries_done = 0
        self.recovery_state = "booting"
        self.master: Optional[Master] = None
        self.resolver: Optional[ResolverRole] = None
        self.proxy: Optional[CommitProxy] = None
        self.ratekeeper: Optional[Ratekeeper] = None
        self.grv_ref = EndpointRef()
        self.commit_ref = EndpointRef()
        self.storage_ref = EndpointRef()
        self._controllers = ActorCollection()

    # -- lifecycle --
    def start(self) -> "RecoverableCluster":
        self.storage.start()
        self.storage_ref.target = self.storage.read_stream
        self._recover()
        return self

    def stop(self) -> None:
        self._controllers.cancel_all()
        self._stop_transaction_system()
        self.storage.stop()

    def database(self):
        from ..client.connection import ClusterConnection
        from ..client.database import Database

        conn = ClusterConnection(self.grv_ref, self.commit_ref,
                                 self.storage_ref)
        return Database(self, conn=conn)

    # -- failure injection (tests / attrition) --
    def kill_transaction_system(self) -> None:
        """Drop master/proxy/resolver on the floor (role death with state
        loss — their state is per-generation by design)."""
        TraceEvent("TxnSystemKilled", severity=30).detail(
            "Generation", self.generation
        ).log()
        self._stop_transaction_system()

    def _stop_transaction_system(self) -> None:
        if self.proxy is not None:
            self.proxy.stop()
        if self.ratekeeper is not None:
            self.ratekeeper.stop()
        self.grv_ref.target = None
        self.commit_ref.target = None
        self.master = None
        self.resolver = None
        self.proxy = None
        self.ratekeeper = None

    # -- recovery --
    def _recover(self) -> None:
        """Steps 1-4 of the module docstring. Synchronous: every step is
        quorum arithmetic + object construction on the loop thread."""

        self.recovery_state = "recovering"
        generation = _bump_generation(self.cstate)
        recovery_version = self.tlog.lock(generation)
        # The new generation's version chain must start above anything the
        # old generation ever RECEIVED at the log (purged non-durable
        # entries leave a skipped version gap; storage follows entries, not
        # the counter).
        start_version = max(recovery_version, self.tlog.version.get())

        self._stop_transaction_system()
        self.generation = generation
        self.master = Master(init_version=start_version)
        # Resolver history re-seeds AT the recovery point: any transaction
        # whose snapshot predates it conflicts and retries on the new
        # generation (ref: sendInitialCommitToResolvers' fresh state).
        self.resolver = ResolverRole(
            self.conflict_set_factory(start_version),
            init_version=start_version,
        )
        self.ratekeeper = Ratekeeper(self.tlog, self.storage)
        self.proxy = CommitProxy(
            self.master, self.resolver, self.tlog,
            ratekeeper=self.ratekeeper, generation=generation,
        )
        self.ratekeeper.start()
        self.proxy.start()
        self.grv_ref.target = self.proxy.grv_stream
        self.commit_ref.target = self.proxy.commit_stream

        _send_recovery_txn(self.commit_ref, start_version)
        _seal_generation(self.cstate, generation, recovery_version)
        self.recoveries_done += 1
        self.recovery_state = "fully_recovered"
        TraceEvent("RecoveryComplete").detail("Generation", generation).detail(
            "RecoveryVersion", recovery_version
        ).log()

    # -- the controller role (ref: clusterWatchDatabase + failure pings) --
    def start_controller(self, name: str = "cc0") -> None:
        """Spawn a controller candidate: campaigns for the coordination
        lease, and while leading, health-checks the transaction system and
        recovers it on failure. Multiple candidates may run; the lease
        arbitrates (ref: ClusterController election + WaitFailure)."""

        async def controller():
            from ..core.errors import ActorCancelled
            from .recruitment import RecruitmentStalled

            loop = current_loop()
            lease = None
            while True:
                await loop.delay(
                    SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL
                    * (0.8 + 0.4 * loop.random.random01())
                )
                # The controller is the cluster's only recovery mechanism:
                # NOTHING transient may kill it — a coordination quorum
                # blip (OperationFailed from read/write) or an errored
                # probe reply just skips the tick (ref: the reference's
                # cluster controller survives every recruitment error).
                try:
                    if lease is None:
                        lease = self.election.try_become_leader(name)
                        continue
                    renewed = self.election.heartbeat(lease)
                    if renewed is None:
                        TraceEvent("ControllerDeposed").detail(
                            "Name", name
                        ).log()
                        lease = None
                        continue
                    lease = renewed
                    if not await self._txn_system_healthy():
                        TraceEvent("ControllerRecovering", severity=30).detail(
                            "Name", name
                        ).detail("Generation", self.generation).log()
                        self._recover()
                except (ActorCancelled, GeneratorExit):
                    raise
                except RecruitmentStalled:
                    # A parked recruitment is a NAMED state, not an
                    # error: re-check at the stall-retry cadence (the
                    # stall itself was already trace-logged once).
                    await loop.delay(
                        SERVER_KNOBS.RECRUITMENT_STALL_RETRY_DELAY
                    )
                except BaseException as e:  # noqa: BLE001
                    TraceEvent("ControllerError", severity=30).error(e).log()

        self._controllers.add(
            spawn(controller(), TaskPriority.COORDINATION,
                  name=f"controller:{name}")
        )

    async def _txn_system_healthy(self) -> bool:
        """A real end-to-end probe through the COMMIT path: an empty commit
        must answer within the failure timeout. GRV alone cannot see a
        wedged version chain (the GRV batcher keeps answering while every
        commit blocks in when_at_least), so the probe exercises master ->
        resolver -> tlog exactly like client traffic (ref: WaitFailure's
        per-role ping + the latency probe in Status)."""
        from ..core.actors import timeout
        from .interfaces import CommitTransactionRequest

        if self.proxy is None:
            return False
        if getattr(self.proxy, "_epoch_dead", False):
            # The proxy itself proved it is fenced (a newer lock exists on
            # some log): unhealthy regardless of what a probe reply says.
            return False
        wedge = getattr(self, "_wedge_probe", None)
        if wedge is not None and wedge():
            # The fault topology proved the commit plane is wedged on a
            # durable role that re-recruitment can replace (a dark log
            # whose host is dead past its lease): unhealthy even though
            # the proxy answers every probe with a crisp TLogFailed —
            # recovery is what performs the replacement.
            return False
        from ..core.runtime import buggify, current_loop

        if buggify("controller_slow_probe"):
            # Health probes lag: failures detected late, recoveries
            # bunched; liveness must still converge.
            await current_loop().delay(0.3 * current_loop().random.random01())
        probe = CommitTransactionRequest(
            read_snapshot=0, read_conflict_ranges=(),
            write_conflict_ranges=(), mutations=(),
        )
        self.commit_ref.send(probe)
        try:
            got = await timeout(probe.reply.future, 0.6, default=None)
        except TLogStopped:
            # The probe was refused by an epoch fence: a NEWER lock exists
            # somewhere (e.g. a previous recovery attempt locked part of
            # the log quorum before losing a host), so THIS generation can
            # never commit again — recovery must run, not be skipped.
            # Found by the 2-log-host SIGKILL test: a partial lock wedged
            # the cluster forever while the probe kept reporting healthy.
            return False
        except BaseException:  # noqa: BLE001
            # Any OTHER errored reply still proves the pipeline answers;
            # only silence (a wedged chain) is unhealthy.
            return True
        return got is not None


class RecoverableShardedCluster(_RecoveryStateRecorder):
    """Recovery generations over the SHARDED tier: the tag-partitioned
    log system and the storage fleet are long-lived; master / resolver /
    proxy / ratekeeper are per-generation, re-recruited by the controller
    when the commit path stops answering (ref: the same masterCore
    sequence as RecoverableCluster, with epochEnd now fencing EVERY log —
    TagPartitionedLogSystem::epochEnd computes the recovery version from
    the full quorum, :107).

    Composition: embeds a ShardedKVCluster for the data plane (shard map,
    teams, DD hooks, status) and replaces its transaction system with
    generation-scoped roles behind EndpointRefs, so clients and DD follow
    recoveries transparently.
    """

    def __init__(self, conflict_set_factory=None, n_coordinators: int = 3,
                 coordinators=None, device=None, **sharded_kw):
        from .sharded_cluster import ShardedKVCluster

        self.conflict_set_factory = conflict_set_factory or (
            lambda v: make_conflict_set(v, device=device)
        )
        self.inner = ShardedKVCluster(device=device, **sharded_kw)
        datadir = sharded_kw.get("datadir")
        if sharded_kw.get("os_layer") is not None:
            # Simulated-disk clusters (sim/topology.py power-loss tests):
            # the NonDurableOS holds the log/engine files; coordinator
            # registers stay in-memory — they model a separate, protected
            # failure domain there (sim2's protectedAddresses).
            datadir = None
        if coordinators is not None:
            # Pre-built register servers (the power-loss restart runner
            # carries them across incarnations: the quorum is a separate,
            # protected failure domain, same model as the os_layer note
            # above — the generation fence must survive the reboot).
            self.coordinators = list(coordinators)
        elif datadir is not None:
            # Durable coordinators ride the same datadir: the generation
            # counter and its fencing promises must survive a process kill
            # (a cold boot IS a recovery — it bumps the durable generation
            # and fences the recovered logs with it).
            from .coordination import FileCoordinatorRegister

            self.coordinators = [
                FileCoordinatorRegister(
                    f"coord{i}", f"{datadir}/coord{i}.json"
                )
                for i in range(n_coordinators)
            ]
        else:
            self.coordinators = [
                CoordinatorRegister(f"coord{i}")
                for i in range(n_coordinators)
            ]
        self.cstate = CoordinatedState(self.coordinators, key="generation")
        self.election = LeaderElection(
            CoordinatedState(self.coordinators, key="leader"),
        )
        self.generation = 0
        self.recoveries_done = 0
        self.recovery_state = "booting"
        self.grv_ref = EndpointRef()
        self.commit_ref = EndpointRef()
        self.location_ref = EndpointRef()
        self._controllers = ActorCollection()
        # Per-generation auxiliary tasks (metadata rebuild): cancelled on
        # the next recovery / stop so a rebuild parked on a never-reached
        # version can't leak.
        self._gen_tasks = ActorCollection()

    # -- data-plane passthroughs (status/DD/tests address the cluster) --
    def __getattr__(self, name):
        if name == "inner":  # guard: no recursion before __init__ sets it
            raise AttributeError(name)
        return getattr(self.inner, name)

    def start(self) -> "RecoverableShardedCluster":
        assert not self.inner._started
        self.inner._started = True
        for s in self.inner.storages:
            s.start()
        # Log routers (two-region shipping) outlive generations: the
        # direction check rides the log system's active_set, so they go
        # dormant by themselves after a failover.
        self.inner._router_tasks = self.inner._spawn_log_routers()
        self._recover()
        return self

    def stop(self) -> None:
        self._controllers.cancel_all()
        self._stop_transaction_system()
        if self.inner.dd is not None:
            self.inner.dd.stop()
        for t in self.inner._router_tasks:
            t.cancel()
        self.inner._router_tasks = []
        for s in self.inner.storages:
            s.stop()
        if self.inner.datadir is not None:
            from .sharded_cluster import close_durable_tier

            close_durable_tier(self.inner.storages,
                               self.inner.log_system.all_logs())

    def database(self):
        from ..client.connection import ShardedConnection
        from ..client.database import Database

        conn = ShardedConnection(
            self.grv_ref, self.commit_ref, self.location_ref,
            {s.tag: s.read_stream for s in self.inner.storages},
        )
        return Database(self, conn=conn)

    # -- failure injection --
    def kill_transaction_system(self) -> None:
        TraceEvent("TxnSystemKilled", severity=30).detail(
            "Generation", self.generation
        ).log()
        self._stop_transaction_system()

    def _stop_transaction_system(self) -> None:
        inner = self.inner
        self._gen_tasks.cancel_all()
        for p in (inner.proxies or []) if inner.proxy is not None else []:
            p.stop()
        if inner.ratekeeper is not None:
            inner.ratekeeper.stop()
        # Null the dead generation's roles: the health probe's fast path
        # and anything reading cluster.proxy/master must see "down", not
        # a fenced corpse (matches RecoverableCluster's stop).
        inner.master = None
        inner.resolver = None
        inner.resolvers = []
        inner.proxy = None
        inner.proxies = []
        inner.ratekeeper = None
        self.grv_ref.target = None
        self.commit_ref.target = None
        self.location_ref.target = None

    # -- recovery (the masterCore sequence over the log system) --
    def _recover(self) -> None:
        from .master import Master
        from .proxy import CommitProxy
        from .ratekeeper import Ratekeeper
        from .resolver_role import ResolverRole

        self.recovery_state = "recovering"
        generation = _bump_generation(self.cstate)
        inner = self.inner
        recovery_version = inner.log_system.lock(generation)
        # Storage servers whose log had a half-durable suffix (durable on
        # a subset of logs only — that commit never completed) may have
        # applied past the quorum recovery version: roll them back (ref:
        # storageServerRollbackRebooter, worker.actor.cpp:346).
        for s in inner.storages:
            s.rollback_to(recovery_version)
        start_version = max(
            recovery_version,
            max(log.version.get() for log in inner.log_system.logs),
        )
        # Cold-boot alignment: recovered logs can sit at different durable
        # tops; every chain must start at start_version or the behind logs
        # wedge the first push (see MemoryTLog.skip_to).
        for log in inner.log_system.logs:
            log.skip_to(start_version)

        self._stop_transaction_system()
        self.generation = generation
        inner.master = Master(init_version=start_version)
        # Recruit the full resolution partition + proxy fleet again (ref:
        # masterCore recruiting proxies/resolvers per DatabaseConfiguration
        # each generation). Boundaries persist across generations; each
        # resolver's history re-seeds AT the recovery point.
        if inner.resolver_config is not None:
            inner.resolvers = [
                ResolverRole(self.conflict_set_factory(start_version),
                             init_version=start_version,
                             metrics_labels=(("resolver", str(i)),))
                for i in range(inner.n_resolvers)
            ]
            inner.resolver_config.transitions.clear()
        else:
            inner.resolvers = [ResolverRole(
                self.conflict_set_factory(start_version),
                init_version=start_version,
            )]
        inner.resolver = inner.resolvers[0]
        inner.ratekeeper = Ratekeeper(inner.log_system, inner.storages)
        inner.ratekeeper.set_excluded(
            inner.dd.failed if inner.dd else inner.excluded
        )
        inner.proxies = [
            CommitProxy(
                inner.master, inner.resolver, tlog=None,
                ratekeeper=inner.ratekeeper, generation=generation,
                log_system=inner.log_system, shard_map=inner.shard_map,
                resolvers=(inner.resolvers
                           if inner.resolver_config is not None else None),
                resolver_config=inner.resolver_config,
                metrics_labels=(
                    (("proxy", str(i)),) if inner.n_proxies > 1 else ()
                ),
            )
            for i in range(inner.n_proxies)
        ]
        inner.proxy = inner.proxies[0]
        for p in inner.proxies:
            p.metadata_hook = inner._apply_metadata
        inner.ratekeeper.start()
        for p in inner.proxies:
            p.start()
        if inner.resolver_config is not None:
            self._gen_tasks.add(inner._start_balancer(
                inner.resolver_config, inner.resolvers
            ))
        if len(inner.proxies) > 1:
            self.grv_ref.target = MultiEndpoint(
                [p.grv_stream for p in inner.proxies]
            )
            self.commit_ref.target = MultiEndpoint(
                [p.commit_stream for p in inner.proxies]
            )
            self.location_ref.target = MultiEndpoint(
                [p.location_stream for p in inner.proxies]
            )
        else:
            self.grv_ref.target = inner.proxy.grv_stream
            self.commit_ref.target = inner.proxy.commit_stream
            self.location_ref.target = inner.proxy.location_stream

        _send_recovery_txn(self.commit_ref, start_version)
        _seal_generation(self.cstate, generation, recovery_version)
        # Advertise the generation's endpoints through the coordinators so
        # discovery-based clients (monitor_leader.connect) follow without
        # any shared refs (ref: the leader interface MonitorLeader polls).
        from .monitor_leader import publish_interface

        publish_interface(self.coordinators, {
            "generation": generation,
            "grv": inner.proxy.grv_stream,
            "commit": inner.proxy.commit_stream,
            "location": inner.proxy.location_stream,
            "storage": {s.tag: s.read_stream for s in inner.storages},
        })
        self.recoveries_done += 1
        # Discard never-durable metadata effects: a commit whose push was
        # fenced by THIS recovery may have updated the in-memory config
        # caches pre-push (proxy phase 3). Re-derive them from durable
        # state, the analogue of the reference rebuilding txnStateStore
        # from the recovered log during recovery. The version watermark is
        # clamped first: a phantom effect may carry a version no storage
        # will ever reach (its commit never became durable), and the
        # rebuild's read must wait only on reachable versions.
        inner.metadata_version = min(inner.metadata_version, start_version)
        self._gen_tasks.add(spawn(
            self._rebuild_metadata_caches(start_version),
            TaskPriority.DEFAULT,
            name="metadataRebuild",
        ))
        self.recovery_state = "fully_recovered"
        TraceEvent("RecoveryComplete").detail("Generation", generation).detail(
            "RecoveryVersion", recovery_version
        ).detail("Sharded", True).log()

    async def _rebuild_metadata_caches(self, recovery_version: int) -> None:
        """Replace the \\xff-derived config caches (excluded servers +
        configuration values) with what durable storage holds. Retries
        while commits race the read: the caches' `metadata_version` tells
        whether a newer effect landed after our read version."""
        from ..core.errors import TransactionTooOld, WrongShardServer
        from ..kv.keys import KeyRange, strinc
        from .interfaces import GetRangeRequest
        from .system_data import (
            CONF_PREFIX,
            EXCLUDED_PREFIX,
            decode_config_key,
            decode_excluded_server_key,
        )

        inner = self.inner
        generation = self.generation
        by_tag = {s.tag: s for s in inner.storages}
        begin, end = CONF_PREFIX, strinc(CONF_PREFIX)
        loop = current_loop()
        while self.generation == generation:
            target = max(recovery_version, inner.metadata_version)
            try:
                rows: list = []
                for lo, hi, team in inner.shard_map.intersecting(
                    KeyRange(begin, end)
                ):
                    s = next(
                        (by_tag[t] for t in team if t in by_tag), None
                    )
                    if s is None:
                        raise WrongShardServer()
                    rows.extend(
                        await s.get_range(GetRangeRequest(
                            begin=max(lo, begin), end=min(hi, end),
                            version=target,
                        ))
                    )
            except (WrongShardServer, TransactionTooOld):
                await loop.delay(0.05)
                continue
            if self.generation != generation:
                return
            if inner.metadata_version > target:
                continue  # a commit raced the read; re-derive
            excluded: set[int] = set()
            conf: dict[str, str] = {}
            for k, v in rows:
                if k.startswith(EXCLUDED_PREFIX):
                    excluded.add(decode_excluded_server_key(k))
                elif k.startswith(CONF_PREFIX):
                    conf[decode_config_key(k)] = v.decode()
            # In place: other roles hold references to these objects.
            inner.excluded.clear()
            inner.excluded.update(excluded)
            inner.config_values.clear()
            inner.config_values.update(conf)
            # Ratekeeper holds a COPY of the exclusion set: re-sync it so
            # a discarded phantom exclusion stops suppressing its input.
            if inner.ratekeeper is not None and inner.dd is None:
                inner.ratekeeper.set_excluded(inner.excluded)
            TraceEvent("MetadataCachesRebuilt").detail(
                "Version", target
            ).detail("Excluded", len(excluded)).detail(
                "ConfValues", len(conf)
            ).log()
            return

    # -- the controller (identical contract to RecoverableCluster's) --
    start_controller = RecoverableCluster.start_controller
    _txn_system_healthy = RecoverableCluster._txn_system_healthy
