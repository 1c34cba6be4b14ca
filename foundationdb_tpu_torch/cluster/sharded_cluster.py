"""Sharded, replicated one-process cluster: the full data-plane layout
(ref: SURVEY §2.7 — key-space sharding over storage teams + tag-
partitioned logging + replica-balanced reads).

Compared to LocalCluster (one storage, one log), this wires:

- a TagPartitionedLogSystem with `n_logs` logs;
- `n_storage` storage servers, one tag each, each pulling only its tag;
- a ShardMap assigning each key range a replica TEAM chosen by the
  replication policy over per-server localities (every mutation is
  applied by every team member — k-way redundancy like the reference's
  storage teams, fdbserver/DataDistribution.actor.cpp:486);
- a proxy that tags mutations per the shard map and serves shard
  locations to clients;
- clients that route reads via a location cache and load-balance across
  each shard's team (client/load_balance.py).

The transaction path (master/resolver/proxy pipeline) is unchanged — the
whole point of the seam structure.

The port's twin of foundationdb_tpu/cluster/sharded_cluster.py: every
resolver role's conflict set is ConflictSetGPU and every storage server's
MVCC window KeyValueStoreGPU (SERVER_KNOBS.STORAGE_ENGINE_IMPL), all on
`device` (None: the CUDA card, which must be present; "cpu" runs their
plain torch versions). The durable tier is not ported: its modules have
no counterpart in the port yet, so there is no `engine` argument, and a
`datadir` raises NotImplementedError (durable_tier_missing).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.rand import DeterministicRandom
from ..kv.keys import KEYSPACE_END, KeyRange
from ..resolver.factory import make_conflict_set
from .log_system import TagPartitionedLogSystem
from .master import Master
from .proxy import CommitProxy
from .ratekeeper import Ratekeeper
from .replication import LocalityData, Replica, policy_for_mode
from .resolver_role import ResolverRole
from .shards import ShardMap
from .storage import StorageServer


class ShardedKVCluster:
    def __init__(
        self,
        n_storage: int = 4,
        n_logs: int = 2,
        replication: str = "double",
        shard_boundaries: Optional[Sequence[bytes]] = None,
        conflict_set=None,
        seed: int = 1,
        datadir: Optional[str] = None,
        n_proxies: int = 1,
        n_resolvers: int = 1,
        resolver_boundaries: Optional[Sequence[bytes]] = None,
        topology: Optional[dict] = None,
        os_layer=None,
        log_replication: str = "single",
        regions: bool = False,
        device=None,
    ):
        self.policy = policy_for_mode(replication)
        # Log replication is configured SEPARATELY from storage-team
        # replication (the reference's log_replicas vs storage_replicas):
        # k-way mutation copies across the log fleet's failure domains,
        # with the epoch-end recovery version computed from a quorum.
        log_rep_factor = policy_for_mode(log_replication).num_replicas()
        if log_rep_factor > n_logs:
            raise ValueError(
                f"log_replication={log_replication!r} needs "
                f"{log_rep_factor} logs; spec has n_logs={n_logs}"
            )
        self.log_replication = log_replication
        self.regions = bool(regions)
        if self.regions and (
            topology is None or int(topology.get("n_dcs", 1)) < 2
        ):
            raise ValueError(
                "regions=True needs a machine topology with n_dcs >= 2 "
                "(the remote log set lives in the second DC)"
            )
        # `topology` ({"n_dcs", "machines_per_dc"}) switches localities to
        # the machine/DC model (sim/topology.py): zone == machine, so the
        # replication policy places each team across distinct MACHINES and
        # a machine kill can never take a whole team with it — exactly the
        # reference's default zone=machine failure domain.
        self.topology = topology
        self.replicas = build_replicas(n_storage, topology)
        self.os_layer = os_layer
        # Durable tier (ref: worker.actor.cpp recruiting tlog/storage over
        # their on-disk files): the JAX package rides every tlog on a
        # DiskQueue and flushes every storage server into a recoverable
        # engine under a datadir. The port has neither module yet.
        if datadir is not None:
            raise NotImplementedError(
                durable_tier_missing("ShardedKVCluster", "datadir"))
        self.datadir = None
        # Where the storage windows live; a storage server rebuilt later
        # (sim/topology.py's re-homes) is built on the same device.
        self.device = device
        self.log_system = TagPartitionedLogSystem(
            n_logs, log_replication=log_replication, topology=topology,
            regions=self.regions,
        )
        self.log_routers: list = []
        self._router_tasks: list = []
        self.storages = [
            StorageServer(self.log_system.tag_view(i), 0, tag=i,
                          device=device)
            for i in range(n_storage)
        ]
        # -- initial shard layout: boundaries split the keyspace; each
        #    shard gets a policy-selected team (ref: initial DD teams).
        #    Derivation is DETERMINISTIC in (spec, seed) so independently
        #    booted role hosts (multi-process deployment) agree on the
        #    topology without exchanging it. --
        layout = derive_layout(n_storage, replication, shard_boundaries,
                               seed, topology=topology)
        self.shard_map = ShardMap(default_team=())
        for s in self.storages:
            s.owned = _all_false_map()
            s.assigned = _all_false_map()
        for lo, hi, team in layout:
            self.shard_map.set_team(KeyRange(lo, hi), team)
            for t in team:
                self.storages[t].set_owned(lo, hi, True)
                self.storages[t].set_assigned(lo, hi, True)

        self.master = Master(0)
        # Resolution partition (ref: ResolutionRequestBuilder +
        # resolutionBalancing): N resolvers each own a key-range slice;
        # every proxy clips per resolver and max-merges verdicts. With
        # n_resolvers=1 the single-resolver fast path is used unchanged.
        self.n_proxies = n_proxies
        self.n_resolvers = n_resolvers
        self.resolver_config = None
        if n_resolvers > 1:
            from .resolution import ResolverConfig

            bounds = list(resolver_boundaries or [
                bytes([(256 * i) // n_resolvers])
                for i in range(1, n_resolvers)
            ])
            self.resolver_config = ResolverConfig(bounds)
            self.resolvers = [
                ResolverRole(make_conflict_set(0, device=device), 0,
                             metrics_labels=(("resolver", str(i)),))
                for i in range(n_resolvers)
            ]
        else:
            self.resolvers = [ResolverRole(
                conflict_set if conflict_set is not None
                else make_conflict_set(0, device=device),
                0,
            )]
        self.resolver = self.resolvers[0]
        self.ratekeeper = Ratekeeper(self.log_system, self.storages)
        self.proxies = [
            CommitProxy(
                self.master, self.resolver, tlog=None,
                ratekeeper=self.ratekeeper,
                log_system=self.log_system, shard_map=self.shard_map,
                resolvers=self.resolvers if n_resolvers > 1 else None,
                resolver_config=self.resolver_config,
                metrics_labels=(
                    (("proxy", str(i)),) if n_proxies > 1 else ()
                ),
            )
            for i in range(n_proxies)
        ]
        self.proxy = self.proxies[0]
        # Replicated cluster configuration, maintained from committed \xff
        # mutations (ref: DatabaseConfiguration fed by ApplyMetadataMutation).
        self.config_values: dict[str, str] = {}
        self.excluded: set[int] = set()
        # Version of the newest metadata effect applied to the caches;
        # lets the recovery-time rebuild detect (and retry over) a
        # concurrent commit racing its durable-state read.
        self.metadata_version = 0
        for p in self.proxies:
            p.metadata_hook = self._apply_metadata
        self.dd = None
        self._balancer_task = None
        # One mover at a time across DD and test/ops tooling (ref:
        # moveKeysLock in \xff — cluster-wide by definition).
        from .data_distribution import MoveKeysLock

        self.move_keys_lock = MoveKeysLock()
        self._started = False

    def start(self) -> "ShardedKVCluster":
        assert not self._started
        self._started = True
        # The metrics plane: every role's instruments land on the
        # per-process registry under stable dotted names (proxy/resolver
        # registered themselves at construction; fleets with per-instance
        # identity register here where the index/tag is known).
        from ..core.metrics import global_registry

        reg = global_registry()
        self.log_system.register_metrics(reg)
        for s in self.storages:
            s.register_metrics(reg, labels=(("tag", str(s.tag)),))
            s.start()
        self.ratekeeper.start()
        for p in self.proxies:
            p.start()
        if self.resolver_config is not None:
            self._balancer_task = self._start_balancer(
                self.resolver_config, self.resolvers
            )
        self._router_tasks = self._spawn_log_routers()
        return self

    def _spawn_log_routers(self) -> list:
        """One LogRouter per primary log when a remote set is configured
        (ref: LogRouter.actor.cpp — the remote DC pulls, the commit path
        never waits on it)."""
        from ..core.runtime import TaskPriority, spawn
        from .log_system import LogRouter

        if len(self.log_system.log_sets) < 2:
            return []
        self.log_routers = [
            LogRouter(self.log_system, i)
            for i in range(len(self.log_system.log_sets[0]))
        ]
        return [
            spawn(r.run(), TaskPriority.TLOG_COMMIT, name=f"logRouter{i}")
            for i, r in enumerate(self.log_routers)
        ]

    def _start_balancer(self, config, resolvers):
        """resolutionBalancing's control loop (ref:
        masterserver.actor.cpp:896): periodic load compare + boundary
        move from the busiest resolver's key sample."""
        from ..core.knobs import SERVER_KNOBS
        from ..core.runtime import TaskPriority, current_loop, spawn
        from .resolution import ResolutionBalancer

        self.balancer = ResolutionBalancer(config, resolvers)

        async def run():
            loop = current_loop()
            while True:
                await loop.delay(SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL)
                self.balancer.step(self.master.version)

        return spawn(run(), TaskPriority.DEFAULT, name="resolutionBalance")

    def _apply_metadata(self, m, version: int = 0) -> None:
        """(ref: applyMetadataMutations — interpret committed \\xff writes
        into live config: exclusions + configuration values)."""
        from ..kv.atomic import MutationType
        from .system_data import (
            CONF_PREFIX,
            EXCLUDED_PREFIX,
            decode_config_key,
            decode_excluded_server_key,
        )

        from .system_data import excluded_server_key

        self.metadata_version = max(self.metadata_version, version)
        if m.type == MutationType.SET_VALUE:
            if m.param1.startswith(EXCLUDED_PREFIX):
                self.excluded.add(decode_excluded_server_key(m.param1))
            elif m.param1.startswith(CONF_PREFIX):
                self.config_values[decode_config_key(m.param1)] = (
                    m.param2.decode()
                )
        elif m.type == MutationType.CLEAR_RANGE:
            for t in list(self.excluded):
                if m.param1 <= excluded_server_key(t) < m.param2:
                    self.excluded.discard(t)
            for name in list(self.config_values):
                k = CONF_PREFIX + name.encode()
                if m.param1 <= k < m.param2 and not k.startswith(
                    EXCLUDED_PREFIX
                ):
                    del self.config_values[name]

    def start_data_distribution(self, interval: float = 0.5):
        """Run the DD role against this cluster (ref: dataDistribution,
        DataDistribution.actor.cpp:2045)."""
        from .data_distribution import DataDistributor

        self.dd = DataDistributor(self, interval)
        self.dd.start()
        return self.dd

    def stop(self) -> None:
        if self.dd is not None:
            self.dd.stop()
        if self._balancer_task is not None:
            self._balancer_task.cancel()
        for t in self._router_tasks:
            t.cancel()
        self._router_tasks = []
        for p in self.proxies:
            p.stop()
        self.ratekeeper.stop()
        for s in self.storages:
            s.stop()
        self._started = False

    def database(self):
        from ..client.connection import ShardedConnection
        from ..client.database import Database

        from .recovery import MultiEndpoint

        if len(self.proxies) > 1:
            grv = MultiEndpoint([p.grv_stream for p in self.proxies])
            commit = MultiEndpoint([p.commit_stream for p in self.proxies])
            loc = MultiEndpoint([p.location_stream for p in self.proxies])
        else:
            grv = self.proxy.grv_stream
            commit = self.proxy.commit_stream
            loc = self.proxy.location_stream
        conn = ShardedConnection(
            grv, commit, loc,
            {s.tag: s.read_stream for s in self.storages},
        )
        return Database(self, conn=conn)

    # -- test/DD hooks --
    def move_shard(self, r: KeyRange, new_team: Sequence[int]) -> None:
        """Instant (non-fetching) shard reassignment used by tests; the
        fetchKeys-style copy lives in MoveKeys (data distribution tier)."""
        old_teams = {
            team for _, _, team in self.shard_map.intersecting(r)
        }
        new_team = tuple(sorted(new_team))
        # New members need the data: copy the range at the current applied
        # version from an old member (MoveKeys' fetchKeys equivalent is
        # asynchronous; tests use this synchronous stand-in).
        # Deterministic donor pick: old_teams is a set, and the donor
        # choice must be a pure function of the seed, not PYTHONHASHSEED.
        donor = self.storages[min(old_teams)[0]]
        rows = donor.data.get_range(r.begin, r.end, donor.version.get())
        for t in new_team:
            s = self.storages[t]
            if t not in {m for team in old_teams for m in team}:
                for k, v in rows:
                    s.data.set(k, v, s.version.get())
                    s._log_durable_set(k, v, s.version.get())
            s.set_owned(r.begin, r.end, True)
            s.set_assigned(r.begin, r.end, True)
        for team in sorted(old_teams):
            for t in team:
                if t not in new_team:
                    self.storages[t].set_owned(r.begin, r.end, False)
                    self.storages[t].set_assigned(r.begin, r.end, False)
        self.shard_map.set_team(r, new_team)


def durable_tier_missing(tier: str, option: str) -> str:
    """The refusal of a configuration the port cannot run yet: the
    durable tlog, the storage engines, the simulated disk and the log
    routers' region failover are not ported (ROADMAP Queue 1 item 7)."""
    return (
        f"{tier}({option}=...): the durable tier (durable_tlog, the "
        "storage engines, the simulated disk and region failover) is not "
        "ported, see ROADMAP Queue 1 item 7; the port's clusters run in "
        "memory"
    )


def build_replicas(
    n_storage: int, topology: Optional[dict] = None
) -> list[Replica]:
    """Per-storage localities — one definition shared by the cluster and
    derive_layout so placement stays a pure function of the spec.

    Without a topology this is the historical per-server layout (every
    server its own zone/machine, DCs round-robined by 3). With one, zone
    and machine collapse to the hosting SimMachine: storage i lives on
    machine i % n_machines, machine m in DC m % n_dcs — the shape
    sim/topology.py's shared-fate kills operate on."""
    if topology is None:
        return [
            Replica(
                str(i),
                LocalityData(
                    processid=f"p{i}", zoneid=f"z{i}", machineid=f"m{i}",
                    dcid=f"dc{i % 3}", data_hall=f"h{i % 3}",
                ),
            )
            for i in range(n_storage)
        ]
    n_dcs = int(topology.get("n_dcs", 1))
    n_machines = n_dcs * int(topology.get("machines_per_dc", 3))
    out = []
    for i in range(n_storage):
        m = i % n_machines
        out.append(Replica(
            str(i),
            LocalityData(
                processid=f"p{i}", zoneid=f"m{m}", machineid=f"m{m}",
                dcid=f"dc{m % n_dcs}", data_hall=f"h{m % n_dcs}",
            ),
        ))
    return out


def derive_layout(
    n_storage: int,
    replication: str = "double",
    shard_boundaries: Optional[Sequence[bytes]] = None,
    seed: int = 1,
    topology: Optional[dict] = None,
) -> list[tuple[bytes, bytes, tuple]]:
    """The initial (lo, hi, team) assignment for every shard — a pure
    function of the deployment spec, shared by the in-process cluster and
    the multi-process role hosts (each host derives the same topology
    independently)."""
    policy = policy_for_mode(replication)
    replicas = build_replicas(n_storage, topology)
    rand = DeterministicRandom(seed)
    edges = [b""] + list(shard_boundaries or []) + [KEYSPACE_END]
    out = []
    for lo, hi in zip(edges, edges[1:]):
        sel = policy.select_replicas(replicas, random=rand)
        if sel is None:
            raise ValueError(
                f"replication {replication!r} unsatisfiable with "
                f"{n_storage} storage servers"
            )
        out.append((lo, hi, tuple(sorted(int(r.id) for r in sel))))
    return out


def _all_false_map():
    from ..kv.keyrange_map import KeyRangeMap

    return KeyRangeMap(False)
