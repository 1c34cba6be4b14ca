"""Machine/datacenter fault topology: shared-fate kills over the
simulated cluster (ref: fdbrpc/sim2.actor.cpp — machines own processes
and kills operate on machines, killProcess_internal :1217, killMachine
:1355, killDataCenter :1417; protectedAddresses :358 routes kills around
the coordinators; SimulatedCluster.actor.cpp places roles onto machines
per datacenter).

Before this tier, faults were per-ROLE (kill the transaction system,
reboot one storage server): a resolver and a tlog co-located on a dying
host could never fail TOGETHER, which is exactly the scenario class that
shakes out shared-fate bugs. Here the cluster's components are placed
onto `SimMachine`s grouped into `SimDatacenter`s, and faults operate on
the machines:

- `kill_machine`   blackout every resident process at one instant: the
                   machine's storage servers stop serving and pulling,
                   its network process drops traffic both ways, and any
                   co-resident transaction-system role (or tlog) takes
                   the whole generation down with it.
- `reboot_machine` clean restart (state preserved — sim2's reboot) or
                   POWER-LOSS restart: the machine's un-fsynced disk
                   pages are dropped/kept/corrupted by seeded coin flip
                   (sim/nondurable.py) and its tlog + storage engine are
                   rebuilt from whatever the disk kept, followed by a
                   full recovery (a cold boot IS a recovery).
- `kill_datacenter`every non-protected machine of one DC at one instant.
- swizzle/clogs    sim/network.py's machine-pair, DC-pair and swizzled
                   clogging over the machines' processes.

Placement mirrors cluster/sharded_cluster.build_replicas: storage tag t
lives on machine t % n_machines, machine m in DC m % n_dcs, and zone ==
machine — so the replication policy has already spread every team across
machines and a single machine kill can never eat a whole team. Tlog i
shares machine i % n_machines with its storage neighbour (deliberate
shared fate); the per-generation transaction roles live on one machine
and are re-placed onto a live machine by each recovery; coordinators sit
on the last machine of each DC and make those machines PROTECTED — the
analogue of sim2's protectedAddresses, which kills must route around.

In-process limits (documented, not hidden): role-to-role traffic does
not cross the SimNetwork (the reference's intra-machine traffic is
near-free too), so clogs and swizzles act on the client<->cluster hops.
A killed tlog keeps its in-memory state but goes DARK (reachable=False):
it can neither join the fsync quorum nor serve peeks, so under k-way
log replication the epoch-end quorum excludes it (k-1 budget) and a
primary-DC blackout arms the two-region failover; only when the dark
set exceeds what the mode covers does lock() fall back to the
in-process blackout shortcut (state addressable, trace-logged). True
STATE loss is exercised by the power-loss reboots here and the
destroyed-datadir tests of the log-replication tier.

The port's copy of foundationdb_tpu/sim/topology.py. A re-homed storage
server is rebuilt on the cluster's device (`cluster.device`: its window is
the knob-chosen KeyValueStoreGPU or VersionedMap, as at boot). The durable
tier is not ported: a cluster with a datadir never reaches this module
(the clusters refuse one), and the durable branches of the log and
storage rebuilds and of the power-loss reboot raise NotImplementedError
naming ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..cluster.recruitment import (
    RecruitmentStalled,
    WorkerInfo,
    WorkerRegistry,
    select_replacement_hosts,
    select_workers,
)
from ..cluster.sharded_cluster import durable_tier_missing
from ..core.actors import ActorCollection
from ..core.errors import OperationFailed
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import TaskPriority, current_loop, spawn
from ..core.trace import TraceEvent
from .network import SimNetwork, SimProcess


class SimMachine:
    """One failure domain: a set of processes that die at one instant
    (ref: sim2's MachineInfo — processes, machineId, and the machine-wide
    kill entry points)."""

    def __init__(self, index: int, dc: "SimDatacenter"):
        self.index = index
        self.name = f"m{index}"
        self.dc = dc
        self.proc = SimProcess(self.name)
        self.storage_tags: list[int] = []
        self.log_ids: list[int] = []
        # Remote (second-DC) log set indices, two-region clusters only:
        # fed by the LogRouters, never on the commit path until failover.
        self.remote_log_ids: list[int] = []
        self.has_txn = False
        self.coordinator_ids: list[int] = []
        self.alive = True
        self.kills = 0
        # Operator lifecycle (move-machine): `draining` marks a LIVE
        # machine whose durable roles are being re-recruited elsewhere
        # (its logs become donors of last resort — zero-loss demotion);
        # `retired` is the terminal state: role-free, forgotten by the
        # registry, never placed again and never restored.
        self.draining = False
        self.retired = False

    @property
    def protected(self) -> bool:
        """Machines hosting coordinators are never killed (ref: sim2's
        protectedAddresses — the simulator must not destroy the quorum
        that arbitrates recovery)."""
        return bool(self.coordinator_ids)

    @property
    def process_class(self) -> str:
        """The machine's process class for fitness ranking, derived from
        its STATEFUL residents (ref: SimulatedCluster assigning machine
        classes): log machines rank as transaction-class hardware,
        storage machines as storage, and role-free machines are unset —
        the class the ranker prefers for stateless recruits."""
        if self.log_ids or self.remote_log_ids:
            return "log"
        if self.storage_tags:
            return "storage"
        return "unset"

    def __repr__(self):
        roles = []
        if self.storage_tags:
            roles.append(f"storage{self.storage_tags}")
        if self.log_ids:
            roles.append(f"log{self.log_ids}")
        if self.has_txn:
            roles.append("txn")
        if self.coordinator_ids:
            roles.append("coord")
        return (f"SimMachine({self.name}@{self.dc.name}, "
                f"{'+'.join(roles) or 'idle'}, "
                f"{'up' if self.alive else 'DOWN'})")


class SimDatacenter:
    def __init__(self, index: int):
        self.index = index
        self.name = f"dc{index}"
        self.machines: list[SimMachine] = []

    def __repr__(self):
        return f"SimDatacenter({self.name}, {len(self.machines)} machines)"


class _RoutedStream:
    """A stream endpoint viewed across the simulated network with a
    LATE-BOUND destination: the transaction system migrates to a new
    machine on every recovery, so the client's grv/commit hop must
    resolve its destination per send (the RemoteStream contract
    otherwise — request forwarded through the network, reply relayed
    back the same way)."""

    def __init__(self, net: SimNetwork, src: SimProcess, dst_fn, stream_fn):
        self.net = net
        self.src = src
        self.dst_fn = dst_fn
        self.stream_fn = stream_fn

    def send(self, req) -> None:
        from ..core.runtime import Promise

        dst = self.dst_fn()
        stream = self.stream_fn()
        client_reply = req.reply
        server_req = replace(req, reply=Promise())

        def relay_back(f):
            def complete():
                if client_reply.is_set():
                    return
                if f.is_error():
                    client_reply.send_error(f._value)
                else:
                    client_reply.send(f._value)

            self.net.deliver(dst, self.src, complete)

        server_req.reply.future.add_callback(relay_back)
        self.net.deliver(self.src, dst, lambda: stream.send(server_req))


class MachineTopology:
    """The machine/DC layout of one simulated cluster plus the fault
    arsenal that exploits it. Built by workloads/tester.run_spec when the
    cluster spec carries a "topology" stanza; all randomness flows from
    the deterministic loop PRNG, so the same seed replays the same kill
    schedule."""

    def __init__(self, cluster, n_dcs: int = 1, machines_per_dc: int = 3,
                 net: Optional[SimNetwork] = None, disk=None,
                 engine: str = "memory"):
        self.cluster = cluster
        self.net = net if net is not None else SimNetwork()
        self.disk = disk            # NonDurableOS when power loss is in play
        self.engine_kind = engine
        self.n_dcs = int(n_dcs)
        self.machines_per_dc = int(machines_per_dc)
        self.client_proc = SimProcess("client")
        self.protected_kill_attempts = 0

        self.dcs = [SimDatacenter(d) for d in range(self.n_dcs)]
        n_machines = self.n_dcs * self.machines_per_dc
        self.machines = []
        for m in range(n_machines):
            dc = self.dcs[m % self.n_dcs]
            machine = SimMachine(m, dc)
            dc.machines.append(machine)
            self.machines.append(machine)

        # -- role placement (must mirror build_replicas for storages) --
        for t in range(len(cluster.storages)):
            self.machines[t % n_machines].storage_tags.append(t)
        # Log placement mirrors log_system.log_replicas' homes exactly —
        # the policy spread the replicas across THESE machines, so a
        # machine kill takes out precisely the replicas placed on it.
        # Two-region clusters confine the primary set to DC0's machines
        # and the remote set to DC1's (log_replicas with dc=0/1).
        log_sets = getattr(cluster.log_system, "log_sets", None)
        regions = log_sets is not None and len(log_sets) > 1
        if regions:
            for d, attr in ((0, "log_ids"), (1, "remote_log_ids")):
                dc_machines = [m for m in range(n_machines)
                               if m % self.n_dcs == d]
                for i in range(len(log_sets[d])):
                    getattr(self.machines[dc_machines[i % len(dc_machines)]],
                            attr).append(i)
        else:
            for i in range(len(cluster.log_system.logs)):
                self.machines[i % n_machines].log_ids.append(i)
        # Coordinators on the LAST machine of each DC (wrapping): spread
        # across failure domains, away from the low-index machines that
        # host the killable roles. Small fleets CO-LOCATE coordinators
        # instead of spreading — protecting all but one machine would
        # leave the nemesis nothing to kill (the reference's simulated
        # clusters likewise bound protectedAddresses to a machine subset).
        coords = getattr(cluster, "coordinators", [])
        if coords:
            n_protected = min(len(coords), max(1, n_machines - 2))
            slots: list[SimMachine] = []
            k = 0
            while len(slots) < n_protected and k < 4 * n_machines:
                dc = self.dcs[k % self.n_dcs]
                m = dc.machines[-1 - (k // self.n_dcs) % len(dc.machines)]
                if m not in slots:
                    slots.append(m)
                k += 1
            for ci in range(len(coords)):
                slots[ci % len(slots)].coordinator_ids.append(ci)
        # Worker registry + per-machine heartbeat actors: the SAME
        # lease machinery the multiprocess controller recruits through
        # (cluster/recruitment.py), so the heartbeat/lease knobs are
        # exercised under simulation. Machine liveness stays the instant
        # truth for placement (m.alive); a lapsed lease only DEMOTES a
        # candidate (penalty), mirroring the reference preferring
        # recently-heard-from workers.
        self.registry = WorkerRegistry()
        self._tasks = ActorCollection()
        self.registry.start()
        for m in self.machines:
            self._tasks.add(spawn(
                self._machine_heartbeat(m), TaskPriority.COORDINATION,
                name=f"workerBeat:{m.name}",
            ))
        # Durable-role re-homing state: a recruited replacement takes
        # over the dead replica's SLOT (tag/log index — routing is a pure
        # function of the spec and never changes), so the physical
        # placement must be tracked separately from the derived layout.
        self._storage_homes: dict[int, SimMachine] = {}
        self._log_paths: dict[int, str] = {}
        self._storage_paths: dict[int, str] = {}
        self._rehomes = 0
        # The storage tracker: watches for storage machines dead past
        # their lease, drives DD's team re-seeding off them, and recruits
        # replacement hosts once drained (the reference's teamTracker +
        # the controller's storage recruitment, merged at machine grain).
        self._tasks.add(spawn(
            self._storage_tracker(), TaskPriority.DEFAULT,
            name="storageTracker",
        ))
        # Commit-plane wedge detection for the health probe: a push that
        # can never reach its fsync quorum (dark log, host lease lapsed,
        # replacement possible) must read as UNHEALTHY even though the
        # proxy answers every probe with a crisp TLogFailed.
        cluster._wedge_probe = self._durable_wedge_probe
        # Per-generation transaction roles are PLACED by the shared
        # fitness ranker at boot and re-placed by every recovery (hook
        # below) — the recruited-topology replacement of the historical
        # "lowest-index live machine" rule.
        self.txn_machine = self.machines[0]
        self._place_txn_roles()
        self._install_recovery_hook()
        TraceEvent("SimTopologyBuilt").detail("Machines", n_machines).detail(
            "DCs", self.n_dcs
        ).detail(
            "Protected", sum(1 for m in self.machines if m.protected)
        ).log()

    async def _machine_heartbeat(self, m: SimMachine) -> None:
        """The worker registration loop (ref: worker.actor.cpp:481
        registrationClient): while the machine is up it re-registers on
        the heartbeat interval; a killed machine stops beating and its
        lease lapses in the registry."""
        loop = current_loop()
        while True:
            if m.alive and not m.retired:
                self.registry.register(
                    m.name, process_class=m.process_class,
                    machine_id=m.name, dc=m.dc.index, index=m.index,
                    penalty=1 if m.protected else 0,
                )
            await loop.delay(
                SERVER_KNOBS.WORKER_HEARTBEAT_INTERVAL
                * (0.75 + 0.5 * loop.random.random01())
            )

    # -- wiring --
    def _install_recovery_hook(self) -> None:
        cluster = self.cluster
        orig = getattr(cluster, "_recover", None)
        if orig is None:
            return

        def recover_and_place():
            # Durable-role healing FIRST: a dead-past-its-lease (or
            # draining) log host is replaced by a recruited machine and
            # the survivors' tail re-replicated onto it BEFORE the epoch
            # end, so lock() sees a whole, reachable quorum. A stalled
            # replacement raises RecruitmentStalled and the controller
            # parks the recovery (recruiting_log in status json).
            self._replace_dead_logs()
            orig()
            self._place_txn_roles()

        cluster._recover = recover_and_place

    def _place_txn_roles(self) -> None:
        """Each recovery recruits the new generation's txn-role bundle
        onto the best-fitness LIVE machine via the SHARED ranker
        (cluster/recruitment.select_workers — the same code path the
        multiprocess controller recruits by, so the tiers cannot
        diverge): role-free machines beat storage/log machines,
        lease-stale and protected machines are demoted, and ties break
        by (dc, machine index) — never by container order. No live
        machine ⇒ a named ``recruiting_transaction`` stall recorded in
        the registry (status json shows it) and resumed by
        restore_machine, mirroring the multiprocess parked recovery."""
        for m in self.machines:
            m.has_txn = False
        candidates = [
            WorkerInfo(
                worker_id=m.name, process_class=m.process_class,
                machine_id=m.name, dc=m.dc.index, index=m.index,
                # Demotions within a fitness tier: stale lease worst,
                # then coordinator (protected) machines, then tlog
                # machines — co-locating the bundle with a tlog couples
                # the generation to the one failure domain whose
                # PERMANENT loss wedges the commit path (a dark log
                # stalls every push until it returns).
                penalty=(2 if not self.registry.is_live(m.name) else 0)
                + (1 if m.protected else 0)
                + (1 if (m.log_ids or m.remote_log_ids) else 0),
            )
            for m in self.machines
            if m.alive and not m.retired and not m.draining
        ]
        got = select_workers(candidates, "transaction", 1)
        if not got:
            # Parked: the old txn machine keeps the routing slot (dead —
            # clients stall on their retry loops) until a machine comes
            # back and restore_machine re-places.
            self.registry.note_stall("transaction", detail="no live machine")
            return
        target = next(m for m in self.machines
                      if m.name == got[0].worker_id)
        target.has_txn = True
        self.txn_machine = target
        self.registry.note_resumed("transaction")
        TraceEvent("SimTxnRolesPlaced").detail(
            "Machine", target.name
        ).detail("Class", target.process_class).log()

    def machine_of_tag(self, tag: int) -> SimMachine:
        home = self._storage_homes.get(tag)
        if home is not None:
            return home
        return self.machines[tag % len(self.machines)]

    def _log_home(self, index: int) -> Optional[SimMachine]:
        for m in self.machines:
            if index in m.log_ids:
                return m
        return None

    # -- durable-role re-recruitment (ref: the reference recruiting tlogs
    #    onto any TransactionClass worker and re-replicating at epoch
    #    end, and DD re-seeding storage teams; here at machine grain,
    #    through the SAME ranker the multiprocess controller uses) --
    def _durable_wedge_probe(self) -> bool:
        """True when the commit path is wedged on a dark log whose host
        is dead PAST ITS LEASE (or draining) and re-recruitment can
        actually fix it — the trigger that turns the health probe's
        crisp-but-useless TLogFailed replies into a recovery."""
        ls = self.cluster.log_system
        log_sets = getattr(ls, "log_sets", None)
        if log_sets is None or len(log_sets) > 1:
            return False  # regions: the remote-set failover owns this
        if getattr(ls, "rep_factor", 1) < 2:
            return False  # single replication: replacement == data loss
        for i, log in enumerate(ls.logs):
            if getattr(log, "reachable", True):
                continue
            host = self._log_home(i)
            if host is None:
                continue
            if (host.draining or not self.registry.is_live(host.name)) \
                    and self._rebuild_covered(i):
                return True
        return False

    def _rebuild_covered(self, index: int) -> bool:
        """True iff replacing log `index` loses nothing: every tag
        destined to the slot has a REACHABLE donor replica (or the slot's
        own copy is live — a drain). An uncovered rebuild would seed an
        EMPTY replica whose zeroed durable cursor the next epoch-end
        could count once the dark peers consume the exclusion budget —
        computing a recovery version below every acked write and rolling
        the whole cluster back to nothing (found by seed sweep: two log
        machines dead at once, the first replaced while the second was
        its only donor)."""
        ls = self.cluster.log_system
        serving = ls.logs
        if getattr(serving[index], "reachable", True):
            return True  # draining a live copy: it donates itself
        for t in sorted(ls._registered_tags):
            rs = ls.replica_set_for_tag(t)
            if index not in rs:
                continue
            if not any(
                i != index and i < len(serving)
                and getattr(serving[i], "reachable", True)
                for i in rs
            ):
                return False
        return True

    def _replace_dead_logs(self) -> None:
        """Re-recruit every serving log whose host is draining or dead
        past its lease: a replacement machine is ranked by the shared
        ranker, a fresh log is built on it, and the surviving replicas'
        tail is re-replicated (log_system.rebuild_log). Dark logs still
        inside their lease only record the named stall — a blip is waited
        out, exactly like the reference's failure-detection horizon."""
        cluster = self.cluster
        ls = cluster.log_system
        log_sets = getattr(ls, "log_sets", None)
        if log_sets is None or len(log_sets) > 1:
            return
        replaced = waiting = 0
        for i in range(len(ls.logs)):
            log = ls.logs[i]
            host = self._log_home(i)
            draining = host is not None and host.draining
            dark = not getattr(log, "reachable", True)
            if not (draining or dark):
                continue
            if dark and not draining:
                if getattr(ls, "rep_factor", 1) < 2:
                    # Replacement under single log replication cannot
                    # invent the lost copy: stay wedged until the host
                    # returns (the destroyed-datadir contract).
                    continue
                if host is not None and self.registry.is_live(host.name):
                    # Dark inside its lease: a blip, not a death. Record
                    # WHY recovery is parked so status/cli name the wait.
                    self.registry.note_stall(
                        "log", awaiting=host.name, candidates=None,
                        detail=f"log{i} host {host.name} dark inside "
                               "its lease",
                    )
                    waiting += 1
                    continue
                if not self._rebuild_covered(i):
                    # A rebuild with no reachable donor for some destined
                    # tag would seed an EMPTY replica that can poison the
                    # epoch-end quorum (recovery version 0 == total
                    # rollback). Keep the dark copy — its in-process
                    # state is still addressable (kill == blackout) and
                    # the peers' return is what heals this.
                    self.registry.note_stall(
                        "log", awaiting="a reachable donor replica",
                        candidates=None,
                        detail=f"log{i} dead but some destined tag has "
                               "no reachable donor; replacement would "
                               "lose acked writes",
                    )
                    waiting += 1
                    continue
            target = self._recruit_log_host(i, host)
            fresh = self._build_replacement_log(i, target)
            old = ls.rebuild_log(i, fresh)
            if hasattr(old, "stop"):
                old.stop()
            if host is not None and i in host.log_ids:
                host.log_ids.remove(i)
            target.log_ids.append(i)
            fresh.reachable = target.alive
            replaced += 1
            TraceEvent("SimLogRehomed").detail("Log", i).detail(
                "From", host.name if host else "?"
            ).detail("To", target.name).log()
        if replaced and not waiting:
            self.registry.note_resumed("log")

    def _recruit_log_host(self, index: int, dead: Optional[SimMachine]
                          ) -> SimMachine:
        """Rank a replacement machine for log slot `index`. Machines
        already hosting any log replica are excluded outright (one
        machine must never hold two copies the policy placed apart), as
        are protected (coordinator) machines — the quorum's failure
        domain never hosts killable durable state."""
        exclude = {m.name for m in self.machines
                   if m.log_ids or m.remote_log_ids}
        if dead is not None:
            exclude.add(dead.name)
        candidates = [
            WorkerInfo(
                worker_id=m.name, process_class=m.process_class,
                machine_id=m.name, dc=m.dc.index, index=m.index,
                penalty=(2 if not self.registry.is_live(m.name) else 0)
                + (1 if m.has_txn else 0),
            )
            for m in self.machines
            if m.alive and not m.retired and not m.draining
            and not m.protected
        ]
        got = select_replacement_hosts(candidates, "log", 1,
                                       exclude_machines=exclude)
        if not got:
            self.registry.note_stall(
                "log", awaiting="log-class worker", candidates=0,
                detail=f"log{index} host dead; no replacement machine "
                       "registered",
            )
            raise RecruitmentStalled(
                "log", f"no replacement machine for log{index}"
            )
        return next(m for m in self.machines
                    if m.name == got[0].worker_id)

    def _build_replacement_log(self, index: int, target: SimMachine):
        cluster = self.cluster
        if getattr(cluster, "datadir", None):
            raise NotImplementedError(
                durable_tier_missing("MachineTopology", "datadir"))
        from ..cluster.log_system import TaggedTLog

        return TaggedTLog(0)

    async def _storage_tracker(self) -> None:
        """Watch for storage machines dead past their lease: feed DD's
        team machinery (mark_failed -> existing move_keys re-seeding off
        the dead replicas), then — once the dead tag holds no shard —
        recruit a replacement host and rebuild the server there so the
        replica slot returns to service. Stalls are named, bounded-retry
        (next tick), and drain when a machine registers."""
        from ..core.errors import ActorCancelled

        loop = current_loop()
        while True:
            await loop.delay(
                SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL
                * (0.8 + 0.4 * loop.random.random01())
            )
            try:
                self._heal_dead_storage()
            except RecruitmentStalled:
                pass  # stall recorded; re-ranked next tick
            except (ActorCancelled, GeneratorExit):
                raise
            except BaseException as e:  # noqa: BLE001 — tracker survives
                TraceEvent("StorageTrackerError", severity=30).error(e).log()

    def _heal_dead_storage(self) -> None:
        dd = getattr(self.cluster, "dd", None)
        if dd is None:
            return
        pending: list[tuple[int, SimMachine]] = []
        for m in self.machines:
            if m.alive or m.retired:
                continue
            if self.registry.is_live(m.name):
                continue  # inside its lease: a blip, not a death
            for t in sorted(m.storage_tags):
                pending.append((t, m))
        if not pending:
            if "storage" in self.registry.stalls:
                self.registry.note_resumed("storage")
            return
        for t, _m in pending:
            dd.mark_failed(t)
        for t, m in pending:
            if any(t in team
                   for _b, _e, team in self.cluster.shard_map.ranges()):
                # DD is still re-seeding this tag's shards onto live
                # teams; the replacement waits for the drain.
                self.registry.note_stall(
                    "storage", awaiting=f"tag {t} drain",
                    candidates=None,
                    detail=f"storage {t} dead on {m.name}; teams "
                           "re-seeding",
                )
                continue
            self._rehome_storage(t, m)

    def _rehome_storage(self, tag: int, dead: SimMachine) -> None:
        from ..cluster.sharded_cluster import _all_false_map
        from ..cluster.storage import StorageServer

        cluster = self.cluster
        candidates = [
            WorkerInfo(
                worker_id=m.name, process_class=m.process_class,
                machine_id=m.name, dc=m.dc.index, index=m.index,
                penalty=(2 if not self.registry.is_live(m.name) else 0)
                + (1 if (m.log_ids or m.remote_log_ids) else 0)
                + (1 if m.has_txn else 0),
            )
            for m in self.machines
            if m.alive and not m.retired and not m.draining
            and not m.protected
        ]
        got = select_replacement_hosts(candidates, "storage", 1,
                                       exclude_machines={dead.name})
        if not got:
            self.registry.note_stall(
                "storage", awaiting=f"storage-class worker (tag {tag})",
                candidates=0,
                detail=f"storage {tag} drained; no replacement machine",
            )
            raise RecruitmentStalled(
                "storage", f"no replacement machine for storage {tag}"
            )
        target = next(m for m in self.machines
                      if m.name == got[0].worker_id)
        old = cluster.storages[tag]
        if getattr(cluster, "datadir", None):
            raise NotImplementedError(
                durable_tier_missing("MachineTopology", "datadir"))
        fresh = StorageServer(cluster.log_system.tag_view(tag), 0,
                              tag=tag, device=cluster.device)
        # Clients keep their endpoint (the reference's interface tokens
        # survive role restarts); ownership starts EMPTY — DD's move_keys
        # seeds data in with a proper fence+snapshot fetch when a team
        # next includes this replica.
        fresh.read_stream = old.read_stream
        fresh.owned = _all_false_map()
        fresh.assigned = _all_false_map()
        cluster.storages[tag] = fresh
        fresh.start()
        if tag in dead.storage_tags:
            dead.storage_tags.remove(tag)
        target.storage_tags.append(tag)
        self._storage_homes[tag] = target
        dd = getattr(cluster, "dd", None)
        if dd is not None:
            dd.mark_healthy(tag)
        self.registry.note_resumed("storage")
        TraceEvent("SimStorageRehomed").detail("Tag", tag).detail(
            "From", dead.name
        ).detail("To", target.name).log()

    def retire_machine(self, m: SimMachine) -> None:
        """Terminal step of a machine drain: the machine must already be
        role-free (storage excluded + drained, logs demoted, txn bundle
        re-placed). Forgotten by the registry, never placed or restored
        again — the operator can power it off."""
        if m.protected:
            raise OperationFailed(
                f"machine {m.name} hosts coordinators; move the "
                "coordination quorum first"
            )
        if (m.storage_tags or m.log_ids or m.remote_log_ids
                or m.has_txn):
            raise OperationFailed(
                f"machine {m.name} still hosts roles "
                f"(storage={m.storage_tags} logs={m.log_ids} "
                f"txn={m.has_txn}); drain before retiring"
            )
        m.retired = True
        m.draining = False
        self.registry.forget(m.name)
        TraceEvent("SimMachineRetired").detail("Machine", m.name).log()

    def machines_status(self) -> list[dict]:
        """Per-machine placement + lifecycle for status json: which
        roles each failure domain hosts right now (re-homed slots
        included), and whether its registry lease is live."""
        return [
            {
                "machine": m.name,
                "dc": m.dc.name,
                "alive": m.alive,
                "retired": m.retired,
                "draining": m.draining,
                "protected": m.protected,
                "storage_tags": sorted(m.storage_tags),
                "logs": sorted(m.log_ids),
                "remote_logs": sorted(m.remote_log_ids),
                "txn": m.has_txn,
                "live_lease": self.registry.is_live(m.name),
            }
            for m in self.machines
        ]

    def database(self):
        """A client database whose every hop crosses the SimNetwork from
        the client's process to the destination machine's process — so
        machine blackouts, clogs and swizzles act on real traffic (the
        role endpoints are already streams; only the transport changes)."""
        from ..client.connection import ShardedConnection
        from ..client.database import Database

        cluster = self.cluster
        if not hasattr(cluster, "grv_ref"):
            raise ValueError(
                "MachineTopology.database() needs a recoverable cluster "
                "(EndpointRefs to follow recoveries)"
            )
        route = lambda dst_fn, stream_fn: _RoutedStream(  # noqa: E731
            self.net, self.client_proc, dst_fn, stream_fn
        )
        txn_proc = lambda: self.txn_machine.proc  # noqa: E731
        conn = ShardedConnection(
            route(txn_proc, lambda: cluster.grv_ref),
            route(txn_proc, lambda: cluster.commit_ref),
            route(txn_proc, lambda: cluster.location_ref),
            {
                s.tag: route(
                    lambda t=s.tag: self.machine_of_tag(t).proc,
                    lambda t=s.tag: cluster.storages[t].read_stream,
                )
                for s in cluster.storages
            },
        )
        return Database(cluster, conn=conn)

    # -- quorum safety --
    def can_kill(self, machines) -> bool:
        """True iff killing `machines` (on top of the already-dead ones)
        stays inside what the configured replication mode can survive:
        every shard team keeps at least one live replica, and at least
        one machine stays up to host the re-recruited transaction roles.
        The attrition nemesis gates every kill on this — the simulator
        must drive the cluster to the edge, never over it."""
        dead = {m.index for m in self.machines if not m.alive or m.retired}
        dead |= {m.index for m in machines}
        if all(m.index in dead for m in self.machines):
            return False
        for _b, _e, team in self.cluster.shard_map.ranges():
            # Placement via machine_of_tag, not t % n: a re-homed
            # replica's quorum safety follows its CURRENT machine.
            if team and all(self.machine_of_tag(t).index in dead
                            for t in team):
                return False
        return True

    def killable_machines(self) -> list[SimMachine]:
        return [
            m for m in self.machines
            if m.alive and not m.protected and not m.retired
            and self.can_kill([m])
        ]

    # -- the fault arsenal --
    def kill_machine(self, m: SimMachine, force: bool = False) -> bool:
        """Shared-fate blackout of one machine: every resident process
        goes dark AT ONE INSTANT (no awaits between component stops).
        Returns False (and does nothing) for protected machines or kills
        the replication mode could not survive."""
        if m.protected:
            self.protected_kill_attempts += 1
            TraceEvent("SimKillRefusedProtected").detail(
                "Machine", m.name
            ).log()
            return False
        if not m.alive:
            return False
        if not force and not self.can_kill([m]):
            TraceEvent("SimKillRefusedQuorum").detail("Machine", m.name).log()
            return False
        self._blackout(m)
        return True

    def _blackout(self, m: SimMachine) -> None:
        m.alive = False
        m.kills += 1
        self.net.blackout(m.proc)
        for t in m.storage_tags:
            self.cluster.storages[t].stop()
        # Resident logs go DARK: they can neither join the fsync quorum
        # (push stalls/fails rather than silently shedding a copy) nor
        # serve peeks; under k-way replication the epoch-end quorum
        # excludes them (log_system.lock's k-1 budget), and a primary-DC
        # blackout is what arms the region failover.
        self._set_logs_reachable(m, False)
        if m.has_txn or m.log_ids:
            # Co-resident transaction-system roles die with the machine —
            # the shared-fate instant per-role kills could never produce.
            # (A resident tlog keeps its state — kill == blackout — but
            # its loss of service takes the generation down; recovery
            # fences and continues, the reference's machine-reboot path.)
            self.cluster.kill_transaction_system()
        TraceEvent("SimMachineKilled", severity=30).detail(
            "Machine", m.name
        ).detail("DC", m.dc.name).detail(
            "Storages", len(m.storage_tags)
        ).detail("Logs", len(m.log_ids)).detail(
            "Txn", m.has_txn
        ).log()

    def _set_logs_reachable(self, m: SimMachine, up: bool) -> None:
        log_sets = getattr(self.cluster.log_system, "log_sets", None)
        if log_sets is None:
            return
        for i in m.log_ids:
            log_sets[0][i].reachable = up
        if len(log_sets) > 1:
            for i in m.remote_log_ids:
                log_sets[1][i].reachable = up

    def restore_machine(self, m: SimMachine) -> None:
        if m.alive or m.retired:
            return
        m.alive = True
        self.net.restore(m.proc)
        for t in m.storage_tags:
            self.cluster.storages[t].start()
        self._set_logs_reachable(m, True)
        # The sim analogue of a worker registering with the controller:
        # a PARKED recruitment resumes the instant a machine comes back.
        self.registry.register(
            m.name, process_class=m.process_class, machine_id=m.name,
            dc=m.dc.index, index=m.index, penalty=1 if m.protected else 0,
        )
        # Its storage replicas (if not already re-homed) are healthy
        # again: re-admit them before DD moves yet more data around.
        dd = getattr(self.cluster, "dd", None)
        if dd is not None:
            for t in sorted(m.storage_tags):
                dd.mark_healthy(t)
        if "log" in self.registry.stalls and not any(
            not getattr(log, "reachable", True)
            for log in self.cluster.log_system.logs
        ):
            # The dark-log wait drained by the host coming back (no
            # replacement happened): clear the named stall.
            self.registry.note_resumed("log")
        if self.registry.stalls:
            self._place_txn_roles()
        TraceEvent("SimMachineRestored").detail("Machine", m.name).log()

    async def reboot_machine(self, m: SimMachine, outage: float = 0.2,
                             power_loss: bool = False) -> bool:
        """Restart one machine. Clean reboot preserves all state (sim2's
        RebootProcess); power-loss reboot first resolves the machine's
        un-fsynced disk pages by seeded coin flip and rebuilds its tlog
        and storage engines from whatever survived, then runs a full
        recovery — the in-run equivalent of the kill -9 + cold boot the
        restart specs exercise across incarnations."""
        if not self.kill_machine(m):
            return False
        loop = current_loop()
        await loop.delay(outage)
        if power_loss and self.disk is not None:
            self._power_loss(m)
        self.restore_machine(m)
        return True

    def _power_loss(self, m: SimMachine) -> None:
        """Power loss resolves the machine's un-fsynced pages on the
        simulated disk and rebuilds its durable tlog and storage engines:
        the durable tier, which the port does not have yet."""
        raise NotImplementedError(
            durable_tier_missing("MachineTopology", "power_loss"))

    def kill_datacenter(self, dc: SimDatacenter) -> list[SimMachine]:
        """Blackout every non-protected machine of one DC at one instant
        (ref: killDataCenter, sim2.actor.cpp:1417). Returns the machines
        actually killed ([] when the quorum-safety gate refuses)."""
        victims = [m for m in dc.machines if m.alive and not m.protected]
        if not victims or not self.can_kill(victims):
            TraceEvent("SimDcKillRefused").detail("DC", dc.name).log()
            return []
        for m in victims:
            self._blackout(m)
        TraceEvent("SimDcKilled", severity=30).detail("DC", dc.name).detail(
            "Machines", len(victims)
        ).log()
        return victims

    # -- network faults at machine/DC granularity --
    def clog_machine_pair(self, a: SimMachine, b: SimMachine,
                          seconds: float) -> None:
        self.net.clog_pair_sets([a.proc], [b.proc], seconds)

    def clog_dc_pair(self, a: SimDatacenter, b: SimDatacenter,
                     seconds: float) -> None:
        self.net.clog_pair_sets(
            [m.proc for m in a.machines], [m.proc for m in b.machines],
            seconds,
        )

    async def swizzle(self, random, max_clog: float = 1.0) -> None:
        """Swizzled clogging over the machines (sim2's swizzled clog):
        clog a random machine subset's links, unclog in random order."""
        await self.net.swizzle_clog(
            [[m.proc] for m in self.machines], random, max_clog
        )
