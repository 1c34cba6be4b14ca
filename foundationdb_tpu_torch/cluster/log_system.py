"""Tag-partitioned log system (ref:
fdbserver/TagPartitionedLogSystem.actor.cpp; tags fdbclient/FDBTypes.h:36-67).

Every mutation is stamped at the proxy with the TAGS of the storage
servers that must apply it (one tag per storage server). `push` (:339)
routes each mutation to a REPLICATION-POLICY-SELECTED set of tlogs per
tag — the primary `tag % n_logs` (the reference's bestLocationFor) plus
enough policy-distinct (locality-aware) replicas to satisfy the
configured log replication mode — and a commit is durable only when the
full fsync quorum has made its slice durable (the reference's push with
tLogWriteAntiQuorum 0 waits every pushed log; every log receives every
version, empty or not, so each log's (prevVersion -> version] chain
stays contiguous).

Under `double`/`triple` log replication each mutation therefore lives on
k >= 2 logs in distinct failure domains, and the epoch-end recovery
version is computed from a QUORUM of the locked logs (the k-1 worst
durable cursors are excludable): a permanently destroyed log datadir
loses nothing acked, because every acked version is durable on at least
one surviving replica of each of its tags, and `TagView` peek fails over
between a tag's replicas when one log cannot serve the cursor.

Storage servers peek ONLY their tag (`peek` :362 builds per-tag cursors)
and pop their tag as they persist (`pop` :458) on EVERY replica; a log
discards a version once every tag hosted on it has popped past it.

Two-DC regions: an optional REMOTE log set (second DC) is fed
asynchronously by LogRouter-style pullers (ref: fdbserver/
LogRouter.actor.cpp:1-391) that tail the primary logs' durable streams
1:1. Commits ack on the primary quorum alone; `lock` fails over to the
remote set when the primary set is unreachable AND the routers have
shipped everything acked (so failover never strands an acked write —
the gate the reference gets from known-committed-version tracking).

Recovery: `lock(epoch)` fences the serving logs and returns the quorum
recovery version (ref: epochEnd :107 computes exactly this from the
lock replies).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.actors import all_of
from ..core.errors import OperationFailed, TLogFailed, TLogStopped
from ..core.knobs import SERVER_KNOBS
from ..core.rand import DeterministicRandom
from ..core.trace import TraceEvent
from .interfaces import Mutation
from .replication import LocalityData, Replica, policy_for_mode
from .tlog import MemoryTLog

# Pseudo-tag pinning each primary log's discard horizon at the log
# routers' shipping cursor (the reference's router tags serve the same
# purpose on the tag-partitioned log).
ROUTER_TAG = -1


@dataclass(frozen=True)
class TaggedMutation:
    """(ref: the per-mutation tag vector LogPushData writes,
    MasterProxyServer.actor.cpp phase 3 tag assignment)."""

    tags: tuple  # tuple[int, ...] — destination storage tags
    mutation: Mutation


def log_replicas(
    n_logs: int, topology: Optional[dict] = None, dc: Optional[int] = None
) -> list[Replica]:
    """Locality of each tlog, mirroring sharded_cluster.build_replicas'
    zone==machine model so the replication policy spreads log replicas
    across the same failure domains machine kills operate on. With `dc`
    set, logs are confined to that datacenter's machines (the two-region
    layout: the primary set lives in DC0, the remote set in DC1)."""
    if topology is None:
        return [
            Replica(
                str(i),
                LocalityData(
                    processid=f"lp{i}", zoneid=f"z{i}", machineid=f"m{i}",
                    dcid=f"dc{i % 3}", data_hall=f"h{i % 3}",
                ),
            )
            for i in range(n_logs)
        ]
    n_dcs = int(topology.get("n_dcs", 1))
    n_machines = n_dcs * int(topology.get("machines_per_dc", 3))
    if dc is None:
        homes = [i % n_machines for i in range(n_logs)]
    else:
        dc_machines = [m for m in range(n_machines) if m % n_dcs == dc]
        homes = [dc_machines[i % len(dc_machines)] for i in range(n_logs)]
    return [
        Replica(
            str(i),
            LocalityData(
                processid=f"lp{i}", zoneid=f"m{m}", machineid=f"m{m}",
                dcid=f"dc{m % n_dcs}", data_hall=f"h{m % n_dcs}",
            ),
        )
        for i, m in enumerate(homes)
    ]


def replica_set_for_tag(
    tag: int, replicas: Sequence[Replica], policy
) -> tuple[int, ...]:
    """The log indices holding tag `tag`'s mutations: the primary
    (tag % n_logs, the reference's bestLocationFor) plus a
    policy-selected set of locality-distinct replicas. A pure function
    of (tag, n_logs, mode, topology): independently booted role hosts
    derive identical routing, like derive_layout for storage teams."""
    primary = replicas[tag % len(replicas)]
    if policy.num_replicas() <= 1:
        return (int(primary.id),)
    extra = policy.select_replicas(
        replicas, already=[primary],
        random=DeterministicRandom(1_000_003 * (tag % len(replicas)) + 7),
    )
    if extra is None:
        raise ValueError(
            f"log replication {policy.describe()} unsatisfiable over "
            f"{len(replicas)} logs' localities"
        )
    return (int(primary.id),) + tuple(sorted(int(r.id) for r in extra))


def route_batches(tagged_mutations, n_logs: int, set_for_tag):
    """Fan a commit batch per log by each tag's replica set (shared by
    the in-process push and the multiprocess RemoteLogSystem so routing
    can never diverge between tiers)."""
    per_log: list[list] = [[] for _ in range(n_logs)]
    for tm in tagged_mutations:
        dests = set()
        for t in tm.tags:
            dests.update(set_for_tag(t))
        for i in sorted(dests):
            per_log[i].append(tm)
    return per_log


class TaggedTLog(MemoryTLog):
    """A MemoryTLog whose entries are TaggedMutation lists, with per-tag
    peek/pop (ref: TLogServer's per-tag message index, commitMessages :750
    builds tag->messages; tLogPeekMessages :903; tLogPop :861)."""

    def __init__(self, init_version: int = 0):
        super().__init__(init_version)
        self._popped_by_tag: dict[int, int] = {}

    async def peek_tag(self, tag: int, from_version: int):
        """Durable entries > from_version as (version, [Mutation]) with
        THIS tag's mutations only. Versions carrying nothing for the tag
        still appear (empty list): the storage server's version cursor must
        advance through every version or its reads would block forever."""
        from .commit_wire import maybe_wire_peek

        entries = await self.peek(from_version)
        return maybe_wire_peek([
            (
                v,
                [tm.mutation for tm in tms if tag in tm.tags],
            )
            for v, tms in entries
        ])

    def pop_tag(self, tag: int, upto_version: int) -> None:
        """(ref: tLogPop): per-tag acknowledgment; the log discards the
        prefix every hosted tag has popped."""
        cur = self._popped_by_tag.get(tag, 0)
        if upto_version <= cur:
            return
        self._popped_by_tag[tag] = upto_version
        if self._popped_by_tag:
            self.pop(min(self._popped_by_tag.values()))

    def seed_rebuilt_state(self, entries: list, version: int,
                           popped_by_tag: Optional[dict] = None) -> None:
        """Initialize a REPLACEMENT log from its peers' re-replicated
        tail (log re-recruitment: a recruited log takes over a dead
        replica's slot and must hold every un-popped version destined to
        it before the next epoch end counts its durable cursor).
        `entries` is the version-sorted (version, [TaggedMutation]) tail;
        `version` the donors' durable top this copy is complete through —
        the seeded cursor, so the epoch-end quorum and truncate_above see
        an honest, non-gapped replica (a top below the recovery version
        would mark this whole copy unavailable). The durable tier
        overrides this to persist the seed before advancing cursors."""
        assert not self._entries, "seed into a fresh log only"
        self._entries = list(entries)
        if self._entries and self._entries[-1][0] < version:
            # Top-off: an empty entry at the donors' durable top keeps
            # truncate_above's gap detection honest (top >= any recovery
            # version the quorum can pick, so the seeded tail stays
            # servable). Consumers advance through empty versions anyway.
            self._entries.append((version, []))
        for tag, floor in sorted((popped_by_tag or {}).items()):
            self._popped_by_tag[tag] = floor
        if version > self.version.get():
            self.version.set(version)
        if version > self.durable.get():
            self.durable.set(version)


class TagPartitionedLogSystem:
    def __init__(self, n_logs: int = 1, init_version: int = 0,
                 log_factory=None, log_replication: str = "single",
                 topology: Optional[dict] = None, regions: bool = False,
                 remote_log_factory=None):
        assert n_logs >= 1
        if log_factory is None:
            log_factory = lambda i: TaggedTLog(init_version)  # noqa: E731
        self.log_replication = log_replication
        self.policy = policy_for_mode(log_replication)
        self.rep_factor = self.policy.num_replicas()
        if self.rep_factor > n_logs:
            raise ValueError(
                f"log replication {log_replication!r} needs "
                f"{self.rep_factor} logs; only {n_logs} configured"
            )
        self.topology = topology
        # Fired (and re-armed) when a region failover switches the
        # serving set: tag cursors parked inside a dark primary log's
        # peek race against this, or they would never re-resolve onto
        # the remote set (the dark log's durable cursor never advances).
        from ..core.runtime import Future

        self._failover_fut = Future()
        # log_sets[0] is the primary set; log_sets[1] (regions only) the
        # remote set fed by the LogRouters. `logs` always resolves to the
        # SERVING set, so every existing consumer follows a failover.
        self.log_sets: list[list[TaggedTLog]] = [
            [log_factory(i) for i in range(n_logs)]
        ]
        self.active_set = 0
        self.failed_over = False
        # Highest version ever acked to a committer: every client-visible
        # write is <= this. The failover gate compares the remote set's
        # shipped floor against it — failing over must never strand an
        # acked write on the dark primary.
        self._acked_floor = init_version
        if regions:
            if topology is None or int(topology.get("n_dcs", 1)) < 2:
                raise ValueError(
                    "two-region log shipping needs a machine topology "
                    "with n_dcs >= 2 (the remote set lives in DC1)"
                )
            if remote_log_factory is None:
                remote_log_factory = (
                    lambda i: TaggedTLog(init_version))  # noqa: E731
            self.log_sets.append(
                [remote_log_factory(i) for i in range(n_logs)]
            )
            for log in self.log_sets[0]:
                # The router is a consumer of every primary log: its
                # cursor pins the discard horizon like a storage tag.
                log._popped_by_tag.setdefault(ROUTER_TAG, 0)
        self.replicas = log_replicas(
            n_logs, topology, dc=0 if regions else None
        )
        self._tag_sets: dict[int, tuple[int, ...]] = {}
        self._registered_tags: set[int] = set()
        if self.rep_factor > 1:
            # Validate satisfiability once, at build (e.g. double over a
            # one-machine DC has nowhere to place the second replica).
            self.replica_set_for_tag(0)
        self.locked_epoch = max(
            (getattr(log, "locked_epoch", 0) for log in self.all_logs()),
            default=0,
        )

    @property
    def logs(self) -> list[TaggedTLog]:
        """The SERVING log set (primary, or remote after a failover)."""
        return self.log_sets[self.active_set]

    def all_logs(self) -> list[TaggedTLog]:
        return [log for s in self.log_sets for log in s]

    # -- routing --
    def replica_set_for_tag(self, tag: int) -> tuple[int, ...]:
        key = tag % len(self.replicas)
        cached = self._tag_sets.get(key)
        if cached is None:
            cached = replica_set_for_tag(key, self.replicas, self.policy)
            self._tag_sets[key] = cached
        return cached

    def log_for_tag(self, tag: int) -> TaggedTLog:
        """(ref: bestLocationFor — tag-indexed round robin; the first
        replica of the tag's policy set)."""
        return self.logs[self.replica_set_for_tag(tag)[0]]

    def tag_view(self, tag: int) -> "TagView":
        # Registering the tag pins each replica log's discard horizon at 0
        # until this tag's server actually pops — an un-started storage
        # server must not lose its prefix to other tags' pops. EVERY log
        # set: a remote log missing the registration would discard a
        # behind tag's unconsumed slice after a failover (found by the
        # DC-kill test: a dead storage's window was popped out from
        # under its cursor by its teammates' pops).
        self._registered_tags.add(tag)
        for log_set in self.log_sets:
            for i in self.replica_set_for_tag(tag):
                log_set[i]._popped_by_tag.setdefault(tag, 0)
        return TagView(self, tag)

    def reregister_tags(self) -> None:
        """Re-pin every known tag's discard floor after a log object was
        REBUILT (power-loss reboot): replay restores only the pops the
        disk kept, and a tag whose POP record was lost must not lose its
        prefix to its peers' future pops."""
        for tag in sorted(self._registered_tags):
            for log_set in self.log_sets:
                for i in self.replica_set_for_tag(tag):
                    log_set[i]._popped_by_tag.setdefault(tag, 0)

    # -- log re-recruitment (ref: the reference recruiting a fresh tlog
    #    onto any TransactionClass worker at epoch end and re-replicating
    #    from the surviving quorum; here the recruited log takes over the
    #    dead replica's SLOT so tag routing — a pure function of the spec
    #    — never changes) --
    def rebuild_log(self, index: int, fresh: TaggedTLog) -> TaggedTLog:
        """Replace serving log `index` with `fresh`, re-replicating the
        surviving replicas' durable, un-popped tail of every version
        destined to this slot. Correctness rides the k-way push quorum:
        every acked version destined to slot `index` via tag t is durable
        on every live replica of t, so the union over reachable peers is
        complete — per tag — above that tag's pop floor (below it the
        slice was applied by storage and discarded everywhere). A tag
        whose replica set has NO reachable donor (single log replication,
        or loss beyond budget) loses its un-shipped window: that is a
        SevError — re-recruitment under an insufficient mode cannot
        invent the lost copy (the destroyed-datadir contract).

        Returns the retired log object (dark or draining); the caller
        owns its teardown and the machine/host bookkeeping."""
        serving = self.log_sets[self.active_set]
        old = serving[index]
        donors = [log for log in serving
                  if log is not old and getattr(log, "reachable", True)]
        # Tags destined to this slot, and whether each has a live donor.
        slot_tags = sorted(
            t for t in self._registered_tags
            if index in self.replica_set_for_tag(t)
        )
        uncovered = [
            t for t in slot_tags
            if not any(serving[i] is not old
                       and getattr(serving[i], "reachable", True)
                       for i in self.replica_set_for_tag(t)
                       if i < len(serving))
        ]
        if uncovered and getattr(old, "reachable", True):
            # Draining a LIVE log (machine drain): the retiring copy is
            # itself the donor of last resort — zero loss at any mode.
            donors = [old] + donors
            uncovered = []
        if uncovered:
            TraceEvent("LogReplacementWindowLost", severity=40).detail(
                "Log", index
            ).detail("Tags", ",".join(map(str, uncovered))).detail(
                "Mode", self.log_replication
            ).log()
        # Union of the donors' durable entries destined to this slot.
        # Dedupe by VALUE with per-donor multiplicity: identical-value
        # mutations share tag vectors, hence replica sets, hence donors —
        # any one donor holding a value holds its full multiplicity, so
        # max-over-donors is the exact count (id()-dedupe would break on
        # the durable tier, where replay re-materializes objects).
        per_version: dict[int, dict] = {}
        d_top = 0
        for donor in donors:
            d = donor.durable.get()
            d_top = max(d_top, d)
            for v, tms in donor._entries:
                if v > d:
                    continue
                counts: dict = {}
                for tm in tms:
                    if not any(index in self.replica_set_for_tag(t)
                               for t in tm.tags):
                        continue
                    key = (tm.tags, tm.mutation.type,
                           tm.mutation.param1, tm.mutation.param2)
                    c, _ = counts.get(key, (0, tm))
                    counts[key] = (c + 1, tm)
                if not counts:
                    continue
                merged = per_version.setdefault(v, {})
                for key, (c, tm) in counts.items():
                    have = merged.get(key)
                    if have is None or have[0] < c:
                        merged[key] = (c, tm)
        entries = []
        for v in sorted(per_version):
            tms: list = []
            # Entry order within a version follows the donor batch scan —
            # per-key insertion order of the merged dict, which is the
            # deterministic serving-set donor order, never hash order.
            for _key, (c, tm) in per_version[v].items():
                tms.extend([tm] * c)
            entries.append((v, tms))
        # Per-tag pop floors: the most conservative (minimum) floor any
        # replica of the tag still records, so the fresh copy never
        # discards a slice a slow consumer still needs.
        floors: dict[int, int] = {}
        for t in slot_tags:
            vals = [
                donor._popped_by_tag[t] for donor in donors
                if t in donor._popped_by_tag
            ]
            floors[t] = min(vals) if vals else 0
        fresh.seed_rebuilt_state(entries, d_top, popped_by_tag=floors)
        serving[index] = fresh
        self.reregister_tags()
        # Wake every tag cursor parked inside the RETIRED copy's peek:
        # its durable cursor will never advance, so the parked peek must
        # re-resolve onto the serving set (the same signal a region
        # failover fires — any serving-set change re-arms it).
        from ..core.runtime import Future

        fut, self._failover_fut = self._failover_fut, Future()
        fut._send(None)
        TraceEvent("LogReplicaRebuilt", severity=20).detail(
            "Log", index
        ).detail("Entries", len(entries)).detail(
            "SeedVersion", d_top
        ).detail("Donors", len(donors)).detail(
            "TagsUncovered", len(uncovered)
        ).log()
        return old

    # -- the commit path (ref: push :339) --
    async def push(self, prev_version: int, version: int,
                   tagged_mutations: Sequence[TaggedMutation],
                   epoch: int = 0, debug_id=None) -> None:
        logs = self.logs
        per_log = route_batches(tagged_mutations, len(logs),
                                self.replica_set_for_tag)
        for log in logs:
            if not getattr(log, "reachable", True):
                # A dark log cannot join the fsync quorum: acking with
                # fewer than k copies would silently shed the durability
                # the mode promises. Commits stall until the log returns
                # (or recovery fails over to the remote set). TLogFailed
                # is ENVIRONMENTAL — the proxy fails the batch without a
                # SevError, exactly like a fence or a lost RPC.
                raise TLogFailed(
                    "tlog unreachable: commit cannot reach its fsync quorum"
                )
        # Every log gets every version (possibly empty) so every chain
        # advances; durability = the full quorum durable (the commit's
        # fsync quorum, ref: TLogCommitReply gathering in push).
        from ..core.runtime import TaskPriority, buggify, current_loop, spawn

        async def one(log, batch):
            loop = current_loop()
            if buggify("log_push_stagger"):
                # One replica's append lands late: the fsync quorum (and
                # anything gating on durable_version) must wait it out.
                await loop.delay(0.05 * loop.random.random01())
            drop = buggify("log_push_drop")
            attempt = 0
            while True:
                try:
                    if drop:
                        # One replica's append errors transiently: the
                        # push machinery must retry it back into the
                        # quorum — never ack around it (that would shed a
                        # copy), never fail the whole batch for a blip.
                        drop = False
                        raise OperationFailed("buggify: log_push_drop")
                    await log.commit(prev_version, version, batch,
                                     epoch=epoch, debug_id=debug_id)
                    return
                except TLogStopped:
                    raise  # fenced by a newer generation: not retryable
                except OperationFailed:
                    attempt += 1
                    if attempt > SERVER_KNOBS.LOG_PUSH_RETRIES:
                        raise
                    await loop.delay(
                        SERVER_KNOBS.LOG_PUSH_RETRY_DELAY
                        * (0.5 + loop.random.random01())
                    )

        tasks = [
            spawn(one(log, batch), TaskPriority.TLOG_COMMIT,
                  name=f"logPush{i}")
            for i, (log, batch) in enumerate(zip(logs, per_log))
        ]
        await all_of([t.done for t in tasks])
        if version > self._acked_floor:
            self._acked_floor = version

    async def confirm_epoch_live(self, epoch: int) -> None:
        """GRV epoch-liveness (ref: confirmEpochLive,
        TagPartitionedLogSystem.actor.cpp:553): a partitioned old master
        whose logs were locked by a successor must NOT hand out read
        versions (its committed version may be behind commits the new
        generation already made: stale reads). Under k-way replication a
        successor recovers from any n-(k-1) logs, so liveness needs
        confirmation from at least n-(k-1) logs — a minority of live,
        unlocked logs proves nothing (the successor's quorum may not
        intersect it)."""
        logs = self.logs
        confirms = 0
        for log in logs:
            if not getattr(log, "reachable", True):
                continue
            log.confirm_epoch(epoch)  # raises TLogStopped if fenced
            confirms += 1
        need = len(logs) - (self.rep_factor - 1)
        if confirms < need:
            raise OperationFailed(
                f"confirmEpochLive: only {confirms}/{len(logs)} logs "
                f"answered (need {need}); a successor's quorum cannot be "
                "ruled out"
            )
        if len(self.log_sets) > 1 and self.active_set == 0:
            # A successor may also have FAILED OVER to the remote set
            # without touching any primary log. A completed failover
            # locks the whole remote set, so one unlocked remote log
            # rules it out; an entirely dark remote set proves nothing.
            standby_confirms = 0
            for log in self.log_sets[1]:
                if not getattr(log, "reachable", True):
                    continue
                log.confirm_epoch(epoch)
                standby_confirms += 1
            if standby_confirms == 0:
                raise OperationFailed(
                    "confirmEpochLive: remote log set unreachable — a "
                    "successor's failover cannot be ruled out"
                )

    # -- recovery (ref: epochEnd :107) --
    def shipped_version(self) -> int:
        """Remote-set durable floor: every version at or below it has
        been shipped and fsynced in the second DC."""
        if len(self.log_sets) < 2:
            return self.durable_version()
        return min(log.quorum_durable() for log in self.log_sets[1])

    def lock(self, epoch: int) -> int:
        assert epoch >= self.locked_epoch
        serving = self.log_sets[self.active_set]
        dark = [log for log in serving
                if not getattr(log, "reachable", True)]
        budget = min(self.rep_factor - 1, len(serving) - 1)
        locked_set = None
        if not dark:
            locked_set, excluded = serving, []
        elif len(dark) <= budget:
            # Honest quorum epoch-end (ref: epochEnd proceeding with
            # n-(k-1) lock replies): the dark logs fit inside the k-1
            # exclusion budget, so every acked commit is durable on a
            # counted log. The dark logs are fenced+truncated too (the
            # in-process model of the rejoin handshake a returning log
            # performs in the reference): their unacked suffix must never
            # serve after they return.
            locked_set = [log for log in serving if log not in dark]
            excluded, budget = dark, budget - len(dark)
        else:
            if len(self.log_sets) > 1 and self.active_set == 0:
                standby = self.log_sets[1]
                if all(getattr(log, "reachable", True) for log in standby):
                    shipped = self.shipped_version()
                    if shipped >= self._acked_floor:
                        # Region failover: the primary set is dark and
                        # the routers have shipped every acked write —
                        # the remote set can serve with zero acked loss.
                        self.active_set = 1
                        self.failed_over = True
                        locked_set, excluded = standby, []
                        budget = min(self.rep_factor - 1,
                                     len(standby) - 1)
                        # Wake every cursor parked on a dark primary log.
                        from ..core.runtime import Future

                        fut, self._failover_fut = (
                            self._failover_fut, Future())
                        fut._send(None)
                        TraceEvent("LogSystemFailover",
                                   severity=30).detail(
                            "Epoch", epoch
                        ).detail("Shipped", shipped).detail(
                            "AckedFloor", self._acked_floor
                        ).log()
                    else:
                        TraceEvent("LogSystemFailoverRefused",
                                   severity=30).detail(
                            "Shipped", shipped
                        ).detail("AckedFloor", self._acked_floor).log()
            if locked_set is None:
                if len(self.log_sets) > 1:
                    raise OperationFailed(
                        "log quorum unreachable: recovery must wait for "
                        "the serving log set (or a caught-up remote set)"
                    )
                # More dark logs than the replication budget covers and
                # no remote set to fail over to. In-process, a blacked-
                # out log's state is still addressable (PR-1's kill ==
                # blackout contract; the reference would wait or recruit)
                # — lock it directly rather than wedge recovery forever.
                TraceEvent("LogSystemLockDarkShortcut",
                           severity=30).detail(
                    "Dark", len(dark)
                ).detail("Budget", budget).log()
                locked_set, excluded = serving, []
        self.locked_epoch = epoch
        durables = [log.lock(epoch) for log in locked_set]
        # Quorum agreement: every acked commit waited the FULL fsync
        # quorum, so it is durable on every log that has not lost state —
        # the k-1 lowest durable cursors (destroyed datadirs, purged
        # tails, dark machines) are excludable without losing anything
        # acked, and every tag keeps >= 1 durable replica of every kept
        # version (k replicas vs n-(k-1) counted logs always intersect).
        # Logs behind the quorum version get their gap marked unavailable
        # inside truncate_above, so tag cursors fail over around them
        # (the reference rolls the affected logs' storage followers back
        # the same way).
        recovery_version = sorted(durables)[budget]
        for log in locked_set:
            log.truncate_above(recovery_version)
        for log in excluded:
            # Modeled rejoin: fence the dark log at this epoch and
            # discard its never-quorum-acked suffix now, so nothing
            # phantom can serve when the machine returns.
            log.lock(epoch)
            log.truncate_above(recovery_version)
        TraceEvent("LogSystemLocked").detail("Epoch", epoch).detail(
            "RecoveryVersion", recovery_version
        ).detail("Excludable", budget).detail(
            "Dark", len(dark)
        ).detail("ActiveSet", self.active_set).log()
        return recovery_version

    @property
    def version(self):
        """Highest version received everywhere (min across the serving
        set: the version the whole system has seen)."""
        return min((log.version for log in self.logs),
                   key=lambda nv: nv.get())

    def durable_version(self) -> int:
        # Per-log quorum_durable, NOT the raw durable cursor: the durable
        # tier's entry_durable excludes lock()'s gap-skips, so a storage
        # engine flushing against this horizon can never persist versions
        # a mid-recovery quorum truncation is about to discard. The min
        # spans the remote set too (until a failover retires the primary):
        # a failover recovery may truncate to the remote shipped floor,
        # so nothing above it may ever reach an engine.
        logs = list(self.logs)
        if len(self.log_sets) > 1 and not self.failed_over:
            logs += self.log_sets[1]
        return min(log.quorum_durable() for log in logs)

    def queue_bytes(self) -> int:
        """Un-popped payload held across the serving logs (ratekeeper
        input, ref: TLogQueueInfo). SPILLED backlog counts too — the
        queue does not shrink just because it moved to disk."""
        return sum(log.queue_bytes() for log in self.logs)

    def register_metrics(self, registry=None) -> None:
        """System-level gauges plus every serving log's per-log gauges
        (labeled by global log id / log set) on the MetricRegistry."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        reg.register_gauge("log_system.queue_bytes", self.queue_bytes,
                           replace=True)
        reg.register_gauge("log_system.durable_version",
                           self.durable_version, replace=True)
        for set_idx, log_set in enumerate(self.log_sets):
            for i, log in enumerate(log_set):
                log.register_metrics(
                    reg, labels=(("log", str(i)), ("set", str(set_idx))),
                )


class LogRouter:
    """LogRouter-style puller (ref: fdbserver/LogRouter.actor.cpp:1-391):
    tails ONE primary log's durable stream and feeds the mirrored remote
    log in the second DC, preserving the version chain (every version,
    empty or not). Shipping is asynchronous — commits ack on the primary
    quorum alone — and the shipped floor both gates failover (lock) and
    bounds the storage flush horizon (durable_version). Pops mirror the
    primary's, and the router's own cursor pins the primary's discard
    horizon via ROUTER_TAG."""

    def __init__(self, system: TagPartitionedLogSystem, index: int):
        self.system = system
        self.index = index
        self.shipped = 0
        self.batches_shipped = 0

    async def run(self) -> None:
        from ..core.errors import ActorCancelled
        from ..core.runtime import current_loop

        loop = current_loop()
        system = self.system
        while True:
            if len(system.log_sets) < 2 or system.active_set != 0:
                return  # failed over: the remote set is now serving
            src = system.log_sets[0][self.index]
            dst = system.log_sets[1][self.index]
            if not (getattr(src, "reachable", True)
                    and getattr(dst, "reachable", True)):
                await loop.delay(SERVER_KNOBS.LOG_ROUTER_RETRY_INTERVAL)
                continue
            try:
                entries = await src.peek(dst.version.get())
            except (ActorCancelled, GeneratorExit):
                raise
            except BaseException:  # noqa: BLE001 — source mid-recovery
                await loop.delay(SERVER_KNOBS.LOG_ROUTER_RETRY_INTERVAL)
                continue
            try:
                for version, tms in entries:
                    prev = dst.version.get()
                    if version <= prev:
                        continue
                    await dst.commit(prev, version, list(tms),
                                     epoch=dst.locked_epoch)
                    self.batches_shipped += 1
            except (ActorCancelled, GeneratorExit):
                raise
            except BaseException:  # noqa: BLE001 — dst fenced mid-ship
                await loop.delay(SERVER_KNOBS.LOG_ROUTER_RETRY_INTERVAL)
                continue
            self.shipped = dst.quorum_durable()
            # Release the primary's retained prefix and mirror its pops
            # onto the remote copy (remote consumers appear only after a
            # failover, always at or above the primary pop horizon).
            src.pop_tag(ROUTER_TAG, self.shipped)
            dst.pop(src.popped)


class TagView:
    """The (log_system, tag) cursor a storage server pulls through — the
    same duck type StorageServer uses on a plain MemoryTLog (ref:
    LogSystemPeekCursor binding a tag to its serving log set). Under
    k-way replication the view FAILS OVER between the tag's replica
    logs: a log that cannot serve the cursor (destroyed datadir, purged
    recovery gap — its available_from is past the cursor) is routed
    around, because at least one replica of every acked version
    survives by the lock quorum's construction."""

    def __init__(self, system: TagPartitionedLogSystem, tag: int):
        self.system = system
        self.tag = tag

    def _replica_logs(self) -> list[TaggedTLog]:
        logs = self.system.logs
        n = len(logs)
        return [logs[i] for i in self.system.replica_set_for_tag(self.tag)
                if i < n]

    def _serving_log(self, from_version: Optional[int] = None) -> TaggedTLog:
        cands = self._replica_logs()
        if from_version is None:
            return cands[0]
        covering = [log for log in cands
                    if log.available_from <= from_version]
        if covering:
            for log in covering:
                if getattr(log, "reachable", True):
                    return log
            # Every covering replica is dark: park on one — blackouts are
            # transient, and skipping to a gapped replica would silently
            # drop the window only the dark copy still holds.
            return covering[0]
        # No replica covers the cursor: the window below min
        # available_from was either consumed (popped) or lost beyond the
        # replication budget. Serve from the least-gapped replica; the
        # cursor jumps the gap (same shape as a purged-version skip).
        best = min(cands, key=lambda log: (log.available_from,))
        TraceEvent("TagViewGapSkip", severity=20).detail(
            "Tag", self.tag
        ).detail("From", from_version).detail(
            "AvailableFrom", best.available_from
        ).log()
        return best

    @property
    def _log(self) -> TaggedTLog:
        return self._serving_log()

    @property
    def version(self):
        return self._log.version

    @property
    def durable(self):
        return self._log.durable

    async def peek(self, from_version: int):
        from ..core.actors import any_of
        from ..core.runtime import TaskPriority, spawn

        while True:
            log = self._serving_log(from_version)
            sig = self.system._failover_fut
            t = spawn(log.peek_tag(self.tag, from_version),
                      TaskPriority.STORAGE, name="tagViewPeek")
            await any_of([t.done, sig])
            if t.done.is_ready():
                return t.done.get()
            # A region failover switched the serving set mid-peek: the
            # dark primary's durable cursor will never advance, so the
            # parked peek must be abandoned and re-resolved onto the
            # remote set.
            t.cancel()

    def pop(self, upto_version: int) -> None:
        # Every replica holds this tag's slice: all must learn the pop or
        # the non-serving copies would retain their prefixes forever.
        for log in self._replica_logs():
            log.pop_tag(self.tag, upto_version)

    def quorum_durable(self) -> int:
        """Durable across EVERY log in the system (the storage engine's
        safe flush horizon — see MemoryTLog.quorum_durable)."""
        return self.system.durable_version()
