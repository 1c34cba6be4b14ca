"""Data distribution: shard sizing/splitting/merging, team healing, and
transactional shard movement (ref: fdbserver/DataDistribution.actor.cpp —
DDTeamCollection :486, buildTeams :1045, teamTracker :1221;
DataDistributionTracker.actor.cpp shard split/merge;
DataDistributionQueue.actor.cpp relocation scheduling;
MoveKeys.actor.cpp startMoveKeys/finishMoveKeys).

MoveKeys here follows the reference's two-phase shape adapted to the
tag-partitioned log:

  start:  the shard's team becomes OLD ∪ NEW in the shard map, so the
          proxy begins tagging the range's mutations to the destinations
          too (ref: startMoveKeys writing src+dest into keyServers/).
          Destinations apply the live stream but stay UNREADABLE.
  fetch:  once every destination's applied version passes the union
          flip, a snapshot of the range is copied from a surviving old
          replica at a fence version v_f and applied beneath the stream
          (ref: fetchKeys, storageserver.actor.cpp:1761 — snapshot +
          buffered-update replay; here stream mutations ≤ v_f are
          overwritten by the snapshot AT v_f, and reads below v_f are
          refused via the destination's oldest_version).
  finish: ownership flips — destinations readable, evicted members
          unreadable and their copy dropped — and the map gets the new
          team (ref: finishMoveKeys).

One move at a time per cluster via the moveKeysLock analogue.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.actors import ActorCollection
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import TaskPriority, current_loop, spawn
from ..core.trace import TraceEvent
from ..kv.keys import KEYSPACE_END, KeyRange
from .replication import Replica


class MoveKeysLock:
    """(ref: moveKeysLock in \\xff/moveKeysLock/ — one DD owns movement)."""

    def __init__(self):
        self._held = False

    async def acquire(self):
        loop = current_loop()
        while self._held:
            await loop.delay(0.01)
        self._held = True

    def release(self):
        self._held = False


async def move_keys(cluster, r: KeyRange, new_team: Sequence[int],
                    lock: Optional[MoveKeysLock] = None,
                    avoid_donors: Sequence[int] = ()) -> None:
    """Relocate [r.begin, r.end) to new_team with no lost or torn data.

    `cluster` is a ShardedKVCluster-shaped object (shard_map, storages,
    master, proxy). `avoid_donors`: members not to fetch from (failed).
    """
    new_team = tuple(sorted(new_team))
    if lock is not None:
        await lock.acquire()
    from ..core.runtime import buggify, current_loop

    if buggify("movekeys_slow_start"):
        # The union-team window stays open longer: concurrent commits and
        # reads must stay correct while both teams serve the range.
        await current_loop().delay(0.1 * current_loop().random.random01())
    try:
        # Capture the pre-move layout: snapshots must come from each
        # SLICE's own team (a range can span shards with different teams).
        old_slices = [
            (max(b, r.begin), min(e, r.end), team)
            for b, e, team in cluster.shard_map.intersecting(r)
        ]
        old_teams = {team for _, _, team in old_slices}
        old_members = {t for team in old_teams for t in team}
        dests = [t for t in new_team if t not in old_members]
        TraceEvent("MoveKeysStart").detail("Begin", r.begin).detail(
            "End", r.end
        ).detail("NewTeam", list(new_team)).log()

        # -- start: union the teams so dests receive the live stream, and
        #    mark dests ASSIGNED so they stop discarding it — but
        #    BUFFERING (begin_fetch) until the snapshot lands, so atomics
        #    never apply against a half-fetched base. Union CLIPPED to r:
        #    slices of overlapping shards outside r keep their old team
        #    (finish only rewrites r, so start must too).
        for t in dests:
            cluster.storages[t].set_assigned(r.begin, r.end, True)
            cluster.storages[t].begin_fetch(r)
        for b, e, team in old_slices:
            union = tuple(sorted(set(team) | set(new_team)))
            cluster.shard_map.set_team(KeyRange(b, e), union)
        try:
            # The fetch-buffering window is DESIGNED to stay open across
            # this await: destinations buffer atomics until the snapshot
            # lands, and the except arm below rolls the window back on
            # every failure path.
            # fdblint: allow[await-lock-hold] -- designed buffering window
            await _move_keys_fetch_finish(
                cluster, r, new_team, old_slices, old_members, dests,
                avoid_donors,
            )
        except BaseException:
            # Roll the start phase back completely: destinations stop
            # buffering and the map returns to the pre-move teams — a
            # half-move (e.g. a recovery swallowing the fence, a dead
            # donor) must leave the cluster exactly as found.
            for t in dests:
                st = cluster.storages[t]
                st.abort_fetch(r)
                st.set_assigned(r.begin, r.end, False)
            for ob, oe, oteam in old_slices:
                cluster.shard_map.set_team(KeyRange(ob, oe), oteam)
            raise
    finally:
        if lock is not None:
            lock.release()


async def _move_keys_fetch_finish(cluster, r, new_team, old_slices,
                                  old_members, dests, avoid_donors):
    # Fence version: everything at or below it will reach dests via
    # the snapshot; everything above arrives via their tag stream.
    # A no-op commit pushes the fence through the pipeline so the
    # union tagging is in effect at v_f. The whole fence+snapshot step
    # RETRIES with a fresh fence when the donor's MVCC window outran it
    # (long stalls under attrition/recovery advance oldest_version past
    # a fence taken before the stall — reading there would assert; the
    # reference's fetchKeys likewise restarts on transaction_too_old).
    from ..core.errors import OperationFailed
    from ..core.runtime import buggify, current_loop

    for _attempt in range(20):
        v_f = await _commit_fence(cluster)

        # -- fetch: wait dests onto the stream, then snapshot each slice
        #    at v_f from a surviving member of ITS old team --
        if buggify("movekeys_slow_fetch"):
            # The snapshot lags the fence: dests buffer a longer tail of
            # the live stream before the base lands under it.
            await current_loop().delay(
                0.1 * current_loop().random.random01()
            )
        for t in dests:
            await cluster.storages[t].version.when_at_least(v_f)
        if not dests:
            break
        avoid = set(avoid_donors)
        all_rows: list = []
        stale = False
        for b, e, team in old_slices:
            donors = [t for t in team if t not in avoid]
            if not donors:
                raise OperationFailed(
                    f"move_keys: no surviving donor for [{b!r}, {e!r})"
                )
            donor = cluster.storages[min(donors)]
            await donor.version.when_at_least(v_f)
            if v_f < donor.oldest_version:
                stale = True  # window moved past the fence: re-fence
                break
            all_rows.extend(donor.data.get_range(b, e, v_f))
        if stale:
            continue
        for t in dests:
            s = cluster.storages[t]
            # Snapshot beneath, buffered stream replayed on top.
            s.end_fetch(r, all_rows, v_f)
            # Reads below the fence never reflect pre-fetch history
            # on a destination (ref: the fetched shard's readable
            # version gating in AddingShard).
            s.oldest_version = max(s.oldest_version, v_f)
        break
    else:
        raise OperationFailed(
            "move_keys: fence version kept falling below the donor MVCC "
            "window (cluster too stalled to snapshot)"
        )

    # -- finish: flip readability + the map --
    for t in new_team:
        cluster.storages[t].set_owned(r.begin, r.end, True)
    for t in sorted(old_members - set(new_team)):
        s = cluster.storages[t]
        s.set_owned(r.begin, r.end, False)
        # Unassign FIRST: in-flight union-tagged mutations must not
        # resurrect rows after the wipe.
        s.set_assigned(r.begin, r.end, False)
        s.data.clear_range(r.begin, r.end, s.version.get())
        s._log_durable_clear(r.begin, r.end, s.version.get())
        s.metrics.on_clear_range(r.begin, r.end)
    cluster.shard_map.set_team(r, new_team)
    TraceEvent("MoveKeysFinish").detail("Begin", r.begin).detail(
        "End", r.end
    ).detail("Version", v_f).log()


async def _commit_fence(cluster) -> int:
    """Drive an empty commit through the pipeline; returns its version.

    Recovery-safe: a generation change can swallow the request (dead
    proxy, fenced log) — retry with a FRESH request against the cluster's
    CURRENT proxy, never waiting forever (a silent hang here would wedge
    move_keys while it holds the cluster-wide lock)."""
    from ..core.actors import timeout
    from ..core.errors import FdbError
    from ..core.knobs import SERVER_KNOBS
    from ..core.runtime import current_loop
    from .interfaces import CommitTransactionRequest

    loop = current_loop()
    lost = object()
    while True:
        proxy = cluster.proxy
        if proxy is None:  # mid-recovery: wait for the next generation
            await loop.delay(0.05)
            continue
        req = CommitTransactionRequest(
            read_snapshot=0, read_conflict_ranges=(),
            write_conflict_ranges=(), mutations=(),
        )
        proxy.commit_stream.send(req)
        try:
            got = await timeout(
                req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT, lost
            )
        except FdbError:
            # Fenced/recovered mid-flight: an empty commit is trivially
            # retryable on the new generation.
            continue
        if got is lost:
            continue
        return got.version


class DataDistributor:
    """The DD role: sizes shards, splits/merges, heals teams (ref:
    dataDistribution, DataDistribution.actor.cpp:2045; one relocation
    queue with bounded parallelism, DataDistributionQueue.actor.cpp)."""

    def __init__(self, cluster, interval: float = 0.5):
        self.cluster = cluster
        self.interval = interval
        self.lock = getattr(cluster, "move_keys_lock", None) or MoveKeysLock()
        self.failed: set[int] = set()  # storage tags considered failed
        self.moves_done = 0
        self.splits_done = 0
        self.merges_done = 0
        self._tasks = ActorCollection()

    # -- health input (FailureMonitor view or tests) --
    def mark_failed(self, tag: int) -> None:
        self.failed.add(tag)
        rk = getattr(self.cluster, "ratekeeper", None)
        if rk is not None:
            rk.set_excluded(self.failed)

    def mark_healthy(self, tag: int) -> None:
        self.failed.discard(tag)
        rk = getattr(self.cluster, "ratekeeper", None)
        if rk is not None:
            rk.set_excluded(self.failed)

    def register_metrics(self, registry=None) -> None:
        """DD progress gauges on the per-process MetricRegistry."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        reg.register_gauge("data_distribution.moves_count",
                           lambda: self.moves_done, replace=True)
        reg.register_gauge("data_distribution.splits_count",
                           lambda: self.splits_done, replace=True)
        reg.register_gauge("data_distribution.merges_count",
                           lambda: self.merges_done, replace=True)
        reg.register_gauge("data_distribution.failed_servers_count",
                           lambda: len(self.failed), replace=True)

    def start(self) -> None:
        self._tasks.add(spawn(self._tracker_loop(), TaskPriority.DEFAULT,
                              name="ddTracker"))
        self.register_metrics()

    def stop(self) -> None:
        self._tasks.cancel_all()

    # -- sizing --
    def shard_bytes(self, b: bytes, e: bytes, team) -> float:
        sizes = [
            self.cluster.storages[t].metrics.shard_bytes(KeyRange(b, e))
            for t in team if t not in self.failed
        ]
        return max(sizes) if sizes else 0.0

    def _unplaceable(self) -> set:
        """Failed servers plus operator exclusions (ref: DD honoring
        excludedServers, DataDistribution.actor.cpp server exclusion
        checks): neither may hold shards, but an EXCLUDED server is alive
        and still donates during the drain."""
        return self.failed | getattr(self.cluster, "excluded", set())

    def _healthy_replicas(self) -> list[Replica]:
        bad = self._unplaceable()
        return [
            rep for rep in self.cluster.replicas if int(rep.id) not in bad
        ]

    def _pick_team(self, avoid: Sequence[int] = ()) -> Optional[tuple]:
        """Policy-valid team over healthy servers, preferring the least
        loaded (ref: getTeam's fitness preference)."""
        pool = [r for r in self._healthy_replicas()
                if int(r.id) not in set(avoid)]
        sel = self.cluster.policy.select_replicas(
            pool or self._healthy_replicas(), random=current_loop().random
        )
        if sel is None and pool:
            sel = self.cluster.policy.select_replicas(
                self._healthy_replicas(), random=current_loop().random
            )
        if sel is None:
            return None
        return tuple(sorted(int(r.id) for r in sel))

    # -- the tracker loop (ref: shardTracker + teamTracker merged) --
    async def _tracker_loop(self):
        loop = current_loop()
        while True:
            await loop.delay(self.interval * (0.8 + 0.4 * loop.random.random01()))
            try:
                await self._heal_one()
                await self._split_one()
                await self._merge_one()
            except BaseException as e:  # noqa: BLE001 — DD must survive
                from ..core.errors import ActorCancelled

                if isinstance(e, ActorCancelled):
                    raise
                TraceEvent("DDTrackerError", severity=30).error(e).log()

    async def _heal_one(self) -> None:
        """Replace failed members in one unhealthy shard (ref:
        teamTracker's zeroHealthyTeams/servers-left logic)."""
        from ..core.runtime import buggify, current_loop

        if buggify("dd_slow_heal"):
            # Healing lags the failure: the shard serves degraded longer.
            await current_loop().delay(0.2 * current_loop().random.random01())
        unplaceable = self._unplaceable()
        for b, e, team in self.cluster.shard_map.ranges():
            if not team:
                continue
            e = e if e is not None else KEYSPACE_END
            bad = [t for t in team if t in unplaceable]
            if not bad:
                continue
            survivors = [t for t in team if t not in unplaceable]
            new_team = self._pick_team(avoid=bad)
            if new_team is None or not survivors:
                TraceEvent("DDCannotHeal", severity=30).detail(
                    "Begin", b
                ).detail("Team", list(team)).log()
                continue
            # Keep survivors for cheap fetches; top up from the new team.
            target = tuple(sorted(set(survivors) | set(new_team)))[
                : max(len(new_team), len(survivors))
            ]
            # Ensure policy-validity of the final team.
            reps = [self.cluster.replicas[t] for t in target]
            if not self.cluster.policy.validate(reps):
                target = new_team
            TraceEvent("DDHealShard").detail("Begin", b).detail(
                "Bad", bad
            ).detail("NewTeam", list(target)).log()
            await move_keys(self.cluster, KeyRange(b, e), target, self.lock,
                            avoid_donors=[t for t in bad if t in self.failed])
            self.moves_done += 1
            return

    async def _split_one(self) -> None:
        """Split the first oversized shard (ref:
        DataDistributionTracker's shardSplitter)."""
        for b, e, team in self.cluster.shard_map.ranges():
            if not team:
                continue
            e2 = e if e is not None else KEYSPACE_END
            size = self.shard_bytes(b, e2, team)
            if size < SERVER_KNOBS.MIN_SHARD_BYTES * SERVER_KNOBS.SHARD_BYTES_RATIO:
                continue
            live = [t for t in team if t not in self.failed]
            if not live:
                continue
            metrics = self.cluster.storages[live[0]].metrics
            points = metrics.split_points(
                KeyRange(b, e2), chunk_bytes=size / 2
            )
            points = [p for p in points if b < p < e2][:1]
            if not points:
                continue
            mid = points[0]
            TraceEvent("DDSplitShard").detail("Begin", b).detail(
                "End", e2
            ).detail("At", mid).detail("Bytes", int(size)).log()
            # Splitting is a map-only operation: both halves keep the
            # team; later rebalancing may move one half elsewhere.
            self.cluster.shard_map.set_team(KeyRange(b, mid), team)
            self.cluster.shard_map.set_team(KeyRange(mid, e2), team)
            self.splits_done += 1
            return

    async def _merge_one(self) -> None:
        """Merge adjacent dwarf shards with identical teams (ref:
        shardMerger)."""
        ranges = self.cluster.shard_map.ranges()
        for (b1, e1, t1), (b2, e2, t2) in zip(ranges, ranges[1:]):
            if not t1 or t1 != t2 or e1 is None:
                continue
            e2x = e2 if e2 is not None else KEYSPACE_END
            s1 = self.shard_bytes(b1, e1, t1)
            s2 = self.shard_bytes(b2, e2x, t2)
            if s1 + s2 >= SERVER_KNOBS.MIN_SHARD_BYTES:
                continue
            self.cluster.shard_map.set_team(KeyRange(b1, e2x), t1)
            self.merges_done += 1
            TraceEvent("DDMergeShard").detail("Begin", b1).detail(
                "End", e2x
            ).log()
            return
