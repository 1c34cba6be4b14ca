"""RandomMoveKeys: continuous random shard relocation during traffic
(ref: fdbserver/workloads/RandomMoveKeys.actor.cpp — moves random key
ranges to random teams while correctness workloads run; any lost or torn
data surfaces in their checks)."""

from __future__ import annotations

from ..cluster.data_distribution import MoveKeysLock, move_keys
from ..core.errors import ActorCancelled, OperationFailed
from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent
from ..kv.keys import KEYSPACE_END, KeyRange


class RandomMoveKeysWorkload:
    def __init__(self, cluster, interval: float = 0.3):
        self.cluster = cluster
        self.interval = interval
        # The CLUSTER-wide lock: concurrent movers (this workload, DD
        # healing) must serialize — move_keys has multi-phase state that
        # two interleaved moves on overlapping ranges would corrupt (ref:
        # the real moveKeysLock every mover takes).
        self.lock = getattr(cluster, "move_keys_lock", None) or MoveKeysLock()
        self.moves_done = 0
        self._task = None
        self._stopping = False

    def start(self) -> "RandomMoveKeysWorkload":
        self._task = spawn(self._run(), name="randomMoveKeys")
        return self

    def stop(self) -> None:
        """Graceful: finish any in-flight move, then exit — cancelling
        mid-move would leave union teams + unfetched destinations for the
        closing ConsistencyCheck to trip over. Await wait_stopped() for
        the actual exit."""
        self._stopping = True

    async def wait_stopped(self) -> None:
        if self._task is not None:
            await self._task.done

    async def _try_one_move(self) -> bool:
        loop = current_loop()
        c = self.cluster
        ranges = [
            (b, e if e is not None else KEYSPACE_END, team)
            for b, e, team in c.shard_map.ranges() if team
        ]
        if not ranges:
            return False
        b, e, old_team = ranges[loop.random.random_int(0, len(ranges))]
        # Operator exclusions bind EVERY mover, not just DD's healer
        # (the reference's moveKeys honors excludedServers): found by
        # RemoveServersSafely's hold audit — this mover used to draw
        # from ALL replicas and re-placed shards onto a server an
        # operator had just drained.
        bad = getattr(c, "excluded", set())
        pool = [r for r in c.replicas if int(r.id) not in bad]
        team = c.policy.select_replicas(pool, random=loop.random)
        if team is None:
            return False
        new_team = tuple(sorted(int(r.id) for r in team))
        if new_team == tuple(old_team):
            return False
        try:
            await move_keys(c, KeyRange(b, e), new_team, self.lock)
            self.moves_done += 1
            return True
        except ActorCancelled:
            raise
        except OperationFailed as err:
            TraceEvent("RandomMoveKeysSkipped", severity=20).error(
                err
            ).log()
            return False

    async def _run(self):
        loop = current_loop()
        while not self._stopping:
            await loop.delay(self.interval * (0.5 + loop.random.random01()))
            if self._stopping:
                break
            await self._try_one_move()
        # Quick foreground workloads can outrun the first interval (or
        # every timed attempt can draw the same team / lose its race):
        # when progress is REQUIRED, the stop path still owes one
        # completed move — the same contract as _AttritionWorkload's
        # final kill. Bounded: a cluster where no distinct team exists
        # still exits and fails check() honestly.
        attempts = 0
        while (self.require_progress and self.moves_done == 0
               and attempts < 8):
            attempts += 1
            if not await self._try_one_move():
                await loop.delay(0.05)

    require_progress = True  # spec-settable: under heavy attrition, every
    # attempted move can legitimately lose its race with a recovery.

    async def check(self) -> bool:
        """The workload itself has no invariant (the concurrent
        correctness workloads carry them); success = it actually moved
        (unless the spec marked progress best-effort)."""
        return self.moves_done > 0 or not self.require_progress
