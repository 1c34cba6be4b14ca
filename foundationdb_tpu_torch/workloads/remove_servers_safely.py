"""RemoveServersSafely: the exclude-then-verify operator flow as a chaos
workload (ref: fdbserver/workloads/RemoveServersSafely.actor.cpp — exclude
a set of servers, wait for data distribution to drain every shard off
them, verify the exclusion was honored, then include them back, all WHILE
the correctness workloads run).

The workload is the adversary of the DD/exclusion contract, not a smoke
test of it: it picks an exclusion set the replication mode can survive,
writes the ordinary ``\\xff`` exclusion keys (cluster/management.py), and
then independently AUDITS what DD does —

- the drain must finish: within the deadline no shard team may still
  reference an excluded tag (a DD that ignores operator exclusions —
  the seeded-bug regression test — parks here forever);
- the exclusion must HOLD: after the drain settles, a sweep re-checks
  that no excluded tag re-entered any team while the nemesis/mover
  workloads kept churning;
- include-back must restore placement eligibility (the closing
  ConsistencyCheck then proves the moved data itself).

Development note (the bug this caught for real): the hold audit flagged
`RandomMoveKeysWorkload` drawing its target teams from ALL replicas —
the mover re-placed a shard onto a server the operator had just
drained. Exclusions bind every mover, not just DD's healer; the mover
now filters its pool (workloads/random_move_keys.py).
"""

from __future__ import annotations

from ..core.runtime import current_loop
from ..core.trace import TraceEvent


class RemoveServersSafelyWorkload:
    def __init__(self, cluster, db, excludes: int = 1,
                 drain_timeout: float = 45.0, hold_time: float = 1.0):
        self.cluster = cluster
        self.db = db
        self.excludes = excludes
        self.drain_timeout = drain_timeout
        self.hold_time = hold_time
        self.drains_done = 0
        self.excluded_tags: list[int] = []
        self.failures: list[str] = []

    def _safe_exclusion_count(self) -> int:
        """How many servers can leave while every team stays placeable:
        the pool remaining after the exclusion must still satisfy the
        replication policy (the reference's exclusion safety check)."""
        live = len(self.cluster.storages)
        need = self.cluster.policy.num_replicas()
        return max(0, min(self.excludes, live - need))

    def _teams_referencing(self, tags) -> set[int]:
        held = set()
        for _b, _e, team in self.cluster.shard_map.ranges():
            held |= set(team) & set(tags)
        return held

    async def run(self) -> None:
        from ..cluster.management import exclude_servers, include_servers

        loop = current_loop()
        n = self._safe_exclusion_count()
        if n == 0:
            self.failures.append(
                "no safe exclusion possible (fleet too small for the "
                "replication mode)"
            )
            return
        if getattr(self.cluster, "dd", None) is None:
            self.cluster.start_data_distribution()
        tags = sorted(
            {int(s.tag) for s in self.cluster.storages}
        )
        # Prefer servers that actually HOLD shards: excluding a
        # team-free server drains vacuously and audits nothing.
        in_teams = {t for _b, _e, team in self.cluster.shard_map.ranges()
                    for t in team}
        pool = [t for t in tags if t in in_teams] or list(tags)
        # Deterministic pick off the loop PRNG: part of the seed's story.
        chosen = []
        for _ in range(min(n, len(pool))):
            chosen.append(pool.pop(loop.random.random_int(0, len(pool))))
        self.excluded_tags = sorted(chosen)
        TraceEvent("RemoveServersSafelyStart").detail(
            "Tags", self.excluded_tags
        ).log()
        await exclude_servers(self.db, self.excluded_tags)

        # -- the drain audit --
        deadline = loop.now() + self.drain_timeout
        while loop.now() < deadline:
            held = self._teams_referencing(self.excluded_tags)
            if not held:
                break
            await loop.delay(0.25)
        else:
            self.failures.append(
                f"drain of excluded servers {self.excluded_tags} did not "
                f"finish within {self.drain_timeout}s (teams still "
                f"reference {sorted(held)}) — DD is not honoring the "
                "exclusion"
            )
            await include_servers(self.db, self.excluded_tags)
            return
        self.drains_done += 1

        # -- the hold audit: the exclusion must keep holding while churn
        #    (movers, attrition) continues around it --
        hold_until = loop.now() + self.hold_time
        while loop.now() < hold_until:
            held = self._teams_referencing(self.excluded_tags)
            if held:
                self.failures.append(
                    f"excluded tags {sorted(held)} re-entered a team "
                    "after the drain — placement ignored the standing "
                    "exclusion"
                )
                break
            await loop.delay(0.2)

        await include_servers(self.db, self.excluded_tags)
        TraceEvent("RemoveServersSafelyDone").detail(
            "Tags", self.excluded_tags
        ).detail("Failures", len(self.failures)).log()

    async def check(self) -> bool:
        return not self.failures and self.drains_done >= 1

    def metrics(self) -> dict:
        return {
            "drains": self.drains_done,
            "excluded": self.excluded_tags,
            "failures": self.failures[:3],
        }
