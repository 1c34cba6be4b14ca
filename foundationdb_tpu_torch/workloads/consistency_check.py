"""ConsistencyCheck workload (ref:
fdbserver/workloads/ConsistencyCheck.actor.cpp).

Walks every shard of a sharded cluster and verifies:

- every replica in the shard's team returns IDENTICAL data for the shard
  at a settled version (the reference's replica-vs-replica compare);
- the team satisfies the cluster's replication policy;
- each replica's byte-sample estimate for the shard is consistent with
  the actual data within tolerance (the reference checks data against
  byte samples, :~1400);
- no shard is assigned to a failed/excluded server (when DD is done).
"""

from __future__ import annotations

from ..core.runtime import current_loop
from ..kv.keys import KEYSPACE_END, KeyRange


class ConsistencyCheckWorkload:
    def __init__(self, cluster):
        self.cluster = cluster
        self.failures: list[str] = []

    def _fail(self, msg: str) -> None:
        self.failures.append(msg)

    async def check(self, quiescent: bool = False) -> bool:
        """quiescent=True additionally asserts placement invariants that
        only hold once DD has finished draining (ref: the workload's
        quiescent-mode checks)."""
        c = self.cluster
        # Let replicas catch up to a common version.
        target = max(s.version.get() for s in c.storages)
        for s in c.storages:
            await s.version.when_at_least(target)

        for b, e, team in c.shard_map.ranges():
            if not team:
                continue
            e = e if e is not None else KEYSPACE_END
            r = KeyRange(b, e)
            views = []
            for t in team:
                s = c.storages[t]
                views.append((t, s.data.get_range(b, e, target)))
            baseline = views[0][1]
            for t, rows in views[1:]:
                if rows != baseline:
                    self._fail(
                        f"replica divergence in [{b!r},{e!r}): "
                        f"server {views[0][0]} vs {t}"
                    )
            # Replication policy over the team's localities.
            reps = [c.replicas[t] for t in team]
            if not c.policy.validate(reps):
                self._fail(f"team {team} violates {c.policy.describe()}")
            # Byte sample consistency: estimate vs truth.
            true_bytes = sum(len(k) + len(v) for k, v in baseline)
            for t in team:
                est = c.storages[t].metrics.shard_bytes(r)
                # Sampling overhead inflates; allow generous envelope, but
                # a zero estimate with real data (or vice versa at scale)
                # is a bookkeeping bug.
                if true_bytes > 100_000 and est == 0:
                    self._fail(
                        f"server {t} byte sample empty for populated "
                        f"shard [{b!r},{e!r})"
                    )
            if quiescent:
                dd = getattr(c, "dd", None)
                bad = (dd.failed if dd else set()) | getattr(
                    c, "excluded", set()
                )
                for t in team:
                    if t in bad:
                        self._fail(
                            f"shard [{b!r},{e!r}) still on unplaceable "
                            f"server {t}"
                        )
        return not self.failures
