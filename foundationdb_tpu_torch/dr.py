"""DR: asynchronous cluster->cluster replication by mutation-log shipping
(ref: fdbclient/DatabaseBackupAgent.actor.cpp — the dr_agent copies an
initial snapshot, then continuously applies the source's mutation log to
the destination, tracking the applied version).

Mechanism here: the DR agent subscribes a dedicated tag on the source's
tag-partitioned log (every mutation is stamped with it at the proxy), so
shipping is exactly a storage-server-shaped pull — snapshot at a fence
version beneath, then per-version batches applied to the destination as
ordinary transactions, in version order, popping the tag as it goes. The
applied source version is recorded in the destination's system keyspace
so a failover knows where the copy stands.
"""

from __future__ import annotations

from typing import Optional

from .core.runtime import Task, TaskPriority, current_loop, spawn
from .core.trace import TraceEvent
from .kv.atomic import MutationType
from .kv.keys import KeyRange

DR_VERSION_KEY = b"\xff/drVersion"
# Subscriber tags start far above any storage tag.
DR_TAG_BASE = 1 << 20


class DRAgent:
    """Replicates `source` (a ShardedKVCluster) into `dest_db`."""

    def __init__(self, source, dest_db, dr_tag: int = DR_TAG_BASE):
        self.source = source
        self.dest_db = dest_db
        self.dr_tag = dr_tag
        self.applied_version = 0
        self._task: Optional[Task] = None
        self._view = None

    async def start(self) -> None:
        """Subscribe, snapshot, then tail (ref: the agent's started ->
        differential-mode transitions)."""
        # 1) Subscribe the tag so everything after the fence is shipped.
        self._view = self.source.log_system.tag_view(self.dr_tag)
        for p in getattr(self.source, "proxies", None) or [self.source.proxy]:
            p.dr_tags = tuple(p.dr_tags) + (self.dr_tag,)
        # 2) Fence: a no-op commit; everything <= fence comes via the
        #    snapshot, everything above via the tag stream.
        from .cluster.data_distribution import _commit_fence

        fence = await _commit_fence(self.source)
        # 3) Snapshot the normal keyspace at the fence version.
        src_db = self.source.database()
        tr = src_db.create_transaction()
        tr.set_read_version(fence)
        rows = await tr.get_range(b"", b"\xff")
        CHUNK = 500

        async def clear_dest(dtr):
            dtr.clear_range(b"", b"\xff")

        await self.dest_db.transact(clear_dest)
        for i in range(0, len(rows), CHUNK):
            chunk = rows[i : i + CHUNK]

            async def write(dtr, chunk=chunk):
                for k, v in chunk:
                    dtr.set(k, v)

            await self.dest_db.transact(write)
        self.applied_version = fence

        async def mark(dtr, v=fence):
            dtr.options.set_access_system_keys()
            dtr.set(DR_VERSION_KEY, str(v).encode())

        await self.dest_db.transact(mark)
        TraceEvent("DRSnapshotDone").detail("Version", fence).detail(
            "Rows", len(rows)
        ).log()
        # 4) Tail.
        self._task = spawn(self._tail(), TaskPriority.DEFAULT, name="drAgent")

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        for p in getattr(self.source, "proxies", None) or [self.source.proxy]:
            p.dr_tags = tuple(t for t in p.dr_tags if t != self.dr_tag)

    async def _tail(self) -> None:
        while True:
            entries = await self._view.peek(self.applied_version)
            for version, mutations in entries:
                # The source's OWN system keys do not replicate (dest has
                # its own config; ref: DR's normal-keyspace scope).
                ms = [
                    m for m in mutations if not m.param1.startswith(b"\xff")
                ]
                if ms:
                    async def apply(dtr, ms=ms, v=version):
                        dtr.options.set_access_system_keys()
                        # Idempotence guard: a CommitUnknownResult retry
                        # re-runs this body after the commit may have landed;
                        # re-applying atomic ops (ADD, ...) would silently
                        # diverge the replica. The applied-version register
                        # is written in the same transaction, so `>= v`
                        # proves this version is already in (ref: the
                        # agent's applyMutations applied-version tracking).
                        cur = await dtr.get(DR_VERSION_KEY)
                        if cur is not None and int(cur) >= v:
                            return
                        for m in ms:
                            if m.type == MutationType.SET_VALUE:
                                dtr.set(m.param1, m.param2)
                            elif m.type == MutationType.CLEAR_RANGE:
                                dtr.clear_range(
                                    m.param1, min(m.param2, b"\xff")
                                )
                            else:
                                dtr.atomic_op(m.type, m.param1, m.param2)
                        dtr.set(DR_VERSION_KEY, str(v).encode())

                    await self.dest_db.transact(apply)
                self.applied_version = version
            self._view.pop(self.applied_version)

    async def wait_drained(self) -> int:
        """Resolves once the destination has applied everything the
        source has committed as of the call."""
        target = self.source.master.get_live_committed_version()
        loop = current_loop()
        while self.applied_version < target:
            await loop.delay(0.05)
        return self.applied_version
