"""TaskBucket: a persistent, leased task queue stored in the database
itself (ref: fdbclient/TaskBucket.actor.cpp — the execution fabric for
backup/restore/DR; tasks are KV entries under a subspace, claimed with
time-limited leases and re-queued when an executor dies).

Layout under the bucket subspace (mirroring the reference's shape):

    available/<priority>/<task_id>             -> packed params
    timeouts/<lease_version>/<task_id>/<prio>  -> packed params  (claimed)

The claimed entry carries the task's priority so a lease-timeout requeue
restores it (the reference preserves priority across checkTimeouts).

Claiming moves a task from `available` to `timeouts` keyed by the lease
expiry version; `finish` deletes it; an expired lease is swept back to
`available`, so a crashed agent's work is retried — at-least-once
execution, exactly the reference's contract.
"""

from __future__ import annotations

from typing import Optional

from ..core.knobs import SERVER_KNOBS
from ..core.runtime import current_loop
from .subspace import Subspace
from .tuple import pack, unpack


class Task:
    def __init__(self, task_id: bytes, priority: int, params: dict,
                 lease_version: int = 0):
        self.id = task_id
        self.priority = priority
        self.params = params
        self.lease_version = lease_version

    def __repr__(self):
        return f"Task({self.id.hex()}, p{self.priority}, {self.params})"


def _pack_params(params: dict) -> bytes:
    items = []
    for k in sorted(params):
        items.extend([k, params[k]])
    return pack(tuple(items))


def _unpack_params(raw: bytes) -> dict:
    items = unpack(raw)
    return {items[i]: items[i + 1] for i in range(0, len(items), 2)}


class TaskBucket:
    def __init__(self, subspace: Subspace,
                 timeout_versions: Optional[int] = None):
        self.available = subspace[b"available"]
        self.timeouts = subspace[b"timeouts"]
        # Per-bucket lease horizon override (ref: TaskBucket::setTimeout);
        # None = the global knob.
        self._timeout_versions = timeout_versions

    @property
    def timeout_versions(self) -> int:
        return (self._timeout_versions
                if self._timeout_versions is not None
                else SERVER_KNOBS.TASKBUCKET_TIMEOUT_VERSIONS)

    # -- producer side --
    def add(self, tr, params: dict, priority: int = 0) -> bytes:
        """Enqueue; returns the task id (ref: TaskBucket::addTask)."""
        task_id = bytes(
            current_loop().random.random_int(0, 256) for _ in range(16)
        )
        tr.set(
            self.available.pack((priority, task_id)), _pack_params(params)
        )
        return task_id

    # -- consumer side --
    async def get_one(self, tr) -> Optional[Task]:
        """Claim one task: highest priority first, random within a
        priority band (ref: getOne's random scan to dodge contention).
        The claim conflicts with other claimants of the SAME task only."""
        b, e = self.available.range()
        rows = await tr.get_range(b, e, snapshot=True)
        if not rows:
            return None
        # Highest priority = highest tuple value first.
        best_priority = max(
            self.available.unpack(k)[0] for k, _ in rows
        )
        candidates = [
            (k, v) for k, v in rows
            if self.available.unpack(k)[0] == best_priority
        ]
        k, v = candidates[
            current_loop().random.random_int(0, len(candidates))
        ]
        # Conflict with concurrent claimants of this task.
        taken = await tr.get(k)
        if taken is None:
            return None  # raced: claimed+finished under us; caller retries
        priority, task_id = self.available.unpack(k)
        lease = await tr.get_read_version() + self.timeout_versions
        tr.clear(k)
        tr.set(self.timeouts.pack((lease, task_id, priority)), v)
        return Task(task_id, priority, _unpack_params(v), lease)

    def finish(self, tr, task: Task) -> None:
        """(ref: TaskBucket::finish) — done; drop the lease entry."""
        tr.clear(
            self.timeouts.pack((task.lease_version, task.id, task.priority))
        )

    async def extend(self, tr, task: Task) -> Task:
        """Renew the lease of a long-running task (ref: extendTimeout)."""
        old_key = self.timeouts.pack(
            (task.lease_version, task.id, task.priority)
        )
        raw = await tr.get(old_key)
        if raw is None:
            raise KeyError("lease lost (timed out and reclaimed)")
        new_lease = await tr.get_read_version() + self.timeout_versions
        tr.clear(old_key)
        tr.set(self.timeouts.pack((new_lease, task.id, task.priority)), raw)
        return Task(task.id, task.priority, task.params, new_lease)

    async def sweep_timeouts(self, tr) -> int:
        """Requeue every task whose lease expired (ref: checkTimeouts).
        Returns how many were requeued."""
        rv = await tr.get_read_version()
        b = self.timeouts.range()[0]
        e = self.timeouts.pack((rv,))
        rows = await tr.get_range(b, e)
        for k, v in rows:
            _, task_id, priority = self.timeouts.unpack(k)
            tr.clear(k)
            tr.set(self.available.pack((priority, task_id)), v)
        return len(rows)

    async def is_empty(self, tr) -> bool:
        for space in (self.available, self.timeouts):
            b, e = space.range()
            if await tr.get_range(b, e, limit=1):
                return False
        return True

    # -- the agent loop (ref: TaskBucket::run / doOne) --
    async def run_agent(self, db, executor, poll_interval: float = 0.2,
                        stop_when_empty: bool = False):
        """Claim-execute-finish forever (or until drained). `executor` is
        `async (db, task) -> None`; raising leaves the task leased, to be
        retried after the lease expires — at-least-once.

        While the executor runs, the lease is renewed at HALF the lease
        horizon (ref: TaskBucket.actor.cpp extendTimeoutRepeatedly): a
        long task is never stolen mid-execution, yet the agent dying at
        ANY instant — including between the claim and the first
        extension — leaves a lease that expires within one
        TASKBUCKET_TIMEOUT of the last renewal, so the task is
        reclaimable by the next sweep. Without the extender, any task
        outliving its claim lease was silently stolen and re-executed
        concurrently."""
        from ..core.actors import ActorCollection

        loop = current_loop()
        extend_interval = (
            self.timeout_versions / SERVER_KNOBS.VERSIONS_PER_SECOND
        ) / 2
        while True:
            async def claim(tr):
                await self.sweep_timeouts(tr)
                return await self.get_one(tr)

            task = await db.transact(claim)
            if task is None:
                if stop_when_empty:
                    async def empty(tr):
                        return await self.is_empty(tr)

                    if await db.transact(empty):
                        return
                await loop.delay(
                    poll_interval * (0.7 + 0.6 * loop.random.random01())
                )
                continue

            async def extender(task=task):
                while True:
                    await loop.delay(extend_interval)

                    async def ext(tr):
                        return await self.extend(tr, task)

                    try:
                        renewed = await db.transact(ext)
                    except KeyError:
                        # Lease gone: swept + (possibly) re-claimed by
                        # another agent. Stop renewing; at-least-once
                        # covers the double execution, and our finish
                        # below clears a dead key (a no-op).
                        return
                    task.lease_version = renewed.lease_version

            ext_tasks = ActorCollection()
            from ..core.runtime import spawn

            ext_tasks.add(spawn(extender(), name="taskExtend"))
            try:
                await executor(db, task)
            finally:
                ext_tasks.cancel_all()

            async def fin(tr):
                self.finish(tr, task)

            await db.transact(fin)
