"""Backup-under-attrition soak: a fleet of MORTAL backup agents drains a
TaskBucket of range-snapshot tasks while a nemesis kills and replaces
agents mid-stream (ref: fdbclient/FileBackupAgent.actor.cpp — the backup
IS a TaskBucket of short range tasks precisely so agent death costs a
lease timeout, not the backup; fdbserver/workloads/BackupToFileAndRestore
killing backup agents under load; TaskBucket.actor.cpp checkTimeouts).

Until now the repo's backup was driven by a single immortal agent — the
lease-takeover path (claim → die → sweep → reclaim by a survivor) ran
only in unit tests. Here it runs as a workload:

- setup writes an immutable dataset and splits it into N range tasks in
  a TaskBucket;
- `agents` claim-execute tasks (each execution straddles awaits, so
  kills land MID-task, leaving a claimed lease behind);
- the nemesis cancels a random live agent `kills` times, spawning a
  replacement each time — at-least-once execution must still cover
  every range;
- check() compares the union of completed range dumps against a direct
  read of the dataset: a single missing range means lease takeover lost
  work (the seeded bug this was built against: a sweep that never
  requeues dead agents' claims parks their ranges forever — the
  soak's deadline turns that hang into a named failure).

A background ticker commits continuously so version time advances and
claimed leases can actually expire (leases are measured in versions).
"""

from __future__ import annotations

from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent
from ..layers.subspace import Subspace
from ..layers.task_bucket import TaskBucket


class BackupAttritionWorkload:
    def __init__(self, db, keys: int = 48, tasks: int = 8,
                 agents: int = 3, kills: int = 3,
                 deadline: float = 40.0, prefix: bytes = b"ba/"):
        self.db = db
        self.keys = keys
        self.n_tasks = tasks
        self.n_agents = agents
        self.kills = kills
        self.deadline = deadline
        self.prefix = prefix
        # Short leases (2s of versions): the soak's whole point is lease
        # EXPIRY + takeover; the global 60s default would dominate it.
        self.tb = TaskBucket(Subspace((b"backup_soak",)),
                             timeout_versions=2_000_000)
        # range_id -> rows; the stand-in for container range files (the
        # lease-takeover contract under test is identical).
        self.ranges_done: dict[int, list] = {}
        self.kills_done = 0
        self.replacements = 0
        self.failures: list[str] = []

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%06d" % i

    async def run(self) -> None:
        loop = current_loop()

        # -- dataset + task fan-out --
        async def seed(tr):
            for i in range(self.keys):
                tr.set(self._key(i), b"v%d" % i)

        await self.db.transact(seed)
        per = max(1, self.keys // self.n_tasks)
        slices = []
        for rid in range(self.n_tasks):
            lo = rid * per
            hi = self.keys if rid == self.n_tasks - 1 else (rid + 1) * per
            if lo >= self.keys:
                break
            slices.append((rid, lo, hi))

        async def add_tasks(tr):
            for rid, lo, hi in slices:
                self.tb.add(tr, {b"rid": rid, b"lo": lo, b"hi": hi})

        await self.db.transact(add_tasks)

        # -- the agent executor: deliberately slow enough that kills
        #    land mid-task and leave a claimed lease behind --
        async def executor(db, task):
            rid = task.params[b"rid"]
            lo, hi = task.params[b"lo"], task.params[b"hi"]
            await loop.delay(0.05 + 0.1 * loop.random.random01())

            async def read(tr):
                return await tr.get_range(self._key(lo), self._key(hi))

            rows = await db.transact(read)
            await loop.delay(0.05 + 0.1 * loop.random.random01())
            self.ranges_done[rid] = rows

        def new_agent(i):
            return spawn(
                self.tb.run_agent(self.db, executor, poll_interval=0.1,
                                  stop_when_empty=True),
                name=f"backupAgent{i}",
            )

        agents = [new_agent(i) for i in range(self.n_agents)]

        # Version time must advance for leases to expire: commit ticks.
        ticking = [True]

        async def ticker():
            n = 0
            while ticking[0]:
                n += 1
                await self.db.set(b"ba-tick/", b"%d" % n)
                await loop.delay(0.05)

        tick_task = spawn(ticker(), name="baTicker")

        async def nemesis():
            for _ in range(self.kills):
                await loop.delay(0.2 + 0.4 * loop.random.random01())
                live = [a for a in agents if not a.done.is_ready()]
                if not live:
                    return
                victim = live[loop.random.random_int(0, len(live))]
                victim.cancel()
                self.kills_done += 1
                TraceEvent("BackupAgentKilled").detail(
                    "Remaining", len(live) - 1
                ).log()
                self.replacements += 1
                agents.append(new_agent(1000 + self.replacements))

        nem = spawn(nemesis(), name="backupNemesis")

        # -- drain, bounded: a takeover bug means a range parked on a
        #    dead agent's lease and the soak must FAIL, not hang --
        end = loop.now() + self.deadline
        while loop.now() < end:
            if all(a.done.is_ready() for a in agents):
                break
            await loop.delay(0.2)
        else:
            missing = [rid for rid, _lo, _hi in slices
                       if rid not in self.ranges_done]
            self.failures.append(
                f"soak did not drain within {self.deadline}s; ranges "
                f"never completed: {missing} — a dead agent's lease was "
                "not taken over"
            )
            for a in agents:
                a.cancel()
        await nem.done
        ticking[0] = False
        await tick_task.done

        TraceEvent("BackupAttritionDone").detail(
            "Ranges", len(self.ranges_done)
        ).detail("Kills", self.kills_done).log()

    async def check(self) -> bool:
        if self.failures:
            return False

        async def read_all(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")

        expect = await self.db.transact(read_all)
        got = {k: v for rows in self.ranges_done.values()
               for k, v in rows}
        missing = [k for k, _ in expect if k not in got]
        if missing:
            self.failures.append(
                f"{len(missing)} keys missing from the completed ranges "
                f"(first: {missing[0]!r}) — lease takeover lost work"
            )
            return False
        wrong = [k for k, v in expect if got[k] != v]
        if wrong:
            self.failures.append(f"rows differ from dataset: {wrong[:3]}")
            return False
        return True

    def metrics(self) -> dict:
        return {
            "ranges": len(self.ranges_done),
            "kills": self.kills_done,
            "replacements": self.replacements,
            "failures": self.failures[:3],
        }
