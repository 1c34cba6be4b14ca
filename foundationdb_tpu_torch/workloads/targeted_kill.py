"""TargetedKill: role-aimed machine kills over the attrition deck (ref:
fdbserver/workloads/TargetedKill.actor.cpp — killing the machine hosting
a SPECIFIC role, where MachineAttrition kills whatever the PRNG draws).

Each deck entry names a role ("log", "storage", "txn"): the workload
finds a live, unprotected machine hosting that role and kills it through
the topology's quorum-safety-gated kill, waits out the outage, restores,
and lets the cluster heal.

The workload carries its own INDEPENDENT safety audit: before every kill
it recomputes, from the shard map and machine liveness alone, whether
the kill leaves every team a live replica. A kill the topology's
`can_kill` gate lets through that this audit calls unsafe is recorded as
`unsafe_kills` and fails check() — this is the seeded-bug catcher the
workload was built against (a broken `can_kill` silently turns the
nemesis into a data-loss generator; the audit turns it into a red test).
"""

from __future__ import annotations

from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent


class TargetedKillWorkload:
    def __init__(self, topology, roles=("log", "storage", "txn"),
                 interval: float = 0.8, outage: float = 0.4,
                 name: str = "targeted-kill"):
        self.topo = topology
        self.cluster = topology.cluster
        self.roles = list(roles)
        self.interval = interval
        self.outage = outage
        self.name = name
        self.kills_by_role: dict[str, int] = {}
        self.refused = 0
        self.unsafe_kills = 0
        self.failures: list[str] = []
        self._task = None

    def start(self) -> "TargetedKillWorkload":
        if hasattr(self.cluster, "start_controller"):
            # Unique candidate name: the election arbitrates BY NAME.
            self.cluster.start_controller(self.name)
        self._task = spawn(self._run(), name="targetedKill")
        return self

    @property
    def done(self):
        return self._task.done

    def _hosts_role(self, m, role: str) -> bool:
        if role == "log":
            return bool(m.log_ids)
        if role == "storage":
            return bool(m.storage_tags)
        if role == "txn":
            return bool(m.has_txn)
        raise ValueError(f"unknown kill target role {role!r}")

    def _audit_safe(self, m) -> bool:
        """The independent quorum-safety computation: after killing `m`
        (on top of the already-dead machines), every non-empty team must
        keep a live replica and some machine must survive to host the
        re-recruited transaction roles. Deliberately NOT a call into
        topo.can_kill — auditing a gate with the gate proves nothing."""
        dead = {x.index for x in self.topo.machines
                if not x.alive or x.retired}
        dead.add(m.index)
        if all(x.index in dead for x in self.topo.machines):
            return False
        for _b, _e, team in self.cluster.shard_map.ranges():
            if team and all(self.topo.machine_of_tag(t).index in dead
                            for t in team):
                return False
        return True

    async def _run(self):
        loop = current_loop()
        random = loop.random
        deck = list(self.roles)
        for i in range(len(deck) - 1, 0, -1):
            j = random.random_int(0, i + 1)
            deck[i], deck[j] = deck[j], deck[i]
        for role in deck:
            await loop.delay(self.interval * (0.5 + random.random01()))
            targets = [
                m for m in self.topo.machines
                if m.alive and not m.protected and not m.retired
                and self._hosts_role(m, role)
            ]
            if not targets:
                self.refused += 1
                continue
            m = targets[random.random_int(0, len(targets))]
            safe = self._audit_safe(m)
            if self.topo.kill_machine(m):
                if not safe:
                    self.unsafe_kills += 1
                    self.failures.append(
                        f"kill of {m.name} (role {role}) passed the "
                        "topology gate but fails the independent "
                        "quorum-safety audit"
                    )
                self.kills_by_role[role] = (
                    self.kills_by_role.get(role, 0) + 1
                )
                TraceEvent("TargetedKill").detail("Role", role).detail(
                    "Machine", m.name
                ).log()
                await loop.delay(
                    self.outage * (0.3 + 0.7 * random.random01())
                )
                self.topo.restore_machine(m)
            else:
                self.refused += 1
        await self._heal(loop)

    async def _heal(self, loop):
        for m in self.topo.machines:
            self.topo.restore_machine(m)
        deadline = loop.now() + 60.0
        while loop.now() < deadline:
            if await self.cluster._txn_system_healthy():
                return
            await loop.delay(0.2)
        TraceEvent("TargetedKillHealTimeout", severity=30).log()

    async def check(self) -> bool:
        if self.unsafe_kills or self.failures:
            return False
        if any(m.kills > 0 and m.protected for m in self.topo.machines):
            return False
        acted = sum(self.kills_by_role.values())
        # All-refused seeds tested nothing — unless nothing was asked.
        return acted > 0 or not self.roles

    def metrics(self) -> dict:
        return {
            "kills_by_role": dict(sorted(self.kills_by_role.items())),
            "refused": self.refused,
            "unsafe_kills": self.unsafe_kills,
            "failures": self.failures[:3],
        }
