"""MachineAttrition nemesis over the machine/DC topology (ref:
fdbserver/workloads/MachineAttrition.actor.cpp — machineKillWorker picks
machines (or a whole datacenter) off the deterministic PRNG and kills or
reboots them while the correctness workloads run; RandomClogging's
swizzle rides along).

Where the per-role `Attrition` spec workload kills the transaction
system, this one kills MACHINES: every co-resident role — storage
replicas, tlogs, the per-generation transaction roles — fails at one
instant, which is the shared-fate scenario class per-role faults can
never produce. Every kill is gated by the topology's quorum-safety check
(`MachineTopology.can_kill`), so the nemesis drives the cluster to the
edge of what the configured replication mode tolerates but never over
it, and the protected (coordinator-hosting) machines are routed around
entirely (sim2's protectedAddresses).

All randomness flows from the loop PRNG: one seed ⇒ one kill schedule ⇒
one final keyspace fingerprint, replayed bit-identically.
"""

from __future__ import annotations

from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent


class MachineAttritionWorkload:
    def __init__(self, topology, interval: float = 0.8, kills: int = 2,
                 reboots: int = 1, swizzles: int = 1, dc_kills: int = 0,
                 permanent_kills: int = 0, permanent_log_kills: int = 0,
                 permanent_storage_kills: int = 0, outage: float = 0.4,
                 max_clog: float = 0.6, power_loss: bool = False,
                 name: str = "machine-attrition"):
        self.topo = topology
        self.cluster = topology.cluster
        self.interval = interval
        self.outage = outage
        self.max_clog = max_clog
        self.power_loss = power_loss
        self.name = name
        # The action deck: shuffled off the loop PRNG at start, so the
        # seed owns the schedule's order as well as its timing.
        # "permkill" is the PERMANENT machine loss (no restore until the
        # closing heal): the shared-fate scenario the recruitment path
        # must survive by re-placing the dead machine's roles elsewhere.
        # The "permkill_log"/"permkill_storage" variants TARGET machines
        # hosting those durable roles — the log/storage re-recruitment
        # paths (replacement host recruited from the registry, tail
        # re-replicated / teams re-seeded) instead of whatever machine
        # the PRNG happens to draw.
        self.deck = (["kill"] * kills + ["reboot"] * reboots
                     + ["swizzle"] * swizzles + ["dc"] * dc_kills
                     + ["permkill"] * permanent_kills
                     + ["permkill_log"] * permanent_log_kills
                     + ["permkill_storage"] * permanent_storage_kills)
        self.kills_done = 0
        self.reboots_done = 0
        self.swizzles_done = 0
        self.dc_kills_done = 0
        self.permanent_kills_done = 0
        self.permanent_log_kills_done = 0
        self.permanent_storage_kills_done = 0
        self.refused = 0
        self._task = None

    def start(self) -> "MachineAttritionWorkload":
        if hasattr(self.cluster, "start_controller"):
            # Unique candidate name: LeaderElection arbitrates by name
            # (same contract as the per-role attrition workload).
            self.cluster.start_controller(self.name)
        self._task = spawn(self._run(), name="machineAttrition")
        return self

    @property
    def done(self):
        return self._task.done

    def _pick(self, random, items):
        return items[random.random_int(0, len(items))]

    async def _run(self):
        loop = current_loop()
        random = loop.random
        deck = list(self.deck)
        for i in range(len(deck) - 1, 0, -1):
            j = random.random_int(0, i + 1)
            deck[i], deck[j] = deck[j], deck[i]
        for action in deck:
            await loop.delay(self.interval * (0.5 + random.random01()))
            if action == "kill":
                targets = self.topo.killable_machines()
                if not targets:
                    self.refused += 1
                    continue
                m = self._pick(random, targets)
                if self.topo.kill_machine(m):
                    self.kills_done += 1
                    await loop.delay(
                        self.outage * (0.3 + 0.7 * random.random01())
                    )
                    self.topo.restore_machine(m)
            elif action in ("permkill", "permkill_log",
                            "permkill_storage"):
                # PERMANENT loss: no restore — the cluster must
                # re-recruit the dead machine's roles onto a survivor
                # (quorum-safety-gated like every kill; _heal revives
                # everything for the closing checks). The targeted
                # variants draw only from machines hosting the named
                # durable role, so every such seed exercises log tail
                # re-replication / storage team re-seeding.
                targets = self.topo.killable_machines()
                if action == "permkill_log":
                    targets = [m for m in targets if m.log_ids]
                elif action == "permkill_storage":
                    targets = [m for m in targets
                               if m.storage_tags and not m.log_ids]
                if not targets:
                    self.refused += 1
                    continue
                m = self._pick(random, targets)
                if self.topo.kill_machine(m):
                    if action == "permkill_log":
                        self.permanent_log_kills_done += 1
                    elif action == "permkill_storage":
                        self.permanent_storage_kills_done += 1
                    else:
                        self.permanent_kills_done += 1
            elif action == "reboot":
                targets = self.topo.killable_machines()
                if not targets:
                    self.refused += 1
                    continue
                m = self._pick(random, targets)
                power = (self.power_loss and self.topo.disk is not None
                         and random.random01() < 0.5)
                if await self.topo.reboot_machine(
                    m, outage=self.outage * (0.3 + 0.7 * random.random01()),
                    power_loss=power,
                ):
                    self.reboots_done += 1
            elif action == "swizzle":
                await self.topo.swizzle(random, self.max_clog)
                self.swizzles_done += 1
            elif action == "dc":
                dc = self._pick(random, self.topo.dcs)
                killed = self.topo.kill_datacenter(dc)
                if killed:
                    self.dc_kills_done += 1
                    await loop.delay(
                        self.outage * (0.3 + 0.7 * random.random01())
                    )
                    for m in killed:
                        self.topo.restore_machine(m)
                else:
                    self.refused += 1
        await self._heal(loop)

    async def _heal(self, loop):
        """Leave the cluster healthy for the closing checks: every
        machine restored, and the transaction system answering (the
        reference workload likewise waits for the cluster to heal)."""
        for m in self.topo.machines:
            self.topo.restore_machine(m)
        deadline = loop.now() + 60.0
        while loop.now() < deadline:
            if await self.cluster._txn_system_healthy():
                return
            await loop.delay(0.2)
        TraceEvent("MachineAttritionHealTimeout", severity=30).log()

    async def check(self) -> bool:
        # Protected machines must never have been killed — refusals are
        # counted, kills of them are a bug in the nemesis itself.
        if any(m.kills > 0 and m.protected for m in self.topo.machines):
            return False
        acted = (self.kills_done + self.reboots_done
                 + self.swizzles_done + self.dc_kills_done
                 + self.permanent_kills_done
                 + self.permanent_log_kills_done
                 + self.permanent_storage_kills_done)
        # At least one action must actually have landed (a nemesis whose
        # every move was refused tested nothing).
        return acted > 0 or not self.deck

    def metrics(self) -> dict:
        return {
            "kills": self.kills_done,
            "reboots": self.reboots_done,
            "swizzles": self.swizzles_done,
            "dc_kills": self.dc_kills_done,
            "permanent_kills": self.permanent_kills_done,
            "permanent_log_kills": self.permanent_log_kills_done,
            "permanent_storage_kills": self.permanent_storage_kills_done,
            "refused": self.refused,
            "protected_kill_attempts": self.topo.protected_kill_attempts,
        }
