"""RandomClogging as a FIRST-CLASS spec workload (ref: fdbserver/
workloads/RandomClogging.actor.cpp — periodically clog machine
interfaces and link pairs off the deterministic PRNG, with the swizzle
variant clogging a machine subset and unclogging in a different random
order; until now the repo only had the harness-level helper in
sim/harness.py, which no spec could draw).

Actions (deck shuffled off the loop PRNG): "clog" one machine's whole
interface, "pair" a machine-pair link, "swizzle" the staggered
multi-machine clog/unclog. All of it drives sim/network.py's clog
machinery over the topology's machine processes.

check() audits the arsenal itself, which is what caught the seeded bug
this workload was built against (an unclog that silently no-ops leaves
the network partitioned forever — every later workload just times out
with no pointer to why):

- no residual clog may outlive the workload (the swizzle's parked
  1000-second clogs MUST have been lifted explicitly);
- traffic must actually have flowed across the clog windows;
- the cluster must answer a commit probe after the closing heal.
"""

from __future__ import annotations

from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent


class RandomCloggingWorkload:
    def __init__(self, topology, interval: float = 0.5, clogs: int = 2,
                 pairs: int = 1, swizzles: int = 1, max_clog: float = 0.8):
        self.topo = topology
        self.net = topology.net
        self.cluster = topology.cluster
        self.interval = interval
        self.max_clog = max_clog
        self.deck = (["clog"] * clogs + ["pair"] * pairs
                     + ["swizzle"] * swizzles)
        self.clogs_done = 0
        self.pair_clogs_done = 0
        self.swizzles_done = 0
        self.failures: list[str] = []
        self._task = None

    def start(self) -> "RandomCloggingWorkload":
        self._task = spawn(self._run(), name="randomClogging")
        return self

    @property
    def done(self):
        return self._task.done

    def _pick_machine(self, random):
        return self.topo.machines[
            random.random_int(0, len(self.topo.machines))
        ]

    async def _run(self):
        loop = current_loop()
        random = loop.random
        sent_before = self.net.messages_sent
        deck = list(self.deck)
        for i in range(len(deck) - 1, 0, -1):
            j = random.random_int(0, i + 1)
            deck[i], deck[j] = deck[j], deck[i]
        for action in deck:
            await loop.delay(self.interval * (0.5 + random.random01()))
            if action == "clog":
                m = self._pick_machine(random)
                self.net.clog_process(
                    m.proc, self.max_clog * (0.2 + 0.8 * random.random01())
                )
                self.clogs_done += 1
            elif action == "pair":
                a = self._pick_machine(random)
                b = self._pick_machine(random)
                if a is not b:
                    self.net.clog_pair_sets(
                        [a.proc], [b.proc],
                        self.max_clog * (0.2 + 0.8 * random.random01()),
                    )
                self.pair_clogs_done += 1
            elif action == "swizzle":
                await self.net.swizzle_clog(
                    [[m.proc] for m in self.topo.machines
                     if not m.protected],
                    random, self.max_clog,
                )
                self.swizzles_done += 1
        # Let every timed clog expire before the closing audit.
        await loop.delay(self.max_clog + 0.1)
        TraceEvent("RandomCloggingDone").detail(
            "Clogs", self.clogs_done
        ).detail("Swizzles", self.swizzles_done).log()

    async def check(self) -> bool:
        loop = current_loop()
        now = loop.now()
        residual = sorted(
            p for p, until in self.net._proc_clogged_until.items()
            if until > now + self.max_clog
        )
        if residual:
            # A parked swizzle clog (explicit-unclog machinery broken):
            # the network never heals and every later workload starves.
            self.failures.append(
                f"residual clogs outlive the workload: {residual}"
            )
        if self.net.messages_sent == 0:
            self.failures.append("no traffic crossed the network at all")
        if not await self.cluster._txn_system_healthy():
            self.failures.append(
                "cluster does not answer a commit probe after the heal"
            )
        acted = self.clogs_done + self.pair_clogs_done + self.swizzles_done
        return not self.failures and (acted > 0 or not self.deck)

    def metrics(self) -> dict:
        return {
            "clogs": self.clogs_done,
            "pair_clogs": self.pair_clogs_done,
            "swizzles": self.swizzles_done,
            "messages_sent": self.net.messages_sent,
            "messages_dropped": self.net.messages_dropped,
            "failures": self.failures[:3],
        }
