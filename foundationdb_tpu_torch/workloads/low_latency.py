"""LowLatency workload (ref: fdbserver/workloads/LowLatency.actor.cpp).

A probe loop that periodically runs a minimal GRV+read transaction and
asserts it completes within a latency bound — the reference's canary
that the commit path stays responsive WHILE the rest of the spec's
workloads (and nemeses) run. Probes that overlap a recovery are exempt,
exactly like the reference's `g_simulator.speedUpSimulation` /
in-recovery carve-out: a kill mid-probe legitimately stalls the GRV
until the next generation recruits, and that stall is the recovery
tier's job to bound, not this workload's.

Latency is simulated time (core runtime `now()`), so the bound is
deterministic per seed and independent of host load.
"""

from __future__ import annotations

from ..client.database import Database
from ..core.runtime import current_loop
from ..core.trace import TraceEvent


class LowLatencyWorkload:
    def __init__(self, db: Database, cluster=None, probes: int = 10,
                 interval: float = 0.3, max_latency: float = 5.0,
                 prefix: bytes = b"lowlat/"):
        self.db = db
        self.cluster = cluster
        self.probes = probes
        self.interval = interval
        self.max_latency = max_latency
        self.prefix = prefix
        self.probes_done = 0
        self.slow_probes = 0
        self.exempt_probes = 0
        self.max_seen = 0.0

    def _recoveries(self) -> int:
        return getattr(self.cluster, "recoveries_done", 0) or 0

    async def run(self) -> None:
        loop = current_loop()
        for i in range(self.probes):
            await loop.delay(self.interval * (0.5 + loop.random.random01()))
            before = self._recoveries()
            t0 = loop.now()

            async def body(tr, i=i):
                await tr.get(self.prefix + b"%04d" % i)
                tr.set(self.prefix + b"%04d" % i, b"probe")

            await self.db.transact(body)
            elapsed = loop.now() - t0
            self.probes_done += 1
            self.max_seen = max(self.max_seen, elapsed)
            if elapsed > self.max_latency:
                if self._recoveries() != before:
                    # The probe rode through a recovery window: its
                    # latency measures the recovery, not the steady path.
                    self.exempt_probes += 1
                else:
                    self.slow_probes += 1
                    TraceEvent("LowLatencyProbeSlow", severity=20).detail(
                        "Probe", i
                    ).detail("Elapsed", round(elapsed, 4)).detail(
                        "Bound", self.max_latency
                    ).log()

    async def check(self) -> bool:
        ok = self.slow_probes == 0 and self.probes_done == self.probes
        TraceEvent("LowLatencyCheck").detail("Ok", ok).detail(
            "Probes", self.probes_done
        ).detail("Slow", self.slow_probes).detail(
            "Exempt", self.exempt_probes
        ).detail("MaxSeen", round(self.max_seen, 4)).log()
        return ok

    def metrics(self) -> dict:
        return {"probes": self.probes_done, "slow": self.slow_probes,
                "exempt": self.exempt_probes,
                "max_latency_seen": round(self.max_seen, 4)}
