"""ReadWrite: the standard throughput/latency workload (ref:
fdbserver/workloads/ReadWrite.actor.cpp — N clients issuing transactions
with a fixed read/write mix over a keyspace, reporting PerfMetrics)."""

from __future__ import annotations

from ..client.database import Database
from ..core.actors import all_of
from ..core.runtime import current_loop, spawn
from ..core.stats import ContinuousSample


class ReadWriteWorkload:
    def __init__(self, db: Database, key_space: int = 1000,
                 reads_per_txn: int = 5, writes_per_txn: int = 2,
                 prefix: bytes = b"rw/"):
        self.db = db
        self.key_space = key_space
        self.reads_per_txn = reads_per_txn
        self.writes_per_txn = writes_per_txn
        self.prefix = prefix
        self.txns_done = 0
        self.retries = 0
        self.latency = ContinuousSample(size=500)
        self._elapsed = 0.0

    def _key(self, rng) -> bytes:
        return self.prefix + b"%06d" % rng.random_int(0, self.key_space)

    async def _one(self) -> None:
        loop = current_loop()
        rng = loop.random
        t0 = loop.now()
        tr = self.db.create_transaction()
        while True:
            try:
                for _ in range(self.reads_per_txn):
                    await tr.get(self._key(rng))
                for _ in range(self.writes_per_txn):
                    tr.set(self._key(rng), b"v%d" % rng.random_int(0, 1 << 20))
                await tr.commit()
                break
            except BaseException as e:  # noqa: BLE001
                self.retries += 1
                await tr.on_error(e)
        self.txns_done += 1
        self.latency.add_sample(loop.now() - t0)

    async def run(self, clients: int = 8, duration: float = 5.0) -> None:
        loop = current_loop()
        stop_at = loop.now() + duration

        async def client():
            while loop.now() < stop_at:
                await self._one()

        t0 = loop.now()
        tasks = [spawn(client(), name=f"rw_client_{i}")
                 for i in range(clients)]
        await all_of([t.done for t in tasks])
        self._elapsed = loop.now() - t0

    def metrics(self) -> dict:
        """(ref: PerfMetric output of the reference workload)."""
        return {
            "transactions": self.txns_done,
            "retries": self.retries,
            "tps": self.txns_done / self._elapsed if self._elapsed else 0.0,
            "reads_per_sec": self.txns_done * self.reads_per_txn
            / self._elapsed if self._elapsed else 0.0,
            "writes_per_sec": self.txns_done * self.writes_per_txn
            / self._elapsed if self._elapsed else 0.0,
            "latency_p50_s": self.latency.percentile(0.5),
            "latency_p95_s": self.latency.percentile(0.95),
        }
