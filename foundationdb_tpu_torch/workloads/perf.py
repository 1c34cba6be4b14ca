"""Performance workloads reporting PerfMetrics through the tester (ref:
fdbserver/workloads/Throughput.actor.cpp and QueuePush.actor.cpp — the
reference's perf suite reports metrics via PerfMetric rows rather than
pass/fail)."""

from __future__ import annotations

from ..client.database import Database
from ..core.runtime import current_loop, spawn


def _percentile(xs: list[float], p: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


class ThroughputWorkload:
    """Timed random read/write transaction load; reports tps and commit
    latency percentiles (ref: Throughput.actor.cpp's TPS/latency rows)."""

    def __init__(self, db: Database, key_space: int = 400,
                 ops_per_txn: int = 4, prefix: bytes = b"tp/"):
        self.db = db
        self.key_space = key_space
        self.ops_per_txn = ops_per_txn
        self.prefix = prefix
        self.txns_done = 0
        self.errors = 0
        self._latencies: list[float] = []
        self._elapsed = 0.0

    async def _client(self, deadline: float) -> None:
        loop = current_loop()
        rng = loop.random
        while loop.now() < deadline:
            t0 = loop.now()
            try:
                async def body(tr):
                    for _ in range(self.ops_per_txn):
                        k = self.prefix + b"%05d" % rng.random_int(
                            0, self.key_space
                        )
                        if rng.random_int(0, 2):
                            tr.set(k, b"v%011d" % rng.random_int(0, 10**9))
                        else:
                            await tr.get(k)

                await self.db.transact(body)
                self.txns_done += 1
                self._latencies.append(loop.now() - t0)
            except BaseException:  # noqa: BLE001 — fault windows count
                self.errors += 1

    async def run(self, clients: int = 8, duration: float = 3.0) -> None:
        loop = current_loop()
        t0 = loop.now()
        deadline = t0 + duration
        tasks = [spawn(self._client(deadline)) for _ in range(clients)]
        for t in tasks:
            await t.done
        self._elapsed = max(loop.now() - t0, 1e-9)

    def metrics(self) -> dict:
        return {
            "txns": self.txns_done,
            "tps": round(self.txns_done / self._elapsed, 1),
            "errors": self.errors,
            "commit_p50_ms": round(
                _percentile(self._latencies, 0.5) * 1e3, 2
            ),
            "commit_p99_ms": round(
                _percentile(self._latencies, 0.99) * 1e3, 2
            ),
        }


class QueuePushWorkload:
    """Append-heavy sequential-key load — the commit-pipeline saturator
    (ref: QueuePush.actor.cpp: contiguous inserts measuring bytes/s)."""

    def __init__(self, db: Database, value_bytes: int = 512,
                 prefix: bytes = b"qp/"):
        self.db = db
        self.value_bytes = value_bytes
        self.prefix = prefix
        self.pushes = 0
        self.bytes_pushed = 0
        self.errors = 0
        self._elapsed = 0.0

    async def _client(self, cid: int, deadline: float) -> None:
        loop = current_loop()
        seq = 0
        value = b"q" * self.value_bytes
        while loop.now() < deadline:
            k = self.prefix + b"%02d/%09d" % (cid, seq)
            try:
                await self.db.set(k, value)
                self.pushes += 1
                self.bytes_pushed += len(k) + len(value)
                seq += 1
            except BaseException:  # noqa: BLE001
                self.errors += 1

    async def run(self, clients: int = 4, duration: float = 3.0) -> None:
        loop = current_loop()
        t0 = loop.now()
        deadline = t0 + duration
        tasks = [spawn(self._client(i, deadline)) for i in range(clients)]
        for t in tasks:
            await t.done
        self._elapsed = max(loop.now() - t0, 1e-9)

    def metrics(self) -> dict:
        return {
            "pushes": self.pushes,
            "bytes": self.bytes_pushed,
            "bytes_per_s": round(self.bytes_pushed / self._elapsed),
            "errors": self.errors,
        }
