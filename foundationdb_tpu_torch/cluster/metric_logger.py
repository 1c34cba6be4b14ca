"""MetricLogger: time-series metrics persisted INTO the database itself
(ref: flow/TDMetric.actor.h + fdbclient/MetricLogger.actor.cpp — the
reference writes counter samples under a system-key subspace so operators
can query the cluster's history from the cluster).

Layout (tuple-encoded under \\xff/metrics/):

    ("m", collection_id, counter_name, time_bucket) -> (total, rate)

One logger actor samples its sources on an interval and writes each
counter's cumulative total + windowed rate; `read_series` returns the
stored series for dashboards/tests. Sources are either legacy
CounterCollections (register()) or — the metrics-plane default — THE
per-process MetricRegistry (``MetricLogger(db, registry=...)`` persists
every counter-kind instrument under collection "registry", keyed by its
dotted name).

RETENTION: each flush prunes buckets older than
SERVER_KNOBS.METRICS_RETENTION_SECONDS (sim-randomized), so the
subspace stops growing without bound — before this, every sample ever
written stayed forever and nothing read them."""

from __future__ import annotations

import struct
from typing import Optional

from ..core.errors import ActorCancelled
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import Task, current_loop, spawn
from ..core.stats import CounterCollection
from ..layers import tuple as tuplelayer

METRICS_PREFIX = b"\xff/metrics/"


def _key(collection: str, counter: str, bucket: int) -> bytes:
    return METRICS_PREFIX + tuplelayer.pack((collection, counter, bucket))


def _value(total: int, rate: float) -> bytes:
    return struct.pack("<qd", total, rate)


class MetricLogger:
    def __init__(self, db, interval: float = 1.0, registry=None):
        self.db = db
        self.interval = interval
        self.registry = registry
        self._collections: list[CounterCollection] = []
        self._last: dict[tuple[str, str], int] = {}
        self._task: Optional[Task] = None

    def register(self, collection: CounterCollection) -> None:
        self._collections.append(collection)

    def start(self) -> "MetricLogger":
        self._task = spawn(self._run(), name="metricLogger")
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def _sample_sources(self, bucket: int) -> list:
        """(collection, counter, bucket, total, rate) rows this tick."""
        samples = []
        for coll in self._collections:
            for c in coll.counters:
                prev = self._last.get((coll.name, c.name), 0)
                rate = (c.total - prev) / self.interval
                self._last[(coll.name, c.name)] = c.total
                samples.append((coll.name, c.name, bucket, c.total, rate))
        if self.registry is not None:
            for m in self.registry.snapshot(volatile=False):
                if m["kind"] != "counter" or m["labels"]:
                    continue  # labeled counters: per-label series is the
                    # scrape plane's job, not the in-database historian's
                total = m["value"]
                prev = self._last.get(("registry", m["name"]), 0)
                rate = (total - prev) / self.interval
                self._last[("registry", m["name"])] = total
                samples.append(("registry", m["name"], bucket, total, rate))
        return samples

    async def _run(self):
        loop = current_loop()
        while True:
            await loop.delay(self.interval)
            bucket = int(loop.now() / self.interval)
            samples = self._sample_sources(bucket)
            if not samples:
                continue
            # Retention: everything older than the knob horizon goes,
            # per written series (the bucket component sorts last in the
            # tuple encoding, so the prune is one clear_range per series).
            cutoff = bucket - int(
                SERVER_KNOBS.METRICS_RETENTION_SECONDS / self.interval
            )

            async def body(tr, samples=samples, cutoff=cutoff):
                tr.options.set_access_system_keys()
                for coll_name, cname, b, total, rate in samples:
                    tr.set(_key(coll_name, cname, b), _value(total, rate))
                    if cutoff > 0:
                        tr.clear_range(_key(coll_name, cname, 0),
                                       _key(coll_name, cname, cutoff))

            try:
                await self.db.transact(body)
            except ActorCancelled:
                raise  # stop() must be prompt, not diverted
            except Exception:  # noqa: BLE001 — metrics are best-effort
                pass


async def read_series(db, collection: str, counter: str,
                      limit: int = 0, min_bucket: Optional[int] = None,
                      max_bucket: Optional[int] = None
                      ) -> list[tuple[int, int, float]]:
    """[(time_bucket, total, rate)] for one counter, oldest first (ref:
    the TDMetric read path MetricLogger's consumers use). `min_bucket` /
    `max_bucket` bound the scanned range server-side (inclusive /
    exclusive), and `limit` caps the row count — a long-lived series
    must be range-limited, not slurped whole."""
    if min_bucket is not None:
        b = _key(collection, counter, min_bucket)
    else:
        b = METRICS_PREFIX + tuplelayer.pack((collection, counter))
    if max_bucket is not None:
        e = _key(collection, counter, max_bucket)
    else:
        e = METRICS_PREFIX + tuplelayer.pack((collection, counter)) + b"\xff"

    async def body(tr):
        tr.options.set_read_system_keys()
        return await tr.get_range(b, e, limit=limit)

    rows = await db.transact(body)
    out = []
    for k, v in rows:
        bucket = tuplelayer.unpack(k[len(METRICS_PREFIX):])[-1]
        total, rate = struct.unpack("<qd", v)
        out.append((bucket, total, rate))
    return out
