"""Increment workload (ref: fdbserver/workloads/Increment.actor.cpp).

Each transaction atomically ADDs 1 to two keys drawn from a small
keyspace (the reference increments `key` and `key+nodeCount`), so the
keyspace becomes a ledger whose grand total must equal exactly twice the
number of COMMITTED transactions. Atomic ops never conflict with each
other, yet every committed add must survive recoveries, shard moves and
retries exactly once — a lost or doubled ADD_VALUE (e.g. a retry that
reapplies a commit the client never saw acked) tears the total.

Commit ambiguity (CommitUnknownResult: the link died with the batch in
flight) is the one legitimate slack: a retry after an ambiguous commit
may re-apply the adds. The workload counts those windows and the check
bounds the total inside [2*acked, 2*(acked + ambiguous)] — any total
outside the band is a real lost/doubled mutation (ref: the reference
workload's maybe-committed tolerance in its sum check).
"""

from __future__ import annotations

import struct

from ..client.database import Database
from ..client.transaction import Transaction
from ..core.errors import CommitUnknownResult
from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent

_ONE = struct.pack("<q", 1)


class IncrementWorkload:
    def __init__(self, db: Database, key_space: int = 8,
                 prefix: bytes = b"incr/"):
        self.db = db
        self.key_space = max(1, key_space)
        self.prefix = prefix
        self.txns_done = 0
        self.retries = 0
        self.ambiguous = 0

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%04d" % (i % (2 * self.key_space))

    async def client(self, n_txns: int) -> None:
        rng = current_loop().random
        for _ in range(n_txns):
            i = rng.random_int(0, self.key_space)
            tr = self.db.create_transaction()
            while True:
                try:
                    tr.add(self._key(i), _ONE)
                    tr.add(self._key(i + self.key_space), _ONE)
                    await tr.commit()
                    break
                except BaseException as e:  # noqa: BLE001
                    self.retries += 1
                    if isinstance(e, CommitUnknownResult):
                        # The first attempt may have landed; a re-apply
                        # from here on is legal and widens the check band.
                        self.ambiguous += 1
                    await tr.on_error(e)
            self.txns_done += 1

    async def run(self, clients: int = 3, txns_per_client: int = 15) -> None:
        tasks = [
            spawn(self.client(txns_per_client), name=f"incr_client_{i}")
            for i in range(clients)
        ]
        for t in tasks:
            await t.done

    async def check(self) -> bool:
        """Sum every ledger key (little-endian 8-byte counters): exactly
        2 adds per acked transaction, plus at most 2 per ambiguous-commit
        window a retry may have double-applied through."""
        async def body(tr: Transaction):
            rows = await tr.get_range(self.prefix, self.prefix + b"\xff")
            return sum(struct.unpack("<q", v)[0] for _, v in rows)

        total = await self.db.transact(body)
        lo = 2 * self.txns_done
        hi = 2 * (self.txns_done + self.ambiguous)
        ok = lo <= total <= hi
        TraceEvent("IncrementCheck").detail("Ok", ok).detail(
            "Total", total
        ).detail("Txns", self.txns_done).detail(
            "Ambiguous", self.ambiguous
        ).detail("Retries", self.retries).log()
        return ok
