"""Cycle workload (ref: fdbserver/workloads/Cycle.actor.cpp).

`nodes` keys form a single directed cycle: key i stores the index of its
successor. Each transaction reads a chain A -> B -> C -> D and rewires it
to A -> C -> B -> D (swapping B and C), which preserves the single-cycle
invariant only under serializable execution. Concurrent clients racing on
overlapping nodes produce real conflicts that MUST abort (OCC) — a lost
update tears the permutation.

check(): walk successors from node 0; after exactly `nodes` steps the walk
must visit every node once and return to 0. Any torn transaction (partially
applied writes, resolved-but-unlogged commits, wrong conflict verdicts)
breaks this.
"""

from __future__ import annotations

import struct

from ..client.database import Database
from ..client.transaction import Transaction
from ..core.runtime import current_loop, spawn
from ..core.trace import TraceEvent


def _k(prefix: bytes, i: int) -> bytes:
    return prefix + struct.pack(">I", i)


def _v(i: int) -> bytes:
    return struct.pack(">I", i)


class CycleWorkload:
    def __init__(self, db: Database, nodes: int = 16, prefix: bytes = b"cycle/"):
        self.db = db
        self.nodes = nodes
        self.prefix = prefix
        self.txns_done = 0
        self.retries = 0

    async def setup(self) -> None:
        async def body(tr: Transaction):
            for i in range(self.nodes):
                tr.set(_k(self.prefix, i), _v((i + 1) % self.nodes))

        await self.db.transact(body)

    async def cycle_transaction(self, tr: Transaction) -> None:
        """(ref: Cycle.actor.cpp cycleTransaction)."""
        rng = current_loop().random
        a = rng.random_int(0, self.nodes)
        b_raw = await tr.get(_k(self.prefix, a))
        b = struct.unpack(">I", b_raw)[0]
        c_raw = await tr.get(_k(self.prefix, b))
        c = struct.unpack(">I", c_raw)[0]
        d_raw = await tr.get(_k(self.prefix, c))
        d = struct.unpack(">I", d_raw)[0]
        # Move node C to sit between A and B: A->C, C->B, B->D.
        tr.set(_k(self.prefix, a), _v(c))
        tr.set(_k(self.prefix, c), _v(b))
        tr.set(_k(self.prefix, b), _v(d))

    async def client(self, n_txns: int) -> None:
        for _ in range(n_txns):
            tr = self.db.create_transaction()
            while True:
                try:
                    await self.cycle_transaction(tr)
                    await tr.commit()
                    break
                except BaseException as e:  # noqa: BLE001
                    self.retries += 1
                    await tr.on_error(e)
            self.txns_done += 1

    async def start(self, clients: int = 4, txns_per_client: int = 25) -> None:
        tasks = [
            spawn(self.client(txns_per_client), name=f"cycle_client_{i}")
            for i in range(clients)
        ]
        for t in tasks:
            await t.done

    async def check(self) -> bool:
        """Walk the ring; it must be a single cycle over all nodes."""
        async def body(tr: Transaction):
            seen = []
            cur = 0
            for _ in range(self.nodes):
                seen.append(cur)
                raw = await tr.get(_k(self.prefix, cur))
                if raw is None:
                    return None
                cur = struct.unpack(">I", raw)[0]
            return cur, sorted(seen)

        result = await self.db.transact(body)
        ok = (
            result is not None
            and result[0] == 0
            and result[1] == list(range(self.nodes))
        )
        TraceEvent("CycleCheck").detail("Ok", ok).detail(
            "Txns", self.txns_done
        ).detail("Retries", self.retries).log()
        return ok
