"""WriteDuringRead: random API interleavings inside ONE transaction —
reads racing the transaction's own writes — diffed op-by-op against the
RYW model (ref: fdbserver/workloads/WriteDuringRead.actor.cpp +
MemoryKeyValueStore.h).

Every operation is issued to the real transaction AND the model overlay;
any divergence (RYW read, snapshot read, range scan shape, atomic-op
result, committed state) is a failure. Sequential (one txn in flight), so
commit outcomes are deterministic and the committed model tracks exactly.
"""

from __future__ import annotations

from ..client.database import Database
from ..core.runtime import current_loop
from ..kv.atomic import MutationType
from .memory_model import MemoryKeyValueStore, ModelTransaction

_ATOMIC_OPS = [
    MutationType.ADD_VALUE,
    MutationType.AND,
    MutationType.OR,
    MutationType.XOR,
    MutationType.MAX,
    MutationType.MIN,
    MutationType.APPEND_IF_FITS,
    MutationType.BYTE_MIN,
]


class WriteDuringReadWorkload:
    def __init__(self, db: Database, key_space: int = 30,
                 prefix: bytes = b"wdr/"):
        self.db = db
        self.key_space = key_space
        self.prefix = prefix
        self.model = MemoryKeyValueStore()
        self.failures: list[str] = []
        self.ops_done = 0
        self.txns_done = 0

    def _key(self, rng) -> bytes:
        return self.prefix + b"%03d" % rng.random_int(0, self.key_space)

    def _value(self, rng) -> bytes:
        return bytes(
            rng.random_int(0, 256) for _ in range(rng.random_int(1, 9))
        )

    async def _one_op(self, tr, mt: ModelTransaction, rng) -> None:
        kind = rng.random_int(0, 8)
        self.ops_done += 1
        if kind == 0:
            k, v = self._key(rng), self._value(rng)
            tr.set(k, v)
            mt.set(k, v)
        elif kind == 1:
            k = self._key(rng)
            tr.clear(k)
            mt.clear(k)
        elif kind == 2:
            a, b = sorted((self._key(rng), self._key(rng)))
            tr.clear_range(a, b)
            mt.clear_range(a, b)
        elif kind == 3:
            op = _ATOMIC_OPS[rng.random_int(0, len(_ATOMIC_OPS))]
            k, p = self._key(rng), self._value(rng)
            tr.atomic_op(op, k, p)
            mt.atomic_op(op, k, p)
        elif kind in (4, 5):
            # The namesake: a read AFTER writes in the same txn must see
            # them (RYW) — or must NOT, under snapshot isolation.
            snapshot = kind == 5
            k = self._key(rng)
            got = await tr.get(k, snapshot=snapshot)
            want = mt.get(k, snapshot=snapshot)
            if got != want:
                self.failures.append(
                    f"get({k!r}, snapshot={snapshot}) -> {got!r}, "
                    f"model {want!r}"
                )
        else:
            snapshot = kind == 7
            a, b = sorted((self._key(rng), self._key(rng)))
            limit = rng.random_int(0, 6)
            reverse = rng.random_int(0, 2) == 0
            got = await tr.get_range(a, b, limit=limit, reverse=reverse,
                                     snapshot=snapshot)
            want = mt.get_range(a, b, limit=limit, reverse=reverse,
                                snapshot=snapshot)
            if list(got) != list(want):
                self.failures.append(
                    f"get_range({a!r},{b!r},limit={limit},rev={reverse},"
                    f"snap={snapshot}) -> {got!r}, model {want!r}"
                )

    async def run(self, txns: int = 30, ops_per_txn: int = 12) -> None:
        rng = current_loop().random
        for i in range(txns):
            tr = self.db.create_transaction()
            mt = ModelTransaction(self.model)
            # Unique marker OUTSIDE the checked prefix: transactions are
            # atomic, so after a maybe-committed failure (commit reply lost
            # to a recovery/kill) the marker's presence decides exactly
            # whether the model txn landed. Guessing "not committed" here
            # diverged the model under MachineAttrition (a committed txn's
            # keys kept showing up in later range reads).
            marker = self.prefix[:-1] + b"m/%06d" % i
            tr.set(marker, b"1")
            try:
                for _ in range(ops_per_txn):
                    await self._one_op(tr, mt, rng)
                await tr.commit()
            except BaseException as e:  # noqa: BLE001
                from ..core.errors import is_retryable

                if not is_retryable(e):
                    raise
                landed = await self.db.transact(
                    lambda t, k=marker: t.get(k)
                )
                if landed is None:
                    continue  # really dropped from BOTH sides
                # The "failed" commit actually landed: apply the model txn.
            mt.commit_into(self.model)
            self.txns_done += 1
        # Final sweep: committed cluster state equals the model.
        rows = await self.db.transact(
            lambda tr: tr.get_range(self.prefix, self.prefix + b"\xff")
        )
        want = self.model.get_range(self.prefix, self.prefix + b"\xff")
        if list(rows) != list(want):
            self.failures.append(
                f"committed state diverged: {len(rows)} rows vs model "
                f"{len(want)}"
            )

    async def check(self) -> bool:
        return not self.failures
