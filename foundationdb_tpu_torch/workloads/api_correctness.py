"""ApiCorrectness: randomized operations diffed against an in-memory model
(ref: fdbserver/workloads/ApiCorrectness.actor.cpp + the Serializability/
WriteDuringRead family, which diff against workloads/MemoryKeyValueStore).

Each transaction performs a random mix of get/get_range/set/clear/
clear_range/atomic ops against BOTH the real database and a plain in-memory
model, comparing every read result inside the transaction (this exercises
read-your-writes against the model's immediate-apply semantics). On commit
success the model's staged state is promoted; on conflict/retry it is
discarded — exactly a serializable history, so any divergence is a bug in
RYW, the commit pipeline, storage MVCC, or the conflict kernel.
"""

from __future__ import annotations

from typing import Optional

from ..client.database import Database
from ..core.errors import CommitUnknownResult
from ..core.runtime import current_loop
from ..kv.atomic import MutationType, apply_atomic
from ..kv.keys import key_after


class ModelKV:
    """The reference's MemoryKeyValueStore: a dict with ordered range ops."""

    def __init__(self):
        self.data: dict[bytes, bytes] = {}

    def clone(self) -> "ModelKV":
        m = ModelKV()
        m.data = dict(self.data)
        return m

    def get(self, key: bytes) -> Optional[bytes]:
        return self.data.get(key)

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False):
        keys = sorted(k for k in self.data if begin <= k < end)
        if reverse:
            keys.reverse()
        if limit:
            keys = keys[:limit]
        return [(k, self.data[k]) for k in keys]

    def set(self, key: bytes, value: bytes) -> None:
        self.data[key] = value

    def clear_range(self, begin: bytes, end: bytes) -> None:
        for k in [k for k in self.data if begin <= k < end]:
            del self.data[k]

    def atomic(self, op: MutationType, key: bytes, param: bytes) -> None:
        new = apply_atomic(op, self.data.get(key), param)
        if new is None:
            self.data.pop(key, None)
        else:
            self.data[key] = new


class ApiCorrectnessWorkload:
    ATOMIC_OPS = [
        MutationType.ADD_VALUE, MutationType.AND, MutationType.OR,
        MutationType.XOR, MutationType.MAX, MutationType.MIN,
        MutationType.BYTE_MIN, MutationType.BYTE_MAX,
        MutationType.APPEND_IF_FITS,
    ]

    def __init__(self, db: Database, key_space: int = 40,
                 prefix: bytes = b"api/"):
        self.db = db
        self.key_space = key_space
        self.prefix = prefix
        self.model = ModelKV()
        self.mismatches: list[str] = []
        self.txns_done = 0
        self.ops_done = 0

    def _key(self) -> bytes:
        rng = current_loop().random
        return self.prefix + b"%04d" % rng.random_int(0, self.key_space)

    def _value(self) -> bytes:
        rng = current_loop().random
        return bytes(
            rng.random_int(97, 123) for _ in range(rng.random_int(1, 9))
        )

    async def _one_txn(self) -> None:
        rng = current_loop().random
        tr = self.db.create_transaction()
        while True:
            staged = self.model.clone()
            # Per-attempt marker: resolves the maybe-committed ambiguity.
            # A lost commit reply (commit_unknown_result) from an attempt
            # that actually landed would otherwise leave non-idempotent
            # mutations in the database but not the model — the reference's
            # self-checking workloads use the same dedup-key pattern.
            marker = self.prefix + b"txn-%016x" % rng.random_int(0, 2**62)
            try:
                tr.set(marker, b"1")
                staged.set(marker, b"1")
                n_ops = rng.random_int(1, 9)
                for _ in range(n_ops):
                    await self._one_op(tr, staged)
                    self.ops_done += 1
                await tr.commit()
                self.model = staged
                self.txns_done += 1
                return
            except BaseException as e:  # noqa: BLE001
                unknown = isinstance(e, CommitUnknownResult)
                await tr.on_error(e)
                if unknown and await self.db.get(marker) is not None:
                    self.model = staged
                    self.txns_done += 1
                    return

    async def _one_op(self, tr, staged: ModelKV) -> None:
        rng = current_loop().random
        kind = rng.random_int(0, 6)
        if kind == 0:
            k = self._key()
            got = await tr.get(k)
            want = staged.get(k)
            if got != want:
                self.mismatches.append(f"get({k!r}): {got!r} != {want!r}")
        elif kind == 1:
            a, b = sorted((self._key(), self._key()))
            limit = rng.random_int(0, 6)
            reverse = rng.coinflip(0.3)
            got = await tr.get_range(a, b, limit=limit, reverse=reverse)
            want = staged.get_range(a, b, limit=limit, reverse=reverse)
            if got != want:
                self.mismatches.append(
                    f"get_range({a!r},{b!r},{limit},{reverse}): "
                    f"{got!r} != {want!r}"
                )
        elif kind == 2:
            k, v = self._key(), self._value()
            tr.set(k, v)
            staged.set(k, v)
        elif kind == 3:
            k = self._key()
            tr.clear(k)
            staged.clear_range(k, key_after(k))
        elif kind == 4:
            a, b = sorted((self._key(), self._key()))
            tr.clear_range(a, b)
            staged.clear_range(a, b)
        else:
            k = self._key()
            op = self.ATOMIC_OPS[rng.random_int(0, len(self.ATOMIC_OPS))]
            param = self._value()
            tr.atomic_op(op, k, param)
            staged.atomic(op, k, param)

    async def run(self, txns: int) -> None:
        """Sequential by design: the model promotes at commit points, so a
        single client gives an exact serial history to diff against (the
        reference's ApiCorrectness is likewise self-checking; CONCURRENT
        conflict coverage is the Cycle workload's job)."""
        for _ in range(txns):
            await self._one_txn()

    def check(self) -> bool:
        return not self.mismatches
