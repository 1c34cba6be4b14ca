"""Additional tester workloads: VersionStamp, Rollback, BackupRestore.

(ref: fdbserver/workloads/VersionStamp.actor.cpp, Rollback.actor.cpp,
BackupToFileAndRestore-style specs.) Each runs concurrently with fault
workloads under the spec runner; checks are invariants, not smoke.

Development notes (bugs these catch): VersionStamp's post-commit
get_versionstamp() call found the round-5 bug where a stamp requested
after commit resolution registered a promise nothing would ever feed
(client/transaction.py get_versionstamp); Rollback is the spec-driven
form of the acked-writes-survive-kill contract the durable tests pin.
"""

from __future__ import annotations

import struct

from ..core.actors import all_of
from ..core.runtime import current_loop, spawn


class VersionStampWorkload:
    """Concurrent clients append versionstamped keys; every stamp handed
    back by get_versionstamp must be distinct, and the committed rows must
    sort in commit-version order with exactly one row per acked commit
    (ref: VersionStamp.actor.cpp checking stamp/version agreement)."""

    def __init__(self, db, prefix: bytes = b"vs/"):
        self.db = db
        self.prefix = prefix
        self.stamps: list[bytes] = []
        self.acked = 0
        self.failures: list[str] = []

    async def _client(self, i: int, txns: int) -> None:
        for n in range(txns):
            tr = self.db.create_transaction()
            while True:
                try:
                    payload = b"%d:%d" % (i, n)
                    # Bindings convention (api >= 520): 10-byte stamp slot
                    # + 4-byte LE offset suffix naming where it goes.
                    tr.set_versionstamped_key(
                        self.prefix + b"\x00" * 10
                        + struct.pack("<I", len(self.prefix)),
                        payload,
                    )
                    stamp_f = tr.get_versionstamp()
                    await tr.commit()
                    stamp = await stamp_f
                    self.stamps.append(stamp)
                    self.acked += 1
                    break
                except BaseException as e:  # noqa: BLE001
                    from ..core.errors import is_retryable

                    if not is_retryable(e):
                        self.failures.append(
                            f"client {i} txn {n}: {type(e).__name__}: {e}"
                        )
                        return
                    await tr.on_error(e)

    async def run(self, clients: int = 3, txns: int = 8) -> None:
        tasks = [spawn(self._client(i, txns), name=f"vs{i}")
                 for i in range(clients)]
        await all_of([t.done for t in tasks])

    async def check(self) -> bool:
        if self.failures:
            return False
        if len(set(self.stamps)) != len(self.stamps):
            self.failures.append("duplicate versionstamps handed out")
            return False
        from ..kv.keys import strinc

        async def read_all(tr):
            return await tr.get_range(self.prefix, strinc(self.prefix))

        rows = await self.db.transact(read_all)
        if len(rows) != self.acked:
            self.failures.append(
                f"{self.acked} acked stamped rows but {len(rows)} found"
            )
            return False
        keys = [k for k, _ in rows]
        if keys != sorted(keys):
            self.failures.append("stamped keys not in commit order")
            return False
        # Each key embeds its stamp after the prefix; they must match the
        # stamps the clients were handed.
        embedded = {k[len(self.prefix):len(self.prefix) + 10] for k in keys}
        if embedded != {s[:10] for s in self.stamps}:
            self.failures.append("row stamps disagree with get_versionstamp")
            return False
        return True


class RollbackWorkload:
    """Sequentially acked writes with transaction-system kills between
    them: every ACKED write must survive every recovery (the client-visible
    form of 'a committed commit is durable'; ref: Rollback.actor.cpp
    checking no acknowledged data vanishes)."""

    def __init__(self, db, cluster, prefix: bytes = b"rb/"):
        self.db = db
        self.cluster = cluster
        self.prefix = prefix
        self.acked: list[int] = []
        self.failures: list[str] = []

    async def run(self, writes: int = 12, kill_every: int = 4) -> None:
        loop = current_loop()
        # The workload's kills need a recoverer; unique controller name —
        # the election arbitrates BY NAME (see _AttritionWorkload).
        self.cluster.start_controller("rollback-cc")
        for i in range(writes):
            await self.db.set(self.prefix + b"%04d" % i, b"v%d" % i)
            self.acked.append(i)
            if (i + 1) % kill_every == 0 and hasattr(
                self.cluster, "kill_transaction_system"
            ):
                self.cluster.kill_transaction_system()
                # The controller recovers; the next write retries onto the
                # new generation through the client machinery.
                await loop.delay(0.1)

    async def check(self) -> bool:
        # The harness runs check() strictly after every run() finished;
        # nothing appends to acked once the verification phase starts.
        # fdblint: allow[await-iter-invalidate] -- phases are sequential
        for i in self.acked:
            got = await self.db.get(self.prefix + b"%04d" % i)
            if got != b"v%d" % i:
                self.failures.append(f"acked write {i} lost: {got!r}")
        return not self.failures


class BackupRestoreWorkload:
    """Snapshot backup taken mid-traffic, restored into a scratch prefix:
    the backed-up invariant pair (two keys kept equal by a concurrent
    writer) must never tear in the restored image (ref: the backup
    correctness specs asserting restorable consistency)."""

    def __init__(self, db, prefix: bytes = b"bk/"):
        self.db = db
        self.prefix = prefix
        self.failures: list[str] = []
        self._stop = False

    async def _writer(self) -> None:
        n = 0
        while not self._stop:
            n += 1

            async def body(tr, n=n):
                tr.set(self.prefix + b"a", b"%d" % n)
                tr.set(self.prefix + b"b", b"%d" % n)

            await self.db.transact(body)

    async def run(self, snapshots: int = 2) -> None:
        import tempfile

        from .. import backup as bk
        from ..kv.keys import strinc

        writer = spawn(self._writer(), name="bkWriter")
        self.images: list[str] = []
        tmpdir = tempfile.mkdtemp(prefix="fdbtpu_bk_")
        for n in range(snapshots):
            await current_loop().delay(0.2)
            path = f"{tmpdir}/snap{n}"
            while True:
                # A snapshot whose read version aged out of the MVCC
                # window (slow progress under faults) restarts at a
                # FRESH version; link errors inside retry in bk.backup.
                try:
                    await bk.backup(self.db, path, begin=self.prefix,
                                    end=strinc(self.prefix))
                    break
                except BaseException as e:  # noqa: BLE001
                    from ..core.errors import is_retryable

                    if not is_retryable(e):
                        self.failures.append(
                            f"snapshot {n}: {type(e).__name__}: {e}"
                        )
                        break
                    await current_loop().delay(0.2)
            self.images.append(path)
        self._stop = True
        await writer.done

    async def check(self) -> bool:
        from .. import backup as bk

        for path in self.images:
            # fdblint: allow[async-blocking] -- check() runs in the tester's validation phase after the workload stops; it inspects finished snapshot container files, not a serving path.
            with open(path, "rb") as f:
                bk.read_snapshot_header(f)
                rows = dict(bk._read_recs(f))
            a = rows.get(self.prefix + b"a")
            b = rows.get(self.prefix + b"b")
            if a != b:
                self.failures.append(f"torn snapshot: a={a!r} b={b!r}")
        return not self.failures
