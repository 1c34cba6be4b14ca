"""Backup/restore: consistent range snapshots to a file container (ref:
fdbclient/FileBackupAgent.actor.cpp + BackupContainer.actor.cpp; design/
backup.md — range snapshots plus mutation logs).

This is the snapshot half of the reference's scheme: the whole keyspace
(or a range) is read in chunks AT ONE READ VERSION — MVCC makes the
snapshot transactionally consistent without blocking writers — and written
to a length-prefixed container file with the snapshot version in the
header. Restore clears the target range and writes the rows back in
chunked transactions. The continuous mutation-log half (point-in-time
restore between snapshots) layers on the same container format later.

The snapshot must finish within the MVCC read window (5s of versions) —
the same constraint the reference handles by splitting snapshots into
many short range tasks (TaskBucket); chunking here keeps each read short,
and a too-slow snapshot surfaces as transaction_too_old, never as a torn
backup.
"""

from __future__ import annotations

import os
import struct

from .client.database import Database
from .core.trace import TraceEvent

MAGIC = b"FDBTPUB1"   # legacy header: magic + i64 snapshot version
# Versioned header (durable-format lattice, core/serialize.DURABLE_FORMAT):
# magic + u32 format revision + i64 snapshot version. Readers accept both
# magics; a B2 stamp outside [min_compatible, current] refuses with the
# typed IncompatibleProtocolVersion instead of mis-decoding.
MAGIC2 = b"FDBTPUB2"
_LEN = struct.Struct("<I")
# System-space key marking a restore in progress (ref: the reference's
# restore lock in `\xff` — fdbclient/SystemData restore keys).
RESTORE_MARKER = b"\xff/restoreInProgress"


def read_snapshot_header(f) -> tuple[int, int]:
    """Read + lattice-check a container header; returns (format_version,
    snapshot_version). Raises ValueError for a non-container file and
    IncompatibleProtocolVersion for a stamp outside the lattice (a
    snapshot written by a newer binary refuses cleanly, never tears)."""
    from .core.serialize import DURABLE_FORMAT

    magic = f.read(len(MAGIC))
    if magic == MAGIC:
        # Unstamped legacy container == durable revision 1.
        DURABLE_FORMAT.check_durable(1, "snapshot container")
        (version,) = struct.unpack("<q", f.read(8))
        return 1, version
    if magic == MAGIC2:
        (fv,) = struct.unpack("<I", f.read(4))
        DURABLE_FORMAT.check_durable(fv, "snapshot container")
        (version,) = struct.unpack("<q", f.read(8))
        return fv, version
    raise ValueError("not a backup container (bad magic)")


def _write_rec(f, key: bytes, value: bytes) -> None:
    f.write(_LEN.pack(len(key)) + key + _LEN.pack(len(value)) + value)


def _read_recs(f):
    while True:
        raw = f.read(_LEN.size)
        if not raw:
            return
        (klen,) = _LEN.unpack(raw)
        key = f.read(klen)
        (vlen,) = _LEN.unpack(f.read(_LEN.size))
        value = f.read(vlen)
        yield key, value


async def _write_snapshot(out, tr, version: int, begin: bytes, end: bytes,
                          chunk_rows: int) -> int:
    """ONE implementation of the snapshot wire format (header + records),
    shared by the file and container paths; returns rows written."""
    from .core.serialize import DURABLE_FORMAT
    from .kv.keys import key_after

    out.write(MAGIC2 + struct.pack("<I", DURABLE_FORMAT.stamp())
              + struct.pack("<q", version))
    rows = 0
    cursor = begin
    while True:
        # Snapshot reads at a fixed version are idempotent: transient
        # LINK failures retry rather than aborting a long backup (the
        # reference's backup tasks retry their range reads the same way).
        # transaction_too_old is NOT retried here — the snapshot version
        # has aged out of the MVCC window and only a fresh backup (new
        # version) can make progress; retrying the same version would spin
        # forever.
        while True:
            try:
                chunk = await tr.get_range(cursor, end, limit=chunk_rows,
                                           snapshot=True)
                break
            except BaseException as e:  # noqa: BLE001
                from .core.errors import (
                    BrokenPromise,
                    ConnectionFailed,
                    RequestMaybeDelivered,
                    TimedOut,
                )

                if not isinstance(e, (RequestMaybeDelivered,
                                      ConnectionFailed, BrokenPromise,
                                      TimedOut)):
                    raise
                from .core.runtime import current_loop

                await current_loop().delay(0.1)
        for k, v in chunk:
            _write_rec(out, k, v)
            rows += 1
        if len(chunk) < chunk_rows:
            break
        cursor = key_after(chunk[-1][0])
    return rows


async def backup(
    db: Database,
    path: str,
    begin: bytes = b"",
    end: bytes = b"\xff",
    chunk_rows: int = 1000,
) -> int:
    """Snapshot [begin, end) to `path`; returns the snapshot version."""
    tr = db.create_transaction()
    version = await tr.get_read_version()
    rows = 0
    tmp = path + ".part"
    try:
        # fdblint: allow[async-blocking] -- backup containers are host-local files outside the storage seam; writes land between awaited read chunks and are instantaneous under simulation (no sim-disk model for containers yet).
        with open(tmp, "wb") as f:
            rows = await _write_snapshot(f, tr, version, begin, end,
                                         chunk_rows)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        # A failed snapshot (e.g. transaction_too_old past the MVCC
        # window) must not leave partial containers behind.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)  # atomic publish: a backup file is always complete
    TraceEvent("BackupComplete").detail("Path", path).detail(
        "Version", version
    ).detail("Rows", rows).log()
    return version


async def restore(
    db: Database,
    path: str,
    begin: bytes = b"",
    end: bytes = b"\xff",
    chunk_rows: int | None = None,
) -> int:
    """Replace [begin, end) with the backup's contents; returns the row
    count (ref: restore applies range files then replays logs — only the
    range half exists here).

    NOT atomic: the clear and the chunked writes are separate transactions
    (a snapshot can exceed the one-transaction size limit). As in the
    reference, the range is marked being-restored for the duration
    (RESTORE_MARKER in the `\\xff` system space): a crashed restore is
    detectable by the marker and must be re-run to completion, and writers
    of the range should be quiesced while it is set."""
    if chunk_rows is None:
        from .core.knobs import CLIENT_KNOBS

        chunk_rows = CLIENT_KNOBS.RESTORE_WRITE_BATCH_ROWS
    total = 0
    marker = RESTORE_MARKER

    async def begin_body(tr):
        tr.options.set_access_system_keys()
        tr.set(marker, path.encode())
        tr.clear_range(begin, end)

    # fdblint: allow[async-blocking] -- restore streams a host-local container file; same no-sim-disk-model rationale as the snapshot writer above.
    with open(path, "rb") as f:
        read_snapshot_header(f)  # format-lattice check BEFORE the clear
        await db.transact(begin_body)
        recs = _read_recs(f)
        while True:
            chunk = []
            for rec in recs:
                chunk.append(rec)
                if len(chunk) >= chunk_rows:
                    break
            if not chunk:
                break

            async def write_body(tr, chunk=chunk):
                for k, v in chunk:
                    tr.set(k, v)

            await db.transact(write_body)
            total += len(chunk)

    async def finish_body(tr):
        tr.options.set_access_system_keys()
        tr.clear(marker)

    await db.transact(finish_body)
    TraceEvent("RestoreComplete").detail("Path", path).detail(
        "Rows", total
    ).log()
    return total


# -- container-addressed backups (ref: BackupContainer.actor.cpp URLs) --

async def backup_to_container(db: Database, url: str, begin: bytes = b"",
                              end: bytes = b"\xff",
                              chunk_rows: int = 1000) -> int:
    """Snapshot into a container (file:// dir, memory:// store): the
    snapshot file lands under snapshots/ named by its version, so the
    container accumulates a restorable history (ref: the reference's
    snapshot sets + describeBackup)."""
    import io

    from .backup_container import open_container

    container = open_container(url)
    tr = db.create_transaction()
    version = await tr.get_read_version()
    buf = io.BytesIO()
    rows = await _write_snapshot(buf, tr, version, begin, end, chunk_rows)
    container.write_file(container.snapshot_name(version), buf.getvalue())
    TraceEvent("BackupComplete").detail("Container", url).detail(
        "Version", version
    ).detail("Rows", rows).log()
    return version


async def restore_from_container(db: Database, url: str,
                                 version: int | None = None,
                                 begin: bytes = b"",
                                 end: bytes = b"\xff") -> int:
    """Restore the container's snapshot at `version` (default: latest
    restorable) into [begin, end); returns rows restored."""
    import io
    import tempfile

    from .backup_container import open_container

    container = open_container(url)
    if version is None:
        version = container.latest_restorable_version()
        if version is None:
            raise ValueError(f"container {url} holds no snapshots")
    data = container.read_file(container.snapshot_name(version))
    # Reuse the file-based restore: materialize to a temp file (restore
    # streams records and owns the marker protocol).
    with tempfile.NamedTemporaryFile(suffix=".fdbsnap", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        return await restore(db, tmp, begin, end)
    finally:
        os.unlink(tmp)


# -- continuous backup: range snapshot + mutation-log shipping --
# (ref: design/backup.md:1-40 — the full scheme is a snapshot set PLUS the
# mutation log between snapshots; fdbclient/FileBackupAgent.actor.cpp's
# log tasks. The shipping mechanism is the same dedicated log tag DR uses:
# every mutation reaches the backup's cursor, batches land in the
# container as version-named log files, and restore_to_version replays
# them over the covering snapshot.)

BACKUP_TAG_BASE = (1 << 20) + (1 << 10)  # above storage AND DR tags


def _log_file_name(version: int) -> str:
    return f"logs/log-{version:020d}.fdblog"


def _enc_log_batch(version: int, mutations) -> bytes:
    from .core.serialize import BinaryWriter

    w = BinaryWriter()
    w.u64(version).u32(len(mutations))
    for m in mutations:
        w.u8(int(m.type))
        w.bytes_(m.param1)
        w.bytes_(m.param2)
    return w.to_bytes()


def _dec_log_batch(blob: bytes):
    from .cluster.interfaces import Mutation
    from .core.serialize import BinaryReader
    from .kv.atomic import MutationType

    r = BinaryReader(blob)
    version, n = r.u64(), r.u32()
    ms = []
    for _ in range(n):
        t = MutationType(r.u8())
        ms.append(Mutation(t, r.bytes_(), r.bytes_()))
    return version, ms


class ContinuousBackupAgent:
    """Continuous backup of a ShardedKVCluster into a container: an
    initial snapshot at a fence version, then the mutation log shipped as
    it commits. Any version >= the snapshot (up to the shipped frontier)
    becomes restorable.

    Container choice: file:// and memory:// ops are in-process and cheap;
    blobstore:// container ops are SYNCHRONOUS HTTP round trips that
    block the loop for their duration — fine for operator tooling (CLI
    backup/restore), but in-loop continuous shipping to a remote store
    should land on a local container first (the reference likewise ships
    through backup workers, not the commit path)."""

    def __init__(self, source, url: str, tag: int = BACKUP_TAG_BASE):
        from .backup_container import open_container

        self.source = source
        self.container = open_container(url)
        self.tag = tag
        self.shipped_version = 0
        self.snapshot_version = None
        self.ship_error = None
        self._task = None
        self._view = None

    async def start(self) -> None:
        from .cluster.data_distribution import _commit_fence
        from .core.runtime import TaskPriority, spawn

        self._view = self.source.log_system.tag_view(self.tag)
        proxies = getattr(self.source, "proxies", None) or [self.source.proxy]
        for p in proxies:
            p.dr_tags = tuple(p.dr_tags) + (self.tag,)
        fence = await _commit_fence(self.source)
        # Snapshot at the fence: everything <= fence is in the snapshot,
        # everything above arrives on the tag.
        import io

        src_db = self.source.database()
        tr = src_db.create_transaction()
        tr.set_read_version(fence)
        from .core.knobs import SERVER_KNOBS

        buf = io.BytesIO()
        await _write_snapshot(buf, tr, fence, b"", b"\xff",
                              int(SERVER_KNOBS.BACKUP_SNAPSHOT_ROWS_PER_TASK))
        self.container.write_file(
            self.container.snapshot_name(fence), buf.getvalue()
        )
        self.snapshot_version = fence
        self.shipped_version = fence
        self._task = spawn(self._ship(), TaskPriority.DEFAULT,
                           name="backupShip")
        TraceEvent("ContinuousBackupStarted").detail(
            "SnapshotVersion", fence
        ).log()

    async def _ship(self) -> None:
        from .core.errors import ActorCancelled
        from .core.runtime import current_loop

        # Retry wraps the WHOLE loop body, not just the container write: a
        # peek() (or pop()) that throws — mid-recovery log fence, transport
        # blip — used to kill this actor with ship_error unset, so
        # wait_until() spun forever while the un-popped tag pinned the
        # tlog's discard horizon and spill grew without bound. Any failure
        # records ship_error and retries; progress clears it.
        while True:
            try:
                entries = await self._view.peek(self.shipped_version)
                for version, mutations in entries:
                    ms = [m for m in mutations
                          if not m.param1.startswith(b"\xff")]
                    if ms:
                        # A transient container failure (disk full, perm
                        # blip) must not silently kill shipping while
                        # proxies keep tagging mutations: retry, loudly.
                        self.container.write_file(
                            _log_file_name(version),
                            _enc_log_batch(version, ms),
                        )
                    self.shipped_version = version
                    self.ship_error = None
                self._view.pop(self.shipped_version)
            except ActorCancelled:
                raise
            except BaseException as e:  # noqa: BLE001
                self.ship_error = f"{type(e).__name__}: {e}"
                TraceEvent("BackupShipError",
                           severity=30).error(e).log()
                from .core.knobs import SERVER_KNOBS

                await current_loop().delay(
                    SERVER_KNOBS.BACKUP_SHIP_RETRY_INTERVAL
                )

    async def wait_until(self, version: int) -> None:
        from .core.runtime import current_loop

        while self.shipped_version < version:
            if self.ship_error is not None:
                raise RuntimeError(
                    f"backup shipping stalled: {self.ship_error}"
                )
            await current_loop().delay(0.02)

    def stop(self) -> None:
        """Stop shipping AND stop tagging: a stopped backup must not keep
        pinning the tlog discard horizon (same contract as DRAgent.stop) —
        otherwise un-popped (and spilled) log data grows until the
        ratekeeper throttles the whole cluster."""
        if self._task is not None:
            self._task.cancel()
            self._task = None
        proxies = getattr(self.source, "proxies", None) or [self.source.proxy]
        for p in proxies:
            p.dr_tags = tuple(t for t in p.dr_tags if t != self.tag)
        if self._view is not None:
            # Release the horizon up to everything this tag could still
            # hold (mutations tagged before the proxies stopped tagging
            # are either shipped or abandoned with the backup).
            self._view.pop(self.source.master.get_live_committed_version())


async def restore_to_version(db: Database, url: str, version: int) -> int:
    """Point-in-time restore: the newest snapshot at or below `version`,
    plus a replay of the shipped mutation log up to and including it
    (ref: design/backup.md restore = range files + log replay to the
    target version). Returns rows restored from the snapshot."""
    import io
    import re as _re

    from .backup_container import open_container
    from .kv.atomic import MutationType

    from .core.knobs import CLIENT_KNOBS

    container = open_container(url)
    snaps = [v for v in container.list_snapshots() if v <= version]
    if not snaps:
        raise ValueError(f"no snapshot at or below version {version}")
    snap_v = max(snaps)
    blob = container.read_file(container.snapshot_name(snap_v))
    f = io.BytesIO(blob)
    read_snapshot_header(f)  # raises before the multi-txn clear begins

    # Same crash-detection protocol as restore(): the multi-transaction
    # clear + apply + replay runs under the restore-in-progress marker,
    # so a torn restore is detectable.
    async def clear_body(tr):
        tr.options.set_access_system_keys()
        tr.set(RESTORE_MARKER, url.encode())
        tr.clear_range(b"", b"\xff")

    await db.transact(clear_body)
    rows = 0
    batch = int(CLIENT_KNOBS.RESTORE_WRITE_BATCH_ROWS)
    recs = list(_read_recs(f))
    for i in range(0, len(recs), batch):
        chunk = recs[i:i + batch]

        async def write_body(tr, chunk=chunk):
            for k, v in chunk:
                tr.set(k, v)

        await db.transact(write_body)
        rows += len(chunk)

    # Replay the log (snap_v, version].
    logs = []
    for name in container.list_files("logs/"):
        m = _re.match(r"logs/log-(\d+)\.fdblog$", name)
        if m and snap_v < int(m.group(1)) <= version:
            logs.append((int(m.group(1)), name))
    # Replay chunked by count AND bytes like the snapshot path: one huge
    # proxy batch (a bulk load that committed as a single version) must
    # not exceed the transaction size limit and permanently wedge the
    # restore. Mutations apply in order across chunks, and the whole
    # multi-transaction replay runs under RESTORE_MARKER, so a torn
    # replay is detectable exactly like a torn snapshot apply.
    byte_budget = max(
        1, int(CLIENT_KNOBS.TRANSACTION_SIZE_LIMIT) // 2
    )
    async def _apply_chunk(chunk: list) -> None:
        async def apply(tr, chunk=chunk):
            for m in chunk:
                if m.type == MutationType.SET_VALUE:
                    tr.set(m.param1, m.param2)
                elif m.type == MutationType.CLEAR_RANGE:
                    tr.clear_range(m.param1, min(m.param2, b"\xff"))
                else:
                    tr.atomic_op(m.type, m.param1, m.param2)

        await db.transact(apply)

    for v, name in sorted(logs):
        _ver, ms = _dec_log_batch(container.read_file(name))
        chunk: list = []
        chunk_bytes = 0
        for m in ms:
            mbytes = len(m.param1) + len(m.param2)
            if chunk and (len(chunk) >= batch
                          or chunk_bytes + mbytes > byte_budget):
                await _apply_chunk(list(chunk))
                chunk.clear()
                chunk_bytes = 0
            chunk.append(m)
            chunk_bytes += mbytes
        if chunk:
            await _apply_chunk(chunk)

    async def finish_body(tr):
        tr.options.set_access_system_keys()
        tr.clear(RESTORE_MARKER)

    await db.transact(finish_body)
    TraceEvent("RestoreToVersionComplete").detail("Version", version).detail(
        "SnapshotVersion", snap_v
    ).detail("LogBatches", len(logs)).log()
    return rows
