"""Transaction: snapshot reads + buffered writes + OCC commit.

Maps the reference's two client layers into one class:

- NativeAPI `Transaction` (fdbclient/NativeAPI.actor.cpp:1815): GRV on
  first read (:2700 readVersionBatcher), reads at that version against
  storage (:1146 getValue, :1603 getRange), commit submission (:2571
  commit -> :2363 tryCommit), and the retry loop (:2796 onError —
  not_committed / transaction_too_old / commit_unknown_result back off and
  retry, everything else re-raises).
- ReadYourWrites (fdbclient/ReadYourWrites.actor.cpp WriteMap/RYWIterator):
  reads observe the transaction's own uncommitted writes; atomic ops stack;
  clears tombstone; range reads merge the write overlay with storage.

Conflict bookkeeping follows the reference exactly: every non-snapshot
point read adds [key, key+\\x00) and every non-snapshot range read adds the
range actually read to the read-conflict set; mutations imply their write
ranges (derived proxy-side from the mutation list, equivalent to the
client-side write-conflict ranges the reference sends)."""

from __future__ import annotations

from typing import Callable, Optional

from ..core.errors import (
    InvertedRange,
    KeyTooLarge,
    TransactionCancelled,
    TransactionTooLarge,
    UsedDuringCommit,
    ValueTooLarge,
    is_retryable,
)
from ..core.knobs import CLIENT_KNOBS
from ..core.runtime import Future, current_loop, spawn
from ..kv.atomic import MutationType, apply_atomic
from ..kv.keys import KeyRange, key_after
from ..cluster.interfaces import (
    CommitTransactionRequest,
    Mutation,
    WatchValueRequest,
)


class _WriteEntry:
    """RYW index entry for one key: either a definite value (set/clear) or
    a stack of atomic ops over an unknown base (ref: WriteMap's
    OperationStack, fdbclient/ReadYourWrites.h / WriteMap.h:119)."""

    __slots__ = ("known", "value", "ops", "cleared_base")

    def __init__(self):
        self.known = False
        self.value: Optional[bytes] = None
        self.ops: list[tuple[MutationType, bytes]] = []
        self.cleared_base = False

    def set(self, value: Optional[bytes]):
        self.known = True
        self.value = value
        self.ops = []

    def atomic(self, op: MutationType, param: bytes):
        if self.known:
            self.value = apply_atomic(op, self.value, param)
        else:
            self.ops.append((op, param))

    def resolve(self, base: Optional[bytes]) -> Optional[bytes]:
        if self.known:
            return self.value
        v = None if self.cleared_base else base
        for op, param in self.ops:
            v = apply_atomic(op, v, param)
        return v


class Transaction:
    def __init__(self, db):
        self._db = db
        # Options survive on_error retries but not reset() (ref: onError
        # preserves options; the codegen'd setters are
        # tools/vexillographer.py's output).
        from ..options import TransactionOptions

        self.options = TransactionOptions(self)
        self._option_values: dict[int, Optional[int]] = dict(
            getattr(db, "default_transaction_options", {})
        )
        self._deadline: Optional[float] = None
        self._retries_left: Optional[int] = None
        self._reset()
        self._apply_options()

    def _set_option(self, code: int, value: Optional[int]) -> None:
        from ..options import TransactionOptions as TO

        self._option_values[code] = value
        # Side effects fire ONLY for the option being set: re-setting an
        # unrelated option must not extend the deadline or refill the
        # retry budget (db.transact bodies re-run per attempt and may set
        # flags like access_system_keys every time).
        if code == TO.TIMEOUT and value is not None:
            self._deadline = current_loop().now() + value / 1000.0
        elif code == TO.RETRY_LIMIT and value is not None:
            self._retries_left = None if value < 0 else value

    def _apply_options(self) -> None:
        """Apply every stored option's side effects (constructor only,
        for database-level defaults)."""
        for code, value in list(self._option_values.items()):
            self._set_option(code, value)

    def _option(self, code: int) -> bool:
        return code in self._option_values

    def _check_deadline(self) -> None:
        if self._deadline is not None and current_loop().now() > self._deadline:
            from ..core.errors import TransactionTimedOut

            raise TransactionTimedOut()

    def _ryw_enabled(self, snapshot: bool) -> bool:
        from ..options import TransactionOptions as TO

        if self._option(TO.READ_YOUR_WRITES_DISABLE):
            return False
        if snapshot and self._option(TO.SNAPSHOT_RYW_DISABLE):
            return False
        return True

    def _check_system_access(self, key: bytes, write: bool) -> None:
        """(ref: key_outside_legal_range unless ACCESS_SYSTEM_KEYS /
        READ_SYSTEM_KEYS is set, NativeAPI's validateKey)."""
        if not key.startswith(b"\xff"):
            return
        self._require_system_option(write)

    def _check_system_range(self, begin: bytes, end: bytes, write: bool
                            ) -> None:
        """A range [begin, end) touches system keys iff any part of it is
        at or above \\xff — checking only `begin` would let
        clear_range(b'z', b'\\xff\\xff') wipe the system space."""
        if end > b"\xff" and end > begin:
            self._require_system_option(write)

    def _require_system_option(self, write: bool) -> None:
        from ..core.errors import KeyOutsideLegalRange
        from ..options import TransactionOptions as TO

        if self._option(TO.ACCESS_SYSTEM_KEYS):
            return
        if not write and self._option(TO.READ_SYSTEM_KEYS):
            return
        raise KeyOutsideLegalRange(
            "system-key access requires the access_system_keys option"
        )

    def _reset(self):
        # Watches from an abandoned attempt must not hang their waiters:
        # resolve them with cancellation (the reference cancels watch
        # futures when the transaction resets).
        for w in getattr(self, "_watch_list", []):
            w._fail(TransactionCancelled())
        # The GRV task retries forever by design (idempotent request); an
        # abandoned attempt must take its retry loop down with it.
        t = getattr(self, "_grv_task", None)
        if t is not None and not t.done.is_ready():
            t.cancel()
        self._grv_task = None
        self._read_version_f: Optional[Future] = None
        # Flight-recorder debug ID (CLIENT_KNOBS.COMMIT_SAMPLE_RATE): a
        # sampled attempt draws one at its first GRV (or at commit for
        # blind writes) and the ID rides the GRV + commit requests so
        # every stage that touches this transaction emits micro events
        # with it (ref: debugTransaction / commit sampling feeding
        # g_traceBatch). Per ATTEMPT, like the reference: a retry is a
        # new timeline.
        self._debug_id: Optional[str] = None
        self._writes: dict[bytes, _WriteEntry] = {}
        self._clears: list[KeyRange] = []
        self._mutation_log: list[Mutation] = []
        self._read_conflicts: list[KeyRange] = []
        self._extra_write_conflicts: list[KeyRange] = []
        self._size_bytes = 0
        self._committed_version: Optional[int] = None
        self._commit_outstanding = False
        self._cancelled = False
        self._backoff = CLIENT_KNOBS.DEFAULT_BACKOFF
        self._watch_list: list = []
        for p in getattr(self, "_versionstamp_promises", []):
            if not p.is_set():
                p.send_error(TransactionCancelled())
        self._versionstamp_promises: list = []

    # -- versions --
    def get_read_version(self) -> Future:
        """GRV; batched proxy-side (ref: readVersionBatcher :2700).
        Priority options map onto the request's priority band."""
        self._check_usable()
        return self._read_version_internal()

    def _read_version_internal(self) -> Future:
        """GRV issuance without the usability check — the commit body
        acquires its snapshot AFTER the committing flag is set."""
        if self._read_version_f is None:
            from ..cluster.interfaces import GetReadVersionRequest as GRV
            from ..options import TransactionOptions as TO

            priority = GRV.PRIORITY_DEFAULT
            if self._option(TO.PRIORITY_SYSTEM_IMMEDIATE):
                priority = GRV.PRIORITY_IMMEDIATE
            elif self._option(TO.PRIORITY_BATCH):
                priority = GRV.PRIORITY_BATCH
            self._maybe_sample_debug_id()
            self._grv_task = spawn(
                self._db.conn.get_read_version(
                    priority, debug_id=self._debug_id
                ),
                name="grv",
            )
            self._read_version_f = self._grv_task.done
        return self._read_version_f

    # -- flight-recorder sampling --
    def _maybe_sample_debug_id(self) -> None:
        """Draw a debug ID for a knob-configured fraction of transactions.
        Rate 0 (the default) skips the PRNG draw entirely, so unsampled
        deployments keep a byte-identical commit path AND an untouched
        seeded-RNG stream under simulation."""
        if self._debug_id is not None:
            return
        rate = CLIENT_KNOBS.COMMIT_SAMPLE_RATE
        if rate <= 0.0:
            return
        loop = current_loop()
        if rate >= 1.0 or loop.random.random01() < rate:
            from ..core.trace import new_debug_id

            self._debug_id = new_debug_id()

    @property
    def debug_id(self) -> Optional[str]:
        """The attempt's flight-recorder ID (None when unsampled) — what
        an operator feeds `cli.py trace <debug-id>`."""
        return self._debug_id

    def set_read_version(self, version: int) -> None:
        from ..core.runtime import ready_future

        self._read_version_f = ready_future(version)

    # -- checks --
    def _check_usable(self):
        if self._cancelled:
            raise TransactionCancelled()
        if self._commit_outstanding:
            raise UsedDuringCommit()

    def _check_key(self, key: bytes, is_end: bool = False):
        """Admission (ref: key_too_large, fdbclient/NativeAPI.actor.cpp
        Transaction::set). End keys get a +1 allowance over point keys so
        keyAfter(max-size key) remains a legal range end, exactly like the
        reference. No resolver-width check is needed: the conflict set
        re-packs itself at a wider word width when longer keys arrive
        (ConflictSetGPU._grow_width), so KEY_SIZE_LIMIT is the only
        contract."""
        limit = CLIENT_KNOBS.KEY_SIZE_LIMIT
        if is_end:
            limit += 1
        if len(key) > limit:
            raise KeyTooLarge(f"key of {len(key)} bytes exceeds limit {limit}")

    # -- reads --
    async def get(self, key: bytes, snapshot: bool = False) -> Optional[bytes]:
        self._check_usable()
        self._check_deadline()
        self._check_key(key)
        self._check_system_access(key, write=False)
        if not self._ryw_enabled(snapshot):
            version = await self.get_read_version()
            if not snapshot:
                self._read_conflicts.append(KeyRange(key, key_after(key)))
            return await self._db.conn.get_value(key, version)
        entry = self._writes.get(key)
        if entry is not None and entry.known:
            return entry.value
        if entry is None and self._covered_by_clear(key):
            return None
        version = await self.get_read_version()
        if not snapshot:
            self._read_conflicts.append(KeyRange(key, key_after(key)))
        if entry is None:
            return await self._db.conn.get_value(key, version)
        # Atomic stack over an unread base: fetch base and fold.
        base = None
        if not entry.cleared_base and not self._covered_by_clear(key):
            base = await self._db.conn.get_value(key, version)
        return entry.resolve(base)

    async def get_range(
        self,
        begin: bytes,
        end: bytes,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        self._check_usable()
        self._check_deadline()
        self._check_key(begin)
        self._check_key(end, is_end=True)
        self._check_system_access(begin, write=False)
        self._check_system_range(begin, end, write=False)
        if begin > end:
            raise InvertedRange()
        version = await self.get_read_version()
        overlay = self._ryw_enabled(snapshot) and (
            any(begin <= k < end for k in self._writes)
            or any(c.intersects(KeyRange(begin, end)) for c in self._clears)
        )
        if not overlay:
            # Fast path: no local writes in range — the storage scan can be
            # clipped to the caller's limit/direction directly (the
            # reference clips server-side the same way).
            rows = await self._db.conn.get_range(
                begin, end, version, limit, reverse
            )
        else:
            # RYW merge: an uncommitted overlay can hide or add rows, so
            # the limit can only be applied after merging; scan unclipped.
            stored = await self._db.conn.get_range(begin, end, version)
            merged: dict[bytes, Optional[bytes]] = {}
            for k, v in stored:
                if not self._covered_by_clear(k):
                    merged[k] = v
            for k, entry in self._writes.items():
                if begin <= k < end:
                    if entry.known:
                        merged[k] = entry.value
                    else:
                        merged[k] = entry.resolve(merged.get(k))
            rows = sorted(
                ((k, v) for k, v in merged.items() if v is not None),
                reverse=reverse,
            )
            if limit:
                rows = rows[:limit]
        if not snapshot:
            # Conflict on the range actually read (ref: RYW adds the
            # clipped range when a limit stops the scan early).
            if limit and len(rows) == limit:
                if reverse:
                    self._read_conflicts.append(KeyRange(rows[-1][0], end))
                else:
                    self._read_conflicts.append(
                        KeyRange(begin, key_after(rows[-1][0]))
                    )
            else:
                self._read_conflicts.append(KeyRange(begin, end))
        return rows

    def _covered_by_clear(self, key: bytes) -> bool:
        return any(c.contains(key) for c in self._clears)

    # -- writes --
    def _entry(self, key: bytes) -> _WriteEntry:
        e = self._writes.get(key)
        if e is None:
            e = self._writes[key] = _WriteEntry()
        return e

    def _log(self, m: Mutation):
        self._size_bytes += len(m.param1) + len(m.param2)
        if self._size_bytes > CLIENT_KNOBS.TRANSACTION_SIZE_LIMIT:
            raise TransactionTooLarge()
        self._mutation_log.append(m)

    def set(self, key: bytes, value: bytes) -> None:
        self._check_usable()
        self._check_key(key)
        self._check_system_access(key, write=True)
        if len(value) > CLIENT_KNOBS.VALUE_SIZE_LIMIT:
            raise ValueTooLarge(f"value of {len(value)} bytes")
        self._log(Mutation(MutationType.SET_VALUE, key, value))
        self._entry(key).set(value)

    def clear(self, key: bytes) -> None:
        self.clear_range(key, key_after(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._check_usable()
        self._check_key(begin)
        self._check_key(end, is_end=True)
        self._check_system_access(begin, write=True)
        self._check_system_range(begin, end, write=True)
        if begin > end:
            raise InvertedRange()
        if begin == end:
            return
        self._log(Mutation(MutationType.CLEAR_RANGE, begin, end))
        for k in [k for k in self._writes if begin <= k < end]:
            del self._writes[k]
        self._clears.append(KeyRange(begin, end))

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        self._check_usable()
        self._check_key(key)
        self._check_system_access(key, write=True)
        if op in (MutationType.SET_VALUE, MutationType.CLEAR_RANGE):
            raise ValueError("use set()/clear_range() for plain mutations")
        self._log(Mutation(op, key, param))
        e = self._writes.get(key)
        if e is None:
            e = self._entry(key)
            if self._covered_by_clear(key):
                e.cleared_base = True
        e.atomic(op, param)

    def add(self, key: bytes, param: bytes) -> None:
        self.atomic_op(MutationType.ADD_VALUE, key, param)

    # -- versionstamped operations (ref: SET_VERSIONSTAMPED_KEY/VALUE,
    #    CommitTransaction.h:31; bindings' 4-byte-LE-offset convention) --
    @staticmethod
    def _check_stamp_param(param: bytes) -> bytes:
        """Validate the 4-byte-LE-offset convention CLIENT-side: a bad
        offset must fail this one transaction, never reach the proxy's
        shared commit batch (ref: client_invalid_operation on malformed
        versionstamp params). Returns the body (param without suffix)."""
        import struct as _struct

        from ..kv.atomic import VERSIONSTAMP_BYTES

        if len(param) < 4:
            raise ValueError("versionstamped parameter lacks offset suffix")
        (offset,) = _struct.unpack("<I", param[-4:])
        body = param[:-4]
        if offset + VERSIONSTAMP_BYTES > len(body):
            raise ValueError(
                f"versionstamp offset {offset} out of range for "
                f"{len(body)}-byte parameter"
            )
        return body

    def set_versionstamped_key(self, key: bytes, value: bytes) -> None:
        """`key` = placeholder bytes with a trailing 4-byte little-endian
        offset of the 10-byte stamp position; the final key materializes
        at commit. The mutation's own write range (placeholder form)
        participates in conflict detection; the materialized key is
        globally unique so no other writer can collide with it."""
        self._check_usable()
        body = self._check_stamp_param(key)
        self._check_key(body)  # materialized key has the body's length
        self._check_system_access(body, write=True)
        if len(value) > CLIENT_KNOBS.VALUE_SIZE_LIMIT:
            raise ValueTooLarge(f"value of {len(value)} bytes")
        self._log(Mutation(MutationType.SET_VERSIONSTAMPED_KEY, key, value))

    def set_versionstamped_value(self, key: bytes, value: bytes) -> None:
        """`value` carries the offset suffix; RYW reads of `key` before
        commit observe the PLACEHOLDER (the stamp does not exist yet)."""
        self._check_usable()
        self._check_key(key)
        self._check_system_access(key, write=True)
        body = self._check_stamp_param(value)
        if len(body) > CLIENT_KNOBS.VALUE_SIZE_LIMIT:
            raise ValueTooLarge(f"value of {len(body)} bytes")
        self._log(Mutation(MutationType.SET_VERSIONSTAMPED_VALUE, key, value))
        self._entry(key).set(body)

    def get_versionstamp(self) -> "Future":
        """Future of the 10-byte stamp this transaction's versionstamped
        operations used; resolves after commit (ref:
        Transaction::getVersionstamp, NativeAPI.actor.cpp). Requested
        AFTER the commit already resolved, it answers immediately — a
        promise registered post-commit would otherwise never be fed (a
        read-only commit has no stamp: no_commit_version)."""
        from ..core.runtime import Promise

        p = Promise()
        if self._committed_version is not None:
            stamp = getattr(self, "_versionstamp", None)
            if stamp is not None:
                p.send(stamp)
            else:
                from ..core.errors import NoCommitVersion

                p.send_error(NoCommitVersion())
        else:
            self._versionstamp_promises.append(p)
        return p.future

    # -- conflict ranges (ref: tr.add_read/write_conflict_range) --
    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._check_key(begin)
        self._check_key(end, is_end=True)
        self._read_conflicts.append(KeyRange(begin, end))

    def add_read_conflict_key(self, key: bytes) -> None:
        self.add_read_conflict_range(key, key_after(key))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._check_key(begin)
        self._check_key(end, is_end=True)
        self._extra_write_conflicts.append(KeyRange(begin, end))

    def add_write_conflict_key(self, key: bytes) -> None:
        self.add_write_conflict_range(key, key_after(key))

    # -- watches --
    def watch(self, key: bytes) -> "_PendingWatch":
        """Watch armed at commit with the transaction's view of the value
        (ref: Transaction::watch + watchValue :1292). Watches belong to one
        commit ATTEMPT: reset()/on_error() drops unarmed watches, exactly
        like the reference cancels them when the transaction resets."""
        self._check_usable()
        w = _PendingWatch(self._db, key)
        self._watch_list.append(w)
        return w

    # -- commit / retry --
    def commit(self):
        """Awaitable of the commit version; raises NotCommitted on
        conflict (ref: Transaction::commit :2571). The committing flag is
        set at CALL time, exactly like the reference's commit actor
        running to its first wait synchronously: any use of the
        transaction after commit() was invoked — even before the returned
        awaitable first runs — is used_during_commit, deterministically."""
        self._check_usable()
        self._check_deadline()
        if self._committed_version is not None:
            async def _already() -> int:
                return self._committed_version

            return _already()
        self._commit_outstanding = True
        return self._commit_impl()

    async def _commit_impl(self) -> int:
        try:
            return await self._commit_body()
        finally:
            self._commit_outstanding = False

    async def _commit_body(self) -> int:
        if not self._mutation_log and not self._extra_write_conflicts:
            # Read-only transactions commit trivially at their snapshot
            # (ref: tryCommit fast path). A read-only commit has no
            # versionstamp (ref: no_commit_version from getVersionstamp).
            rv = 0
            if self._read_version_f is not None:
                rv = await self._read_version_f
            self._committed_version = rv
            self._commit_outstanding = False  # outcome known: see below
            from ..core.errors import NoCommitVersion

            for p in self._versionstamp_promises:
                if not p.is_set():
                    p.send_error(NoCommitVersion())
            await self._arm_watches(rv)
            return rv
        snapshot = 0
        if self._read_conflicts:
            snapshot = await self._read_version_internal()
        # Blind writes reach commit without ever issuing a GRV: give them
        # their sampling draw here so write-only traffic is traceable too.
        self._maybe_sample_debug_id()
        req = CommitTransactionRequest(
            read_snapshot=snapshot,
            # commit() is single-flight per transaction; the client API is
            # not re-entered while the GRV above is parked, so the
            # conflict sets cannot move between the test and this read.
            # fdblint: allow[await-stale-guard] -- single-flight commit
            read_conflict_ranges=tuple(self._read_conflicts),
            write_conflict_ranges=tuple(self._extra_write_conflicts),
            mutations=tuple(self._mutation_log),
            debug_id=self._debug_id,
        )
        commit_id = await self._db.conn.commit(req)
        self._committed_version = commit_id.version
        self._versionstamp = commit_id.versionstamp
        # Outcome known: the transaction leaves the committing state BEFORE
        # watch arming (which reads through this transaction's own API).
        self._commit_outstanding = False
        for p in self._versionstamp_promises:
            if not p.is_set():
                p.send(commit_id.versionstamp)
        await self._arm_watches(commit_id.version)
        return commit_id.version

    async def _arm_watches(self, version: int) -> None:
        """Best-effort: arming failures resolve the watch handle with the
        error rather than raising — by this point the commit is durable, so
        commit() must report success regardless (a raise here would make
        the caller's retry loop double-apply a committed transaction).

        Drains in batches rather than one iterate-then-clear pass: watch()
        is synchronous and can run while an arming read is parked, so a
        trailing ``self._watch_list = []`` would silently drop any handle
        registered mid-arm — it would never fire and never fail."""
        while self._watch_list:
            batch, self._watch_list = self._watch_list, []
            for w in batch:
                try:
                    value = await self.get(w.key, snapshot=True)
                    w._arm(version, value)
                except BaseException as e:  # noqa: BLE001
                    w._fail(e)

    async def on_error(self, err: BaseException) -> None:
        """Backoff-and-reset for retryable errors, re-raise otherwise;
        honors the retry_limit / max_retry_delay / timeout options (ref:
        Transaction::onError :2796 with the option checks)."""
        if not is_retryable(err):
            raise err
        if self._retries_left is not None:
            if self._retries_left <= 0:
                raise err
            self._retries_left -= 1
        self._check_deadline()
        loop = current_loop()
        backoff = self._backoff
        self._reset_for_retry(backoff)
        from ..core.runtime import buggify

        if buggify("client_retry_storm"):
            backoff = 0.0  # immediate retry: contention amplification
        elif buggify("client_retry_stall"):
            backoff *= 8  # a straggling retry lands long after its peers
        await loop.delay(backoff * (0.5 + loop.random.random01()))

    def _reset_for_retry(self, prev_backoff: float) -> None:
        from ..options import TransactionOptions as TO

        retries_left = self._retries_left
        self._reset()
        self._retries_left = retries_left
        max_backoff = CLIENT_KNOBS.DEFAULT_MAX_BACKOFF
        if self._option_values.get(TO.MAX_RETRY_DELAY) is not None:
            max_backoff = self._option_values[TO.MAX_RETRY_DELAY] / 1000.0
        self._backoff = min(
            prev_backoff * CLIENT_KNOBS.BACKOFF_GROWTH_RATE, max_backoff
        )

    def reset(self) -> None:
        self._reset()

    def cancel(self) -> None:
        self._cancelled = True


class _PendingWatch:
    """Client handle for a watch; becomes a live storage watch after the
    owning transaction commits."""

    def __init__(self, db, key: bytes):
        self._db = db
        self.key = key
        from ..core.runtime import Promise

        self._ready = Promise()

    def _arm(self, version: int, value: Optional[bytes]) -> None:
        req = WatchValueRequest(self.key, value, version)
        self._ready.send(self._db.conn.watch(req))

    def _fail(self, err: BaseException) -> None:
        if not self._ready.is_set():
            self._ready.send_error(err)

    async def wait(self) -> int:
        """Resolves with the version at which the value changed; raises
        TransactionCancelled if the owning attempt was reset before
        commit, or the arming error if registration failed."""
        inner = await self._ready.future
        return await inner
