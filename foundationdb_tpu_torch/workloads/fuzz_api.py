"""FuzzApiCorrectness: hostile/malformed API usage must fail with the
documented typed errors and leave the database undamaged (ref:
fdbserver/workloads/FuzzApiCorrectness.actor.cpp — the "every call site
throws the right error" sweep).

Each probe records (operation, expected error class, got); any wrong
error type, silent success of an illegal op, or collateral damage to a
sentinel key is a failure."""

from __future__ import annotations

from ..client.database import Database
from ..core.errors import (
    InvertedRange,
    KeyOutsideLegalRange,
    KeyTooLarge,
    NoCommitVersion,
    UsedDuringCommit,
    ValueTooLarge,
)
from ..core.knobs import CLIENT_KNOBS
from ..core.runtime import current_loop

SENTINEL = b"fuzz/sentinel"


class FuzzApiWorkload:
    def __init__(self, db: Database):
        self.db = db
        self.failures: list[str] = []
        self.probes_done = 0

    async def _expect(self, name: str, expected: type, coro_fn) -> None:
        self.probes_done += 1
        try:
            await coro_fn()
        except expected:
            return
        except BaseException as e:  # noqa: BLE001
            self.failures.append(
                f"{name}: expected {expected.__name__}, got "
                f"{type(e).__name__}: {e}"
            )
            return
        self.failures.append(f"{name}: expected {expected.__name__}, "
                             f"but the call succeeded")

    async def run(self, rounds: int = 3) -> None:
        rng = current_loop().random
        await self.db.set(SENTINEL, b"untouched")
        for _ in range(rounds):
            await self._round(rng)
        # No probe may have damaged unrelated state.
        if await self.db.get(SENTINEL) != b"untouched":
            self.failures.append("sentinel key damaged by fuzzing")

    async def _round(self, rng) -> None:
        db = self.db

        async def inverted_get_range():
            tr = db.create_transaction()
            await tr.get_range(b"zzz", b"aaa")

        await self._expect("inverted get_range", InvertedRange,
                           inverted_get_range)

        async def inverted_clear_range():
            tr = db.create_transaction()
            tr.clear_range(b"zzz", b"aaa")
            await tr.commit()

        await self._expect("inverted clear_range", InvertedRange,
                           inverted_clear_range)

        async def huge_key():
            tr = db.create_transaction()
            tr.set(b"k" * (CLIENT_KNOBS.KEY_SIZE_LIMIT + 1), b"v")
            await tr.commit()

        await self._expect("oversized key", KeyTooLarge, huge_key)

        async def huge_value():
            tr = db.create_transaction()
            tr.set(b"hv", b"v" * (CLIENT_KNOBS.VALUE_SIZE_LIMIT + 1))
            await tr.commit()

        await self._expect("oversized value", ValueTooLarge, huge_value)

        async def system_key_without_option():
            tr = db.create_transaction()
            tr.set(b"\xff/illegal", b"v")
            await tr.commit()

        await self._expect("system key w/o access_system_keys",
                           KeyOutsideLegalRange, system_key_without_option)

        async def system_read_without_option():
            tr = db.create_transaction()
            await tr.get(b"\xff/illegal")

        await self._expect("system read w/o access_system_keys",
                           KeyOutsideLegalRange,
                           system_read_without_option)

        async def versionstamp_of_readonly():
            tr = db.create_transaction()
            await tr.get(b"fuzz/ro")
            await tr.commit()
            await tr.get_versionstamp()

        await self._expect("versionstamp of read-only txn",
                           NoCommitVersion, versionstamp_of_readonly)

        async def use_during_commit():
            tr = db.create_transaction()
            tr.set(b"fuzz/udc", b"v")
            from ..core.runtime import spawn

            t = spawn(tr.commit())
            try:
                tr.set(b"fuzz/udc2", b"v")  # must refuse mid-commit
            finally:
                try:
                    # fdblint: allow[async-await-in-finally] -- joining the spawned commit is the point of the probe (commit must finish before the actor exits); a cancel landing here is absorbed by the except below, which is the intended teardown.
                    await t.done
                except BaseException:  # noqa: BLE001
                    pass

        await self._expect("mutation during commit", UsedDuringCommit,
                           use_during_commit)

        # Valid-but-odd shapes that must SUCCEED (no false rejections):
        # empty value, key at exactly the limit, zero-length range.
        try:
            tr = db.create_transaction()
            tr.set(b"fuzz/empty", b"")
            tr.set(b"k" * CLIENT_KNOBS.KEY_SIZE_LIMIT, b"v")
            await tr.get_range(b"fuzz/x", b"fuzz/x")
            await tr.commit()
            self.probes_done += 1
        except BaseException as e:  # noqa: BLE001
            from ..core.errors import is_retryable

            if not is_retryable(e):
                self.failures.append(
                    f"legal edge-case txn rejected: {type(e).__name__}: {e}"
                )

    async def check(self) -> bool:
        return not self.failures
