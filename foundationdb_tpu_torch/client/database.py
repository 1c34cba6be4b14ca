"""Database handle + the transactional retry loop.

(ref: Database/Cluster bootstrap, fdbclient/NativeAPI.actor.cpp:528,732;
the retry loop is the contract every binding exposes as
`@fdb.transactional`, bindings/python/fdb/impl.py.)
"""

from __future__ import annotations

from typing import Awaitable, Callable, Optional, TypeVar

from .transaction import Transaction

T = TypeVar("T")


class Database:
    def __init__(self, cluster, conn=None):
        self.cluster = cluster
        # Database-level defaults inherited by every transaction (ref:
        # DatabaseOption transaction_timeout/transaction_retry_limit).
        from ..options import DatabaseOptions

        self.options = DatabaseOptions(self)
        self.default_transaction_options: dict = {}
        if conn is None:
            from .connection import ClusterConnection

            conn = ClusterConnection(
                cluster.proxy.grv_stream,
                cluster.proxy.commit_stream,
                cluster.storage.read_stream,
            )
        self.conn = conn

    def _set_option(self, code: int, value) -> None:
        from ..options import DatabaseOptions as DO

        if code in (DO.TRANSACTION_TIMEOUT, DO.TRANSACTION_RETRY_LIMIT):
            # Database codes intentionally equal the transaction codes for
            # these two (mirroring fdb.options), so the dict feeds
            # Transaction._option_values directly.
            self.default_transaction_options[code] = value
        elif code == DO.LOCATION_CACHE_SIZE:
            # Recorded; the sharded connection's cache is currently
            # unbounded, so this is advisory until eviction lands.
            self.location_cache_size = value
        else:
            raise ValueError(f"unknown database option code {code}")

    def create_transaction(self) -> Transaction:
        return Transaction(self)

    async def transact(
        self, fn: Callable[[Transaction], Awaitable[T]], max_retries: int = 1000
    ) -> T:
        """Run `fn` in a transaction with the standard retry loop: commit,
        and on a retryable error back off, reset and run again (ref:
        @fdb.transactional / Transaction::onError)."""
        tr = self.create_transaction()
        for _ in range(max_retries):
            try:
                result = await fn(tr)
                await tr.commit()
                return result
            except BaseException as e:  # noqa: BLE001 — on_error re-raises
                await tr.on_error(e)
        raise RuntimeError(f"transact: exhausted {max_retries} retries")

    # -- convenience single-op helpers --
    async def get(self, key: bytes) -> Optional[bytes]:
        return await self.transact(lambda tr: tr.get(key))

    async def set(self, key: bytes, value: bytes) -> None:
        async def body(tr: Transaction):
            tr.set(key, value)

        await self.transact(body)

    async def clear(self, key: bytes) -> None:
        async def body(tr: Transaction):
            tr.clear(key)

        await self.transact(body)
