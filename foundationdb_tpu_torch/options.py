"""Client option enums + per-option setters.

GENERATED by tools/vexillographer.py — edit the OPTIONS table there and
regenerate (ref: fdbclient/vexillographer/fdb.options, the codegen every
binding consumes). Option codes match the reference where shared.
"""

from __future__ import annotations


class TransactionOptions:
    """Set via the owning transaction's `.options` attribute."""

    def __init__(self, target):
        self._target = target

    CAUSAL_READ_RISKY = 20
    READ_YOUR_WRITES_DISABLE = 51
    ACCESS_SYSTEM_KEYS = 301
    READ_SYSTEM_KEYS = 302
    PRIORITY_SYSTEM_IMMEDIATE = 200
    PRIORITY_BATCH = 201
    TIMEOUT = 500
    RETRY_LIMIT = 501
    MAX_RETRY_DELAY = 502
    SNAPSHOT_RYW_ENABLE = 600
    SNAPSHOT_RYW_DISABLE = 601

    def set_causal_read_risky(self) -> None:
        """GRV may skip the anti-partition quorum check."""
        self._target._set_option(20, None)

    def set_read_your_writes_disable(self) -> None:
        """reads ignore this transaction's own uncommitted writes."""
        self._target._set_option(51, None)

    def set_access_system_keys(self) -> None:
        """allow reads/writes of \xff system keys."""
        self._target._set_option(301, None)

    def set_read_system_keys(self) -> None:
        """allow reads of \xff system keys."""
        self._target._set_option(302, None)

    def set_priority_system_immediate(self) -> None:
        """transaction starts ahead of ratekeeper throttling."""
        self._target._set_option(200, None)

    def set_priority_batch(self) -> None:
        """transaction yields to normal-priority work."""
        self._target._set_option(201, None)

    def set_timeout(self, value: int) -> None:
        """ms from now; expired transactions raise transaction_timed_out."""
        self._target._set_option(500, value)

    def set_retry_limit(self, value: int) -> None:
        """on_error raises after this many retries (-1 = unlimited)."""
        self._target._set_option(501, value)

    def set_max_retry_delay(self, value: int) -> None:
        """cap on on_error's exponential backoff, ms."""
        self._target._set_option(502, value)

    def set_snapshot_ryw_enable(self) -> None:
        """snapshot reads observe this transaction's own writes."""
        self._target._set_option(600, None)

    def set_snapshot_ryw_disable(self) -> None:
        """snapshot reads ignore this transaction's own writes."""
        self._target._set_option(601, None)

class DatabaseOptions:
    """Set via the owning database's `.options` attribute."""

    def __init__(self, target):
        self._target = target

    LOCATION_CACHE_SIZE = 10
    TRANSACTION_TIMEOUT = 500
    TRANSACTION_RETRY_LIMIT = 501

    def set_location_cache_size(self, value: int) -> None:
        """max shard locations cached client-side."""
        self._target._set_option(10, value)

    def set_transaction_timeout(self, value: int) -> None:
        """default timeout for all transactions, ms."""
        self._target._set_option(500, value)

    def set_transaction_retry_limit(self, value: int) -> None:
        """default retry limit for all transactions."""
        self._target._set_option(501, value)

