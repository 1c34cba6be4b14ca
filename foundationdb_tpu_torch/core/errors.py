"""Typed errors with stable numeric codes.

Mirrors the reference's error taxonomy (flow/Error.h, error_definitions.h) —
the codes below use the same numbering as the reference's public API so that
client retry loops and bindings behave identically. Only the subset needed by
the framework is defined; new codes join the registry as features land.
"""

from __future__ import annotations


class FdbError(Exception):
    """Base error carrying a stable numeric code and snake_case name."""

    code: int = 1500
    name: str = "unknown_error"

    def __init__(self, *args):
        super().__init__(*args or (self.name,))

    def __repr__(self):
        return f"{type(self).__name__}(code={self.code})"


_REGISTRY: dict[int, type[FdbError]] = {}


def _define(name: str, code: int, doc: str) -> type[FdbError]:
    cls = type(name, (FdbError,), {"code": code, "name": _snake(name), "__doc__": doc})
    _REGISTRY[code] = cls
    return cls


def _snake(name: str) -> str:
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i:
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def error_for_code(code: int) -> type[FdbError]:
    return _REGISTRY.get(code, FdbError)


# Transaction errors (retryable ones are handled by Transaction.on_error).
NotCommitted = _define("NotCommitted", 1020, "Transaction not committed due to conflict with another transaction")
TransactionTooOld = _define("TransactionTooOld", 1007, "Transaction is too old to perform reads or be committed")
CommitUnknownResult = _define("CommitUnknownResult", 1021, "Transaction may or may not have committed")
FutureVersion = _define("FutureVersion", 1009, "Request for future version")
WrongShardServer = _define("WrongShardServer", 1001, "Shard is not available from this server")
TransactionTooLarge = _define("TransactionTooLarge", 2101, "Transaction exceeds byte limit")
KeyTooLarge = _define("KeyTooLarge", 2102, "Key length exceeds limit")
ValueTooLarge = _define("ValueTooLarge", 2103, "Value length exceeds limit")
TransactionCancelled = _define("TransactionCancelled", 1025, "Operation aborted because the transaction was cancelled")
UsedDuringCommit = _define("UsedDuringCommit", 2017, "Operation issued while a commit was outstanding")
InvertedRange = _define("InvertedRange", 2005, "Range begin key exceeds end key")
KeyOutsideLegalRange = _define("KeyOutsideLegalRange", 2003, "Key outside legal range (system keys need access_system_keys)")
NoCommitVersion = _define("NoCommitVersion", 2021, "Read-only transaction has no commit version or versionstamp")
TransactionTimedOut = _define("TransactionTimedOut", 1031, "Operation aborted because the transaction timed out")

# Cluster / role errors.
OperationFailed = _define("OperationFailed", 1000, "Operation failed")
TimedOut = _define("TimedOut", 1004, "Operation timed out")
BrokenPromise = _define("BrokenPromise", 1100, "The promise was dropped before being fulfilled")
ActorCancelled = _define("ActorCancelled", 1101, "Asynchronous operation cancelled")
RequestMaybeDelivered = _define("RequestMaybeDelivered", 1030, "Request may or may not have been delivered")
ConnectionFailed = _define("ConnectionFailed", 1026, "Network connection failed")
IncompatibleProtocolVersion = _define("IncompatibleProtocolVersion", 1109, "Incompatible protocol version (peer or durable format outside the compatibility lattice)")
CoordinatorsChanged = _define("CoordinatorsChanged", 1027, "Coordination servers have changed")
MasterRecoveryFailed = _define("MasterRecoveryFailed", 1203, "Master recovery failed")
WorkerRemoved = _define("WorkerRemoved", 1202, "Normal worker shut down")
PlatformError = _define("PlatformError", 1500, "Platform error")
IoError = _define("IoError", 1510, "Disk i/o operation failed")
TLogStopped = _define("TLogStopped", 1011, "TLog stopped (locked by a newer recovery generation)")
TLogFailed = _define("TLogFailed", 1205, "Transaction log unreachable (the commit's fsync quorum cannot be formed)")
EndOfStream = _define("EndOfStream", 1, "End of stream")

RETRYABLE_CODES = frozenset(
    {
        NotCommitted.code,
        TransactionTooOld.code,
        FutureVersion.code,
        CommitUnknownResult.code,
        RequestMaybeDelivered.code,
    }
)


def is_retryable(err: BaseException) -> bool:
    return isinstance(err, FdbError) and err.code in RETRYABLE_CODES
