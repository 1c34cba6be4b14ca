"""Conflict-resolution data model.

The port's own copy of foundationdb_tpu.resolver.types (the port imports nothing
of the JAX package); the byte and buffer formats are identical.

Mirrors the contract of the reference's ConflictBatch
(fdbserver/ConflictSet.h:32-60): transactions carry a read snapshot version
plus read/write conflict ranges; resolution at a batch version yields
per-transaction statuses {Committed, Conflict, TooOld}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..kv.keys import KeyRange

# Status codes (ref: ConflictBatch::TransactionCommitted/Conflict/TooOld,
# fdbserver/ConflictSet.h). Conflict is the default for anything not
# explicitly committed, as in ResolveTransactionBatchReply.
COMMITTED = 0
CONFLICT = 1
TOO_OLD = 2


@dataclass
class TxnConflictInfo:
    """One transaction's conflict footprint (ref: CommitTransactionRef,
    fdbclient/CommitTransaction.h:89-105)."""

    read_snapshot: int
    read_ranges: Sequence[KeyRange] = field(default_factory=tuple)
    write_ranges: Sequence[KeyRange] = field(default_factory=tuple)

    def validate(self) -> None:
        for r in tuple(self.read_ranges) + tuple(self.write_ranges):
            if r.is_empty():
                raise ValueError(f"empty conflict range {r!r}")


@dataclass
class ConflictBatchResult:
    statuses: list[int]

    @property
    def committed(self) -> list[int]:
        return [i for i, s in enumerate(self.statuses) if s == COMMITTED]

    @property
    def too_old(self) -> list[int]:
        return [i for i, s in enumerate(self.statuses) if s == TOO_OLD]
