"""Mutation types.

The port's own copy of foundationdb_tpu.kv.atomic.MutationType (same
values, which match the reference's MutationRef::Type order,
fdbclient/CommitTransaction.h:31-44). The atomic-op apply functions are
not ported yet.
"""

from __future__ import annotations

from enum import IntEnum


class MutationType(IntEnum):
    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD_VALUE = 2
    AND = 6
    OR = 4
    XOR = 5
    APPEND_IF_FITS = 7
    MAX = 8
    MIN = 9
    BYTE_MIN = 12
    BYTE_MAX = 13
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15
