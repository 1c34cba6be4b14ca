"""Recovery generations — of which the port has, so far, only the piece
the sharded cluster uses on every `database()` call.

The port's copy of MultiEndpoint from foundationdb_tpu/cluster/recovery.py.
The recovery tier itself (RecoverableCluster, RecoverableShardedCluster,
the coordinated generation fence) has no counterpart in the port yet.
"""

from __future__ import annotations


class MultiEndpoint:
    """Round-robin over a proxy fleet's identical endpoints (ref: the
    client spreading GRV/commit across proxies,
    fdbclient/NativeAPI.actor.cpp getReadVersion/commit load balance)."""

    def __init__(self, targets):
        self.targets = list(targets)
        self._i = 0

    def send(self, req) -> None:
        if not self.targets:
            return
        self._i = (self._i + 1) % len(self.targets)
        self.targets[self._i].send(req)
