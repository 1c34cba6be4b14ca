"""Shard map: key ranges -> storage teams (ref: the keyServers/ mapping,
fdbclient/SystemData.cpp; served to clients by the proxy's
readRequestServer, fdbserver/MasterProxyServer.actor.cpp:1036
getKeyServersLocations).

A team is a tuple of storage tags (= storage server ids) holding replicas
of the range, chosen by the replication policy (cluster/replication.py).
The proxy stamps each mutation with its range's team tags (phase 3 tag
assignment); DataDistribution rewrites the map through MoveKeys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..core.runtime import Promise
from ..core.serialize import register_message
from ..kv.keyrange_map import KeyRangeMap
from ..kv.keys import KeyRange


class ShardMap:
    def __init__(self, default_team: Sequence[int] = (0,)):
        self._map = KeyRangeMap(tuple(default_team), coalesce=False)
        self.generation = 0  # bumped on every reassignment

    def team_for_key(self, key: bytes) -> tuple:
        return self._map[key]

    def intersecting(self, r: KeyRange) -> list[tuple[bytes, bytes, tuple]]:
        """(begin, end, team) for every shard overlapping r, with TRUE
        shard boundaries (not clipped to r): clients cache whole shards,
        exactly like getKeyServersLocations' replies
        (MasterProxyServer.actor.cpp:1036)."""
        from bisect import bisect_left, bisect_right

        from ..kv.keys import KEYSPACE_END

        if r.is_empty():
            return []
        keys = self._map._keys
        lo = bisect_right(keys, r.begin) - 1
        hi = bisect_left(keys, r.end)
        out = []
        for i in range(lo, hi):
            b = keys[i]
            e = keys[i + 1] if i + 1 < len(keys) else KEYSPACE_END
            out.append((b, e, self._map._vals[i]))
        return out

    def tags_for_range(self, r: KeyRange) -> tuple:
        tags: set[int] = set()
        for _, _, team in self._map.intersecting(r):
            tags.update(team)
        return tuple(sorted(tags))

    def set_team(self, r: KeyRange, team: Sequence[int]) -> None:
        self._map.insert(r, tuple(team))
        self.generation += 1

    def ranges(self):
        return self._map.ranges()

    def teams(self) -> set[tuple]:
        return {team for _, _, team in self._map.ranges()}


@register_message
@dataclass
class GetKeyServerLocationsRequest:
    """(ref: GetKeyServersLocationsRequest, MasterProxyInterface.h;
    answered from the proxy's shard map). reverse=True returns the LAST
    `limit` overlapping shards (reverse range scans walk top-down)."""

    begin: bytes
    end: bytes
    limit: int = 100
    reverse: bool = False
    reply: Promise = field(default_factory=Promise)
