"""KeyRangeMap: a coalesced map from key ranges to values (ref:
fdbclient/KeyRangeMap.actor.cpp / fdbrpc/RangeMap.h — the structure behind
the shard map, resolver key ranges, and every range-indexed cache).

Represented as a step function over the key space, exactly like the
conflict set's history: sorted boundary keys with the value applying to
[boundary_i, boundary_{i+1}). insert(range, value) overwrites the covered
span and preserves the value at range.end; adjacent equal values coalesce.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, Iterable, Optional

from .keys import KeyRange


class KeyRangeMap:
    def __init__(self, default: Any = None, coalesce: bool = True):
        # coalesce=False keeps explicit boundaries even between equal
        # values — shard maps need this: adjacent shards may share a team
        # yet remain distinct shards (ref: keyServers/ boundary entries).
        self._keys: list[bytes] = [b""]
        self._vals: list[Any] = [default]
        self._coalesce_enabled = coalesce

    def __getitem__(self, key: bytes) -> Any:
        return self._vals[bisect_right(self._keys, key) - 1]

    def insert(self, r: KeyRange, value: Any) -> None:
        if r.is_empty():
            return
        end_value = self[r.end]
        lo = bisect_left(self._keys, r.begin)
        hi = bisect_left(self._keys, r.end)
        new_keys = [r.begin]
        new_vals = [value]
        if hi >= len(self._keys) or self._keys[hi] != r.end:
            new_keys.append(r.end)
            new_vals.append(end_value)
        self._keys[lo:hi] = new_keys
        self._vals[lo:hi] = new_vals
        self._coalesce()

    def _coalesce(self) -> None:
        if not self._coalesce_enabled:
            return
        out_k: list[bytes] = []
        out_v: list[Any] = []
        for k, v in zip(self._keys, self._vals):
            if out_v and out_v[-1] == v:
                continue
            out_k.append(k)
            out_v.append(v)
        self._keys, self._vals = out_k, out_v

    def ranges(self) -> list[tuple[bytes, Optional[bytes], Any]]:
        """All (begin, end|None, value) steps; the last end is None
        (unbounded)."""
        out = []
        for i, (k, v) in enumerate(zip(self._keys, self._vals)):
            end = self._keys[i + 1] if i + 1 < len(self._keys) else None
            out.append((k, end, v))
        return out

    def intersecting(self, r: KeyRange) -> list[tuple[bytes, Optional[bytes], Any]]:
        """(begin, end|None, value) steps overlapping [r.begin, r.end)."""
        if r.is_empty():
            return []
        lo = bisect_right(self._keys, r.begin) - 1
        hi = bisect_left(self._keys, r.end)
        out = []
        for i in range(lo, hi):
            b = max(self._keys[i], r.begin)
            e = self._keys[i + 1] if i + 1 < len(self._keys) else None
            if e is not None:
                e = min(e, r.end)
            else:
                e = r.end
            out.append((b, e, self._vals[i]))
        return out

    def __len__(self) -> int:
        return len(self._keys)
