"""IndexedSet: ordered map with metric accumulation (ref:
flow/IndexedSet.h — the weight-balanced tree behind Map<K,V> and the
storage server's byte-accounting; each node accumulates a METRIC over its
subtree so "total metric over a key range" and "find the key where the
accumulated metric crosses m" are O(log n)).

Implementation: a seeded treap (randomized priorities from
DeterministicRandom so simulation runs replay identically) with subtree
metric sums. The reference uses these queries for storage byte sampling
and shard splitting; kv-layer consumers here can do the same without a
full scan.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional


class _Node:
    __slots__ = ("key", "value", "metric", "prio", "left", "right",
                 "sum_metric", "count")

    def __init__(self, key, value, metric, prio):
        self.key = key
        self.value = value
        self.metric = metric
        self.prio = prio
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.sum_metric = metric
        self.count = 1


def _pull(n: _Node) -> _Node:
    n.sum_metric = n.metric
    n.count = 1
    if n.left is not None:
        n.sum_metric += n.left.sum_metric
        n.count += n.left.count
    if n.right is not None:
        n.sum_metric += n.right.sum_metric
        n.count += n.right.count
    return n


def _merge(a: Optional[_Node], b: Optional[_Node]) -> Optional[_Node]:
    if a is None:
        return b
    if b is None:
        return a
    if a.prio > b.prio:
        a.right = _merge(a.right, b)
        return _pull(a)
    b.left = _merge(a, b.left)
    return _pull(b)


def _split(n: Optional[_Node], key, inclusive: bool):
    """(keys < key [or <= if inclusive], rest)."""
    if n is None:
        return None, None
    if n.key < key or (inclusive and n.key == key):
        l, r = _split(n.right, key, inclusive)
        n.right = l
        return _pull(n), r
    l, r = _split(n.left, key, inclusive)
    n.left = r
    return l, _pull(n)


class IndexedSet:
    def __init__(self, random=None):
        self._root: Optional[_Node] = None
        self._random = random

    def _prio(self) -> int:
        if self._random is not None:
            return self._random.random_int(0, 2**31)
        from ..core.runtime import current_loop

        return current_loop().random.random_int(0, 2**31)

    # -- map surface --
    def insert(self, key, value, metric: int = 1) -> None:
        """Insert or replace; `metric` is the node's accumulated weight
        (ref: IndexedSet::insert with metric)."""
        self.erase(key)
        l, r = _split(self._root, key, inclusive=False)
        node = _Node(key, value, metric, self._prio())
        self._root = _merge(_merge(l, node), r)

    def erase(self, key) -> bool:
        l, rest = _split(self._root, key, inclusive=False)
        mid, r = _split(rest, key, inclusive=True)
        self._root = _merge(l, r)
        return mid is not None

    def get(self, key, default=None):
        n = self._root
        while n is not None:
            if key == n.key:
                return n.value
            n = n.left if key < n.key else n.right
        return default

    def __contains__(self, key) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def __len__(self) -> int:
        return self._root.count if self._root else 0

    def __iter__(self) -> Iterator[tuple]:
        def walk(n):
            if n is None:
                return
            yield from walk(n.left)
            yield (n.key, n.value)
            yield from walk(n.right)

        return walk(self._root)

    # -- the metric queries (the reason this exists) --
    def sum_range(self, begin, end) -> int:
        """Total metric over keys in [begin, end) — O(log n) (ref:
        sumRange, flow/IndexedSet.h)."""
        l, rest = _split(self._root, begin, inclusive=False)
        mid, r = _split(rest, end, inclusive=False)
        total = mid.sum_metric if mid else 0
        self._root = _merge(l, _merge(mid, r))
        return total

    def sum_to(self, key) -> int:
        """Total metric over keys < key."""
        total = 0
        n = self._root
        while n is not None:
            if n.key < key:
                total += n.metric
                if n.left is not None:
                    total += n.left.sum_metric
                n = n.right
            else:
                n = n.left
        return total

    def index_of_metric(self, m: int):
        """The first key where the accumulated metric EXCEEDS m; None past
        the total (ref: IndexedSet::index — drives split-point search)."""
        n = self._root
        if n is None or m >= n.sum_metric:
            return None
        while n is not None:
            left_sum = n.left.sum_metric if n.left else 0
            if m < left_sum:
                n = n.left
            elif m < left_sum + n.metric:
                return n.key
            else:
                m -= left_sum + n.metric
                n = n.right
        return None  # pragma: no cover - unreachable by invariant
