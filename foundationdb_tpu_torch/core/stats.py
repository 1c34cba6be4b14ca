"""Counters.

The port's own copy of foundationdb_tpu.core.stats.Counter (the port
imports nothing of the JAX package): a cumulative total plus the adds
since the last window reset, which a periodic stats flush turns into a
rate. The flushing CounterCollection needs the actor runtime and is not
ported yet.
"""

from __future__ import annotations


class Counter:
    __slots__ = ("name", "total", "_window")

    def __init__(self, name: str):
        self.name = name
        self.total = 0
        self._window = 0

    def add(self, n: int = 1) -> None:
        self.total += n
        self._window += n

    def __iadd__(self, n: int) -> "Counter":
        self.add(n)
        return self

    @property
    def windowed(self) -> int:
        """Adds since the last `reset_window()` (flush boundary)."""
        return self._window

    def windowed_rate(self, elapsed: float) -> float:
        """Rate over the current window, given its elapsed seconds."""
        return self._window / elapsed if elapsed > 0 else 0.0

    def reset_window(self) -> None:
        self._window = 0
