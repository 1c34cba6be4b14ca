"""Socket reactor for real-clock loops (ref: ASIOReactor,
flow/Net2.actor.cpp:925-978 sleepAndReact).

The deterministic EventLoop stays single-threaded: when it has no ready
task it asks the reactor to block in select() until the next timer (or an
fd becomes ready), instead of plain sleeping. Simulated loops never have a
reactor — the sim network schedules deliveries straight on the timer
heap, so the same role code runs in both worlds (the INetwork seam,
flow/network.h:193).
"""

from __future__ import annotations

import select
from typing import Callable


class SelectReactor:
    def __init__(self):
        self._readers: dict[int, Callable[[], None]] = {}
        self._writers: dict[int, Callable[[], None]] = {}

    def register_read(self, fd: int, cb: Callable[[], None]) -> None:
        self._readers[fd] = cb

    def unregister_read(self, fd: int) -> None:
        self._readers.pop(fd, None)

    def register_write(self, fd: int, cb: Callable[[], None]) -> None:
        self._writers[fd] = cb

    def unregister_write(self, fd: int) -> None:
        self._writers.pop(fd, None)

    def unregister(self, fd: int) -> None:
        self.unregister_read(fd)
        self.unregister_write(fd)

    def poll(self, timeout: float) -> bool:
        """Dispatch ready fd callbacks; True if any ran. Blocks up to
        `timeout` seconds (0 = nonblocking probe)."""
        if not self._readers and not self._writers:
            if timeout > 0:
                # Nothing to watch: still honor the wait so an empty loop
                # doesn't busy-spin between timer checks.
                import time

                # fdblint: allow[det-sleep] -- real-clock tier only: a reactor is attached solely by real_loop_with_transport; simulated loops never construct one (sim deliveries ride the timer heap), so this sleep is unreachable from simulation.
                time.sleep(timeout)
            return False
        try:
            r, w, _ = select.select(
                list(self._readers), list(self._writers), [], max(0.0, timeout)
            )
        except (OSError, ValueError):
            # A callback closed an fd out from under us; drop dead entries.
            self._gc()
            return True
        ran = False
        for fd in r:
            cb = self._readers.get(fd)
            if cb is not None:
                cb()
                ran = True
        for fd in w:
            cb = self._writers.get(fd)
            if cb is not None:
                cb()
                ran = True
        return ran

    def _gc(self) -> None:
        import os

        for table in (self._readers, self._writers):
            for fd in list(table):
                try:
                    os.fstat(fd)
                except OSError:
                    table.pop(fd, None)
