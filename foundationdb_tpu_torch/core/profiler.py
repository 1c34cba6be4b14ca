"""Sampling profiler (ref: flow/Profiler.actor.cpp — SIGPROF-driven stack
sampling written to a flow file, runtime-togglable per process via
ProfilerRequest, fdbserver/worker.actor.cpp:332).

Python-native equivalent: signal.setitimer(ITIMER_PROF) fires SIGPROF on
CPU time; the handler records the interrupted stack. `report()` aggregates
into (frame -> samples) and `dump()` emits the top hotspots as a
TraceEvent, which is how operators consume the reference's profiles too.
Falls back to ITIMER_REAL where PROF isn't available (e.g. restricted
environments).
"""

from __future__ import annotations

import signal
import sys
from collections import Counter
from typing import Optional

from .trace import TraceEvent


class Profiler:
    def __init__(self, max_depth: int = 12):
        self.max_depth = max_depth
        self.samples: Counter = Counter()
        self.total_samples = 0
        # Most recent interrupted stack (leaf first) — the slow-task
        # detector attaches it to SlowTask events (core/runtime.py).
        self.last_stack: tuple = ()
        self._running = False
        self._prev_handler = None
        self._timer = signal.ITIMER_PROF

    def _handler(self, signum, frame) -> None:
        stack = []
        f = frame
        while f is not None and len(stack) < self.max_depth:
            code = f.f_code
            stack.append(f"{code.co_filename}:{f.f_lineno}:{code.co_name}")
            f = f.f_back
        self.samples[tuple(stack)] += 1
        self.last_stack = tuple(stack)
        self.total_samples += 1

    def start(self, interval: float = 0.01) -> None:
        assert not self._running
        self._running = True
        # A prior fallback must not leak: re-arm PROF first every time
        # (SIGPROF handler + ITIMER_REAL would deliver unhandled SIGALRM).
        self._timer = signal.ITIMER_PROF
        sig = signal.SIGPROF
        try:
            self._prev_handler = signal.signal(sig, self._handler)
            signal.setitimer(self._timer, interval, interval)
        except (ValueError, OSError):
            # Not the main thread / PROF unavailable: real-time fallback.
            sig = signal.SIGALRM
            self._timer = signal.ITIMER_REAL
            self._prev_handler = signal.signal(sig, self._handler)
            signal.setitimer(self._timer, interval, interval)
        self._sig = sig

    def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        signal.setitimer(self._timer, 0, 0)
        if self._prev_handler is not None:
            signal.signal(self._sig, self._prev_handler)

    # -- reporting --
    def top_frames(self, n: int = 10) -> list[tuple[str, int]]:
        """Leaf-frame hotspots: (frame, samples) sorted desc."""
        leaf: Counter = Counter()
        for stack, count in self.samples.items():
            if stack:
                leaf[stack[0]] += count
        return leaf.most_common(n)

    def dump(self, n: int = 10) -> None:
        ev = TraceEvent("ProfilerReport").detail(
            "TotalSamples", self.total_samples
        )
        for i, (frame, count) in enumerate(self.top_frames(n)):
            ev.detail(f"Hot{i}", f"{count}x {frame}")
        ev.log()
