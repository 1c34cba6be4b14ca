"""Counters and periodic stats emission (ref: flow/Stats.h:55-63 —
Counter/CounterCollection flushed as TraceEvents on an interval).

Each flush emits one TraceEvent per collection carrying every counter's
CUMULATIVE total plus its rate over the window since the previous flush
(the window then resets) — the shape operators' dashboards scrape in the
reference: totals for monotonic series, rates for gauges."""

from __future__ import annotations

from bisect import bisect_left
from typing import Optional

from .runtime import Task, current_loop, spawn
from .trace import TraceEvent


class Counter:
    __slots__ = ("name", "total", "_window")

    def __init__(self, name: str, collection: "CounterCollection" = None):
        self.name = name
        self.total = 0
        self._window = 0
        if collection is not None:
            collection.add(self)

    def add(self, n: int = 1) -> None:
        self.total += n
        self._window += n

    def __iadd__(self, n: int) -> "Counter":
        self.add(n)
        return self

    # -- windowed-rate accessors (read-only): status/flush code reads the
    # since-last-flush window through these instead of reaching into
    # `_window` (the reset stays the flusher's exclusive move).
    @property
    def windowed(self) -> int:
        """Adds since the last `reset_window()` (flush boundary)."""
        return self._window

    def windowed_rate(self, elapsed: float) -> float:
        """Rate over the current window, given its elapsed seconds."""
        return self._window / elapsed if elapsed > 0 else 0.0

    def reset_window(self) -> None:
        self._window = 0


class ContinuousSample:
    """Reservoir sample for latency percentiles (ref:
    fdbrpc/ContinuousSample.h:31). Keeps a fixed-size uniform sample of an
    unbounded stream; percentiles are read from the sorted reservoir."""

    __slots__ = ("size", "samples", "population", "_sorted", "_random")

    def __init__(self, size: int = 500, random=None):
        self.size = size
        self.samples: list = []
        self.population = 0
        self._sorted = False
        self._random = random

    def _rand_below(self, n: int) -> int:
        if self._random is not None:
            return self._random.random_int(0, n)
        from .runtime import current_loop

        return current_loop().random.random_int(0, n)

    def add_sample(self, value) -> None:
        self.population += 1
        if len(self.samples) < self.size:
            self.samples.append(value)
            self._sorted = False
        elif self._rand_below(self.population) < self.size:
            self.samples[self._rand_below(self.size)] = value
            self._sorted = False

    def percentile(self, q: float):
        """q in [0, 1]; None on an empty sample."""
        if not self.samples:
            return None
        if not self._sorted:
            self.samples.sort()
            self._sorted = True
        idx = min(len(self.samples) - 1, int(q * len(self.samples)))
        return self.samples[idx]

    def median(self):
        return self.percentile(0.5)

    def mean(self):
        return sum(self.samples) / len(self.samples) if self.samples else None

    def clear(self) -> None:
        self.samples.clear()
        self.population = 0
        self._sorted = False


class LatencyBands:
    """Latency histogram over knob-configured band edges (ref: the
    `latency_bands` blocks fdbclient surfaces in status json — GRV/read/
    commit requests bucketed by operator-chosen thresholds). `status()`
    renders the reference's cumulative shape: for each edge, how many
    requests finished within it, plus the unconditional total — the
    fleet-wide twin of the flight recorder's per-transaction timelines
    (bands say HOW MANY commits were slow; `cli.py trace` says WHERE one
    of them spent its time)."""

    __slots__ = ("edges_ms", "_counts", "total", "_exemplars")

    def __init__(self, edges_ms=None):
        if edges_ms is None:
            from .knobs import SERVER_KNOBS

            edges_ms = SERVER_KNOBS.LATENCY_BAND_EDGES_MS
        self.edges_ms = tuple(edges_ms)
        self._counts = [0] * (len(self.edges_ms) + 1)
        self.total = 0
        # Per-band EXEMPLAR: the most recent flight-recorder debug ID that
        # landed in the band, so an operator looking at a hot band jumps
        # straight to `cli.py trace <id>` (the band says HOW MANY were
        # slow; the exemplar's timeline says WHERE one of them was slow).
        self._exemplars: dict[int, str] = {}

    def _band_label(self, idx: int) -> str:
        return (f"{self.edges_ms[idx]:g}" if idx < len(self.edges_ms)
                else "inf")

    def add(self, seconds: float, n: int = 1,
            exemplar: Optional[str] = None) -> None:
        idx = bisect_left(self.edges_ms, seconds * 1e3)
        self._counts[idx] += n
        self.total += n
        if exemplar is not None:
            self._exemplars[idx] = exemplar

    def clear(self) -> None:
        """Reset for windowed reporting (a scraper that wants per-window
        histograms clears after reading; the default consumers read
        cumulative totals and never call this)."""
        self._counts = [0] * (len(self.edges_ms) + 1)
        self.total = 0
        self._exemplars.clear()

    def exemplars(self) -> dict[str, str]:
        """{band label: debug id} of the retained per-band exemplars."""
        return {self._band_label(i): self._exemplars[i]
                for i in sorted(self._exemplars)}

    def status(self) -> dict:
        bands = {}
        acc = 0
        for edge, c in zip(self.edges_ms, self._counts):
            acc += c
            bands[f"{edge:g}"] = acc
        bands["inf"] = self.total
        out = {"bands_ms": bands, "total": self.total}
        if self._exemplars:
            out["exemplars"] = self.exemplars()
        return out


def stage_percentiles(samples: dict) -> dict:
    """{stage: {"p50", "p99", "samples"}} from a dict of ContinuousSample
    reservoirs — the shared shape of the resolver's and the commit
    proxy's `status json` pipeline-stage blocks."""
    def pct(s: ContinuousSample, q: float):
        v = s.percentile(q)
        return round(v, 3) if v is not None else None

    return {
        k: {"p50": pct(s, 0.5), "p99": pct(s, 0.99),
            "samples": s.population}
        for k, s in samples.items()
    }


class Smoother:
    """Exponential smoother over continuous (wall/sim) time (ref:
    fdbrpc/Smoother.h). `smooth_total()` converges toward the last set
    total with time constant e-folding time `e_folding_time`;
    `smooth_rate()` is the smoothed derivative — the reference uses these
    for queue depths and rates in Ratekeeper and LoadBalance."""

    __slots__ = ("e_folding_time", "total", "_time", "_estimate")

    def __init__(self, e_folding_time: float):
        self.e_folding_time = e_folding_time
        self.total = 0.0
        self._time = None
        self._estimate = 0.0

    def _now(self) -> float:
        from .runtime import current_loop

        return current_loop().now()

    def reset(self, value: float) -> None:
        self.total = value
        self._estimate = value
        self._time = None

    def set_total(self, total: float) -> None:
        self._update()
        self.total = total

    def add_delta(self, delta: float) -> None:
        self._update()
        self.total += delta

    def _update(self) -> None:
        import math

        t = self._now()
        if self._time is None:
            self._time = t
            self._estimate = self.total
            return
        dt = t - self._time
        if dt > 0:
            self._time = t
            self._estimate += (self.total - self._estimate) * (
                1 - math.exp(-dt / self.e_folding_time)
            )

    def smooth_total(self) -> float:
        self._update()
        return self._estimate

    def smooth_rate(self) -> float:
        """Rate at which the estimate is moving toward the total."""
        self._update()
        return (self.total - self._estimate) / self.e_folding_time


class TimerSmoother(Smoother):
    """Smoother whose estimate decays toward the total but never past it —
    used for timers that only ratchet up (ref: fdbrpc/Smoother.h:71)."""

    def add_delta(self, delta: float) -> None:
        self._update()
        self.total += delta
        if delta > 0:
            self._estimate += delta


class CounterCollection:
    def __init__(self, name: str, id_: str = ""):
        self.name = name
        self.id = id_
        self.counters: list[Counter] = []
        self._task: Optional[Task] = None

    def add(self, counter: Counter) -> None:
        self.counters.append(counter)

    def counter(self, name: str) -> Counter:
        return Counter(name, self)

    def flush(self, elapsed: float) -> None:
        ev = TraceEvent(self.name + "Metrics").detail("ID", self.id).detail(
            "Elapsed", round(elapsed, 6)
        )
        for c in self.counters:
            ev.detail(c.name, c.total)
            ev.detail(c.name + "Rate", round(c.windowed_rate(elapsed), 3))
            c.reset_window()
        ev.log()

    def start_logging(self, interval: float) -> None:
        """Emit a metrics TraceEvent every `interval` seconds (ref:
        traceCounters, flow/Stats.actor.cpp)."""

        async def run():
            loop = current_loop()
            last = loop.now()
            while True:
                await loop.delay(interval)
                now = loop.now()
                self.flush(now - last)
                last = now

        self._task = spawn(run(), name=f"counters:{self.name}")

    def stop_logging(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
