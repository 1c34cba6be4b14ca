"""SystemMonitor: periodic process/machine metrics as TraceEvents (ref:
flow/SystemMonitor.cpp systemMonitor + flow/Platform.cpp probes — the
reference emits ProcessMetrics/MachineMetrics events every interval;
dashboards and Status scrape them from the trace stream)."""

from __future__ import annotations

import os
import resource
import time
from typing import Optional

from .runtime import Task, current_loop, spawn
from .trace import TraceEvent


def _read_proc_self() -> dict:
    out: dict = {}
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        out["ResidentBytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["OpenFDs"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out["UserCPUSeconds"] = round(ru.ru_utime, 3)
    out["SystemCPUSeconds"] = round(ru.ru_stime, 3)
    return out


class SystemMonitor:
    """Emits ProcessMetrics on an interval; also tracks the event loop's
    own health (tasks run, slow-task detection — ref: the run-loop rdtsc
    slow task sampler, flow/Net2.actor.cpp:570)."""

    def __init__(self, interval: float = 5.0):
        self.interval = interval
        self._task: Optional[Task] = None
        self._last_tasks_run = 0
        # fdblint: allow[det-wall-clock] -- WallSeconds is operator telemetry only (trace detail); no scheduling or protocol decision reads it, so sim replays stay seed-pure.
        self._last_wall = time.monotonic()

    def start(self) -> "SystemMonitor":
        self._task = spawn(self._run(), name="systemMonitor")
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def register_metrics(self, registry=None) -> None:
        return register_process_metrics(registry)

    def emit_once(self) -> None:
        loop = current_loop()
        # fdblint: allow[det-wall-clock] -- WallSeconds is operator telemetry only (trace detail); no scheduling or protocol decision reads it, so sim replays stay seed-pure.
        wall = time.monotonic()
        ev = TraceEvent("ProcessMetrics")
        for k, v in _read_proc_self().items():
            ev.detail(k, v)
        ev.detail("LoopTasksRun", loop.tasks_run)
        ev.detail("LoopTasksDelta", loop.tasks_run - self._last_tasks_run)
        ev.detail("WallSeconds", round(wall - self._last_wall, 3))
        ev.detail("SimTime", round(loop.now(), 6))
        ev.log()
        self._last_tasks_run = loop.tasks_run
        self._last_wall = wall

    async def _run(self):
        loop = current_loop()
        while True:
            await loop.delay(self.interval)
            self.emit_once()


def register_process_metrics(registry=None) -> None:
    """Surface ProcessMetrics on the metrics plane: RSS, open FDs, CPU
    seconds, and the event loop's own health (tasks run, SlowTask
    count). The OS probes register `volatile=True` — they read host
    state, so the determinism-covered snapshot form excludes them while
    scrapes and status json still see them. Idempotent (replace=True):
    status assembly may call it lazily on any tier."""
    from .metrics import global_registry

    reg = registry if registry is not None else global_registry()
    loop = current_loop()

    def probe(key: str, default=0):
        return lambda: _read_proc_self().get(key, default)

    reg.register_gauge("process.resident_bytes", probe("ResidentBytes"),
                       volatile=True, replace=True)
    reg.register_gauge("process.open_fds", probe("OpenFDs"),
                       volatile=True, replace=True)
    reg.register_gauge("process.user_cpu_seconds",
                       probe("UserCPUSeconds", 0.0),
                       volatile=True, replace=True)
    reg.register_gauge("process.system_cpu_seconds",
                       probe("SystemCPUSeconds", 0.0),
                       volatile=True, replace=True)
    # Loop health is seed-deterministic under sim (tasks_run counts loop
    # steps; slow-task detection never arms there) — not volatile.
    reg.register_gauge("process.loop_tasks_count",
                       lambda: loop.tasks_run, replace=True)
    reg.register_gauge("process.slow_tasks_count",
                       lambda: loop.slow_tasks, replace=True)


def process_metrics_status(registry=None) -> dict:
    """The `metrics.process` block of status json, read THROUGH the
    registry (registering lazily if this process never started a
    SystemMonitor) — every key always present so the checked-in status
    schema can require it."""
    from .metrics import global_registry

    reg = registry if registry is not None else global_registry()
    if "process.loop_tasks_count" not in reg:
        register_process_metrics(reg)
    vals = {m["name"]: m["value"]
            for m in reg.snapshot(volatile=True, pattern="process.*")}
    return {
        "resident_bytes": int(vals.get("process.resident_bytes") or 0),
        "open_fds": int(vals.get("process.open_fds") or 0),
        "user_cpu_seconds": float(vals.get("process.user_cpu_seconds")
                                  or 0.0),
        "system_cpu_seconds": float(vals.get("process.system_cpu_seconds")
                                    or 0.0),
        "loop_tasks": int(vals.get("process.loop_tasks_count") or 0),
        "slow_tasks": int(vals.get("process.slow_tasks_count") or 0),
    }
