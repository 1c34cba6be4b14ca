"""Cluster-wide failure detection (ref: fdbrpc/FailureMonitor.h:90-132,
fdbserver/ClusterController.actor.cpp:1296 failureDetectionServer,
fdbclient/FailureMonitorClient.actor.cpp:34 failureMonitorClientLoop).

Shape, matching the reference:

- every process runs a `heartbeater` actor that pings the
  `FailureDetectionServer` (hosted by the cluster controller) on an
  interval;
- the server marks a process failed when its last heartbeat is older than
  the adaptive timeout, and healthy again on the next heartbeat;
- every process also runs a `FailureMonitorClient` that polls the server
  for the full state + delta broadcasts and mirrors it into a local
  `FailureMonitor` view;
- RPC call sites gate on the local view (`on_state_equals` /
  `on_disconnect_or_failure`) instead of discovering failures one timeout
  at a time.

All traffic rides the SimNetwork when one is provided, so blackouts and
partitions produce exactly the reference's observable behavior: a
partitioned process is declared failed by the server while it still
believes itself healthy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.actors import AsyncVar, PromiseStream, serve_requests
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import Promise, TaskPriority, current_loop, spawn
from ..core.trace import TraceEvent


@dataclass
class FailureMonitorState:
    """Mirror of the server's view (ref: SystemFailureStatus lists)."""

    failed: frozenset = frozenset()
    generation: int = 0


@dataclass
class HeartbeatRequest:
    process: str
    reply: Promise = field(default_factory=Promise)


@dataclass
class FailureStateRequest:
    """Poll: returns FailureMonitorState (ref: FailureMonitoringRequest with
    delta compression; we return the full set — sets are small)."""

    known_generation: int = -1
    reply: Promise = field(default_factory=Promise)


class FailureDetectionServer:
    """Hosted by the controller (ref: failureDetectionServer,
    ClusterController.actor.cpp:1296).

    `timeout` overrides the failure horizon (float, or a callable read
    per sweep so knob changes land live): the worker registry leases
    workers at WORKER_LEASE_TIMEOUT through exactly this server, while
    the default horizon stays FAILURE_TIMEOUT_DELAY."""

    def __init__(self, timeout=None):
        self.stream: PromiseStream = PromiseStream()
        self._timeout = timeout
        self._last_beat: dict[str, float] = {}
        self._state = AsyncVar(FailureMonitorState())
        self._tasks = []

    def _timeout_s(self) -> float:
        t = self._timeout
        if callable(t):
            return t()
        return t if t is not None else SERVER_KNOBS.FAILURE_TIMEOUT_DELAY

    @property
    def state(self) -> FailureMonitorState:
        return self._state.get()

    def start(self) -> None:
        self._tasks = [
            serve_requests(self.stream, self._serve_one,
                           TaskPriority.COORDINATION, "failure_detection"),
            spawn(self._sweep_loop(), TaskPriority.COORDINATION,
                  name="failure_sweep"),
        ]

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()

    async def _serve_one(self, req):
        if isinstance(req, HeartbeatRequest):
            self.beat(req.process)
            return True
        if isinstance(req, FailureStateRequest):
            if req.known_generation == self.state.generation:
                # Long-poll: answer on the next change (delta behavior).
                await self._state.on_change()
            # The fresh read IS the point: the long-poll parks precisely
            # so the state can move, then answers with what it moved to.
            # fdblint: allow[await-stale-guard] -- long-poll wants fresh state
            return self.state
        raise TypeError(f"unknown failure-monitor request {type(req)}")

    def beat(self, process: str) -> None:
        """One liveness beat, callable in-process too (the worker
        registry feeds registrations through here)."""
        self._last_beat[process] = current_loop().now()
        if process in self.state.failed:
            self._mark(process, failed=False)

    def is_failed(self, process: str) -> bool:
        return process in self.state.failed

    def _mark(self, process: str, failed: bool) -> None:
        cur = self.state
        new = set(cur.failed)
        (new.add if failed else new.discard)(process)
        self._state.set(
            FailureMonitorState(frozenset(new), cur.generation + 1)
        )
        TraceEvent("FailureDetectionStatus", severity=30 if failed else 10
                   ).detail("Process", process).detail(
            "Failed", failed
        ).log()

    async def _sweep_loop(self):
        loop = current_loop()
        while True:
            await loop.delay(self._timeout_s() / 2)
            deadline = loop.now() - self._timeout_s()
            for process, beat in self._last_beat.items():
                if beat < deadline and process not in self.state.failed:
                    self._mark(process, failed=True)


class FailureMonitor:
    """Local, possibly stale view each process gates RPCs on (ref:
    IFailureMonitor / SimpleFailureMonitor, fdbrpc/FailureMonitor.h:90)."""

    def __init__(self):
        self._state = AsyncVar(FailureMonitorState())

    def set_state(self, st: FailureMonitorState) -> None:
        if st.generation > self._state.get().generation:
            self._state.set(st)

    def is_failed(self, process: str) -> bool:
        return process in self._state.get().failed

    async def on_failed(self, process: str) -> None:
        """Resolves when `process` is marked failed (ref:
        onDisconnectOrFailure — used to hedge/abandon in-flight RPCs)."""
        while not self.is_failed(process):
            await self._state.on_change()

    async def on_healthy(self, process: str) -> None:
        while self.is_failed(process):
            await self._state.on_change()


def heartbeater(server_stream, process_name: str, interval: float = None):
    """Spawn the per-process heartbeat actor; returns the Task. The stream
    may be a RemoteStream over the sim network — a partitioned process's
    beats are then dropped in flight, which is the point."""

    async def run():
        from ..core.actors import timeout

        from ..core.runtime import buggify

        loop = current_loop()
        ival = interval or SERVER_KNOBS.FAILURE_MIN_DELAY / 4
        while True:
            if buggify("heartbeat_jitter"):
                # A GC-pause-shaped gap just short of the failure window
                # (beat interval + jitter stays under FAILURE_TIMEOUT_DELAY):
                # detection must neither flap nor miss real deaths.
                await loop.delay(
                    (SERVER_KNOBS.FAILURE_TIMEOUT_DELAY - ival)
                    * 0.8 * loop.random.random01()
                )
            req = HeartbeatRequest(process_name)
            server_stream.send(req)
            # Reply is advisory; losing it just means beating again.
            await timeout(req.reply.future, ival, default=None)
            await loop.delay(ival * (0.75 + 0.5 * loop.random.random01()))

    return spawn(run(), TaskPriority.COORDINATION,
                 name=f"heartbeat:{process_name}")


def failure_monitor_client(server_stream, monitor: FailureMonitor,
                           process_name: str = "client"):
    """Spawn the state-mirroring actor (ref: failureMonitorClientLoop)."""

    async def run():
        from ..core.actors import timeout

        known = -1
        while True:
            req = FailureStateRequest(known_generation=known)
            server_stream.send(req)
            st: Optional[FailureMonitorState] = await timeout(
                req.reply.future, SERVER_KNOBS.FAILURE_MIN_DELAY, default=None
            )
            if st is None:
                continue  # lost poll: re-ask from the same generation
            monitor.set_state(st)
            known = st.generation

    return spawn(run(), TaskPriority.COORDINATION,
                 name=f"failure_client:{process_name}")
