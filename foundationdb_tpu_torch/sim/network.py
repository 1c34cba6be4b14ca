"""Simulated network: seeded latency, clogs, partitions, blackouts.

The reference's Sim2 (fdbrpc/sim2.actor.cpp) gives every simulated process
an address space and connects them with in-memory duplex pipes whose
latency and failures come from the deterministic PRNG (Sim2Conn :180,
SimClogging :114, clogInterface :1454, clogPair :1469). This module is the
same idea at message granularity: every cross-process request/reply hop is
scheduled through SimNetwork.deliver, which applies seeded latency, drops
traffic to/from blacked-out processes, and holds clogged links until they
unclog. Messages are NOT reordered relative to the timer heap semantics:
two sends on one link with the same latency keep their order via the
loop's monotone sequence numbers, but different latencies can reorder —
exactly like real UDP-ish delivery and like Sim2's per-message delays.

Process kill/reboot here models a BLACKOUT (all traffic dropped both ways,
in-memory state preserved): role state loss + recovery generations are the
recovery tier's subject (SURVEY §7 step 5), not the network's.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

from ..core.runtime import TaskPriority, current_loop, spawn
from ..core.trace import TraceEvent


class SimProcess:
    def __init__(self, name: str):
        self.name = name
        self.alive = True

    def __repr__(self):
        return f"SimProcess({self.name}, {'up' if self.alive else 'DOWN'})"


class SimNetwork:
    def __init__(
        self,
        base_latency: float = 0.0005,
        jitter: float = 0.002,
    ):
        self.base_latency = base_latency
        self.jitter = jitter
        self._clogged_until: dict[tuple[str, str], float] = {}
        # Per-PROCESS clogs (all links of the process, both directions):
        # the unit of sim2's clogInterface and of swizzled clogging, where
        # a machine's whole interface goes dark and unclogs later.
        self._proc_clogged_until: dict[str, float] = {}
        self._partitioned: set[frozenset] = set()
        self.messages_sent = 0
        self.messages_dropped = 0

    # -- fault controls (ref: sim2.actor.cpp:1454-1469, :1158-1217) --
    def clog_pair(self, a: SimProcess, b: SimProcess, seconds: float) -> None:
        """Hold all traffic between a and b for `seconds` (both ways)."""
        until = current_loop().now() + seconds
        for key in ((a.name, b.name), (b.name, a.name)):
            self._clogged_until[key] = max(
                self._clogged_until.get(key, 0.0), until
            )
        TraceEvent("SimClogPair").detail("A", a.name).detail(
            "B", b.name
        ).detail("Seconds", seconds).log()

    def clog_process(self, p: SimProcess, seconds: float) -> None:
        """Clog EVERY link of `p` (ref: clogInterface,
        sim2.actor.cpp:1454): messages to or from it are held until the
        clog lifts (or unclog_process cuts it short)."""
        until = current_loop().now() + seconds
        self._proc_clogged_until[p.name] = max(
            self._proc_clogged_until.get(p.name, 0.0), until
        )
        TraceEvent("SimClogProcess").detail("Process", p.name).detail(
            "Seconds", seconds
        ).log()

    def unclog_process(self, p: SimProcess) -> None:
        """Lift a process clog immediately (the swizzle's random-order
        unclog step needs explicit lifting, not just expiry)."""
        if self._proc_clogged_until.pop(p.name, None) is not None:
            TraceEvent("SimUnclogProcess").detail("Process", p.name).log()

    def clog_pair_sets(self, aprocs, bprocs, seconds: float) -> None:
        """Clog every link between two process SETS — the machine-pair and
        DC-pair clog (ref: sim2's clogPair over machine addresses): two
        machines (or datacenters) lose sight of each other while each
        keeps talking to everyone else."""
        for a in aprocs:
            for b in bprocs:
                if a.name != b.name:
                    self.clog_pair(a, b, seconds)

    async def swizzle_clog(self, proc_sets, random, max_clog: float = 2.0):
        """The reference's SWIZZLED clogging (ref: RandomClogging.actor.cpp
        swizzleClog): clog all links of a random subset of machines
        (each `proc_sets` entry is one machine's processes), then unclog
        in a DIFFERENT random order, staggered — the overlap windows
        produce partial-connectivity states plain pair clogs never reach.
        """
        from ..core.runtime import current_loop

        loop = current_loop()
        chosen = [ps for ps in proc_sets if random.random01() < 0.5]
        if not chosen:
            chosen = [proc_sets[random.random_int(0, len(proc_sets))]]
        for ps in chosen:
            for p in ps:
                # Long enough to outlive the swizzle; lifted explicitly.
                self.clog_process(p, 1000.0 + max_clog)
            await loop.delay(max_clog * random.random01() * 0.3)
        order = list(chosen)
        # Fisher-Yates off the deterministic PRNG: the unclog order is
        # part of the seed's schedule.
        for i in range(len(order) - 1, 0, -1):
            j = random.random_int(0, i + 1)
            order[i], order[j] = order[j], order[i]
        for ps in order:
            await loop.delay(max_clog * random.random01() * 0.7)
            for p in ps:
                self.unclog_process(p)
        TraceEvent("SimSwizzleDone").detail(
            "Machines", len(chosen)
        ).log()

    def partition(self, a: SimProcess, b: SimProcess) -> None:
        self._partitioned.add(frozenset((a.name, b.name)))
        TraceEvent("SimPartition").detail("A", a.name).detail("B", b.name).log()

    def heal(self, a: SimProcess, b: SimProcess) -> None:
        self._partitioned.discard(frozenset((a.name, b.name)))
        TraceEvent("SimHeal").detail("A", a.name).detail("B", b.name).log()

    def blackout(self, p: SimProcess) -> None:
        """Process stops answering (kill without state loss)."""
        p.alive = False
        TraceEvent("SimBlackout").detail("Process", p.name).log()

    def restore(self, p: SimProcess) -> None:
        p.alive = True
        TraceEvent("SimRestore").detail("Process", p.name).log()

    # -- delivery --
    def _latency(self) -> float:
        return self.base_latency + current_loop().random.random01() * self.jitter

    def deliver(
        self, src: SimProcess, dst: SimProcess, fn: Callable[[], None]
    ) -> None:
        """Schedule fn() on the destination after simulated network delay;
        silently dropped under blackout/partition (the sender learns only
        via its own timeouts, as on a real network)."""
        try:
            loop = current_loop()
        except RuntimeError:
            # Loop torn down (test shutdown GC-ing parked reply relays):
            # the network is gone with it, the message just drops.
            self.messages_dropped += 1
            return
        self.messages_sent += 1
        if not src.alive or not dst.alive or (
            frozenset((src.name, dst.name)) in self._partitioned
        ):
            self.messages_dropped += 1
            return
        delay = self._latency()
        clog = max(
            self._clogged_until.get((src.name, dst.name), 0.0),
            self._proc_clogged_until.get(src.name, 0.0),
            self._proc_clogged_until.get(dst.name, 0.0),
        )
        if clog > loop.now():
            delay += clog - loop.now()

        async def run():
            await loop.delay(delay, TaskPriority.DEFAULT)
            # Re-check liveness at delivery time: a blackout that started
            # while the message was in flight eats it.
            if src.alive and dst.alive and (
                frozenset((src.name, dst.name)) not in self._partitioned
            ):
                fn()
            else:
                self.messages_dropped += 1

        spawn(run(), TaskPriority.DEFAULT, name=f"net:{src.name}->{dst.name}")


class RemoteStream:
    """A PromiseStream endpoint viewed across the simulated network.

    send() forwards the request through the network to the host process's
    stream, with the reply promise relayed back through the network the
    same way — the in-process analogue of FlowTransport's
    RequestStream/ReplyPromise pairing (fdbrpc/fdbrpc.h:146-212): the same
    role code serves both, only the transport changes.
    """

    def __init__(self, net: SimNetwork, src: SimProcess, dst: SimProcess, stream):
        self.net = net
        self.src = src
        self.dst = dst
        self.stream = stream

    def send(self, req) -> None:
        from ..core.runtime import Promise

        client_reply = req.reply
        server_req = replace(req, reply=Promise())

        def relay_back(f):
            def complete():
                if client_reply.is_set():
                    return
                if f.is_error():
                    client_reply.send_error(f._value)
                else:
                    client_reply.send(f._value)

            self.net.deliver(self.dst, self.src, complete)

        server_req.reply.future.add_callback(relay_back)
        self.net.deliver(self.src, self.dst, lambda: self.stream.send(server_req))
