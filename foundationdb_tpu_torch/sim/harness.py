"""SimulatedCluster: the cluster behind the simulated network, plus the
fault arsenal (ref: fdbserver/SimulatedCluster.actor.cpp setup +
workloads/RandomClogging.actor.cpp, MachineAttrition.actor.cpp).

Topology: the transaction-system roles run on a `server` process, clients
on a `client` process; every client<->cluster hop (GRV, commit, storage
reads, watches) crosses the SimNetwork and is subject to latency, clogs,
partitions and blackouts. Role-to-role hops stay in-process for now (the
reference's intra-machine traffic is near-free too); splitting roles onto
separate processes is a topology change here, not a code change —
endpoints are already streams.

The port's copy of foundationdb_tpu/sim/harness.py: the cluster is the
port's LocalCluster on `device` (None: the CUDA card, which must be
present; "cpu" runs the device backends' plain torch versions).
"""

from __future__ import annotations

from ..client.connection import ClusterConnection
from ..client.database import Database
from ..cluster.cluster import LocalCluster
from ..core.runtime import Task, current_loop, spawn
from ..core.trace import TraceEvent
from .network import RemoteStream, SimNetwork, SimProcess


class SimulatedCluster:
    def __init__(self, conflict_set=None, device=None):
        self.net = SimNetwork()
        self.server = SimProcess("server")
        self.client_proc = SimProcess("client")
        self.cluster = LocalCluster(conflict_set=conflict_set,
                                    device=device).start()
        self._fault_tasks: list[Task] = []

        remote = lambda stream: RemoteStream(
            self.net, self.client_proc, self.server, stream
        )
        self.conn = ClusterConnection(
            remote(self.cluster.proxy.grv_stream),
            remote(self.cluster.proxy.commit_stream),
            remote(self.cluster.storage.read_stream),
        )

    def database(self) -> Database:
        return Database(self.cluster, conn=self.conn)

    def stop(self) -> None:
        for t in self._fault_tasks:
            t.cancel()
        self.cluster.stop()

    # -- fault workloads --
    def start_random_clogging(
        self, mean_interval: float = 2.0, max_clog: float = 2.0
    ) -> None:
        """(ref: workloads/RandomClogging.actor.cpp): periodically clog the
        client<->server link for a random duration."""

        async def clogger():
            loop = current_loop()
            while True:
                await loop.delay(mean_interval * (0.5 + loop.random.random01()))
                self.net.clog_pair(
                    self.client_proc, self.server,
                    max_clog * loop.random.random01(),
                )

        self._fault_tasks.append(spawn(clogger(), name="random_clogging"))

    def start_attrition(
        self, mean_interval: float = 5.0, max_outage: float = 1.5
    ) -> None:
        """(ref: workloads/MachineAttrition.actor.cpp): periodically black
        out the server (kill-without-state-loss), then restore it."""

        async def attrition():
            loop = current_loop()
            while True:
                await loop.delay(mean_interval * (0.5 + loop.random.random01()))
                outage = max_outage * (0.2 + 0.8 * loop.random.random01())
                self.net.blackout(self.server)
                await loop.delay(outage)
                self.net.restore(self.server)
                TraceEvent("SimAttritionDone").detail("Outage", outage).log()

        self._fault_tasks.append(spawn(attrition(), name="attrition"))
