"""Cluster files + leader/interface discovery (ref:
fdbclient/MonitorLeader.actor.cpp — clients bootstrap from the fdb.cluster
connection string, poll the coordinators for the current cluster
interface, and re-resolve whenever a recovery changes it).

The connection string format is the reference's
(`description:id@host1,host2,host3`, documentation/.../api-general):
here the host part names in-process coordinator registers; the
real-network tier resolves the same names to transport addresses.

Discovery protocol: each recovery publishes the new generation's
endpoints into a dedicated coordinated register ("clusterInterface");
`monitor_cluster_interface` polls it with quorum reads and repoints the
client's EndpointRefs when the generation changes — so a client built
ONLY from coordinators follows recoveries with no shared in-process
references, exactly the monitorLeader contract.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from ..core.errors import OperationFailed
from ..core.runtime import Task, current_loop, spawn
from ..core.trace import TraceEvent
from .coordination import CoordinatedState

INTERFACE_KEY = "clusterInterface"


@dataclass
class ClusterFile:
    """(ref: the fdb.cluster file, parsed/rewritten by MonitorLeader)."""

    description: str
    cluster_id: str
    coordinators: list[str]

    _RE = re.compile(r"^([A-Za-z0-9_]+):([A-Za-z0-9_]+)@(.+)$")

    @classmethod
    def parse(cls, text: str) -> "ClusterFile":
        m = cls._RE.match(text.strip())
        if not m:
            raise ValueError(f"malformed cluster string {text!r}")
        coords = [c.strip() for c in m.group(3).split(",") if c.strip()]
        if not coords:
            raise ValueError("cluster string names no coordinators")
        return cls(m.group(1), m.group(2), coords)

    def to_text(self) -> str:
        return f"{self.description}:{self.cluster_id}@" + ",".join(
            self.coordinators
        )

    @classmethod
    def load(cls, path: str) -> "ClusterFile":
        with open(path) as f:
            return cls.parse(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_text() + "\n")

    def change_coordinators(self, new: list[str]) -> "ClusterFile":
        """(ref: coordinators change rewriting the file with a NEW id so
        stale files are detectable)."""
        loop = current_loop()
        new_id = f"{loop.random.random_int(0, 1 << 30):08x}"
        return ClusterFile(self.description, new_id, list(new))


def publish_interface(coordinators, info: dict) -> None:
    """Recovery-side: advertise the new generation's endpoints (ref: the
    leader interface the coordinators serve to clients)."""
    cs = CoordinatedState(coordinators, key=INTERFACE_KEY)

    def update(cur):
        if cur is not None and cur.get("generation", -1) >= info["generation"]:
            return cur  # never regress to an older generation
        return info

    cs.read_modify_write(update)


def monitor_cluster_interface(coordinators, refs: dict,
                              storage_endpoints: Optional[dict] = None,
                              interval: float = 0.2) -> Task:
    """Client-side poller: repoints `refs` (name -> EndpointRef) and the
    storage endpoint map whenever the advertised generation changes (ref:
    monitorLeaderInternal's long-poll loop)."""

    async def run():
        from ..core.runtime import buggify

        loop = current_loop()
        cs = CoordinatedState(coordinators, key=INTERFACE_KEY)
        known = -1
        while True:
            if buggify("monitor_leader_slow_discovery"):
                # Clients keep retrying against stale endpoints meanwhile.
                await loop.delay(0.5 * loop.random.random01())
            try:
                info = cs.read(cs._fresh_gen())
            except OperationFailed:
                info = None  # quorum blip: keep the last-known endpoints
            if info is not None and info.get("generation", -1) != known:
                known = info["generation"]
                for name, ref in refs.items():
                    ref.target = info.get(name)
                if storage_endpoints is not None and "storage" in info:
                    storage_endpoints.clear()
                    storage_endpoints.update(info["storage"])
                TraceEvent("ClusterInterfaceChanged").detail(
                    "Generation", known
                ).log()
            await loop.delay(interval * (0.75 + 0.5 * loop.random.random01()))

    return spawn(run(), name="monitorLeader")


def connect(coordinators):
    """Build a database handle from COORDINATORS ALONE — the client's
    bootstrap path (ref: Database creation from a cluster file). Returns
    (database, monitor_task); cancel the task to disconnect."""
    from ..client.connection import ShardedConnection
    from ..client.database import Database
    from .recovery import EndpointRef

    refs = {"grv": EndpointRef(), "commit": EndpointRef(),
            "location": EndpointRef()}
    storage_endpoints: dict = {}
    task = monitor_cluster_interface(coordinators, refs, storage_endpoints)
    conn = ShardedConnection(
        refs["grv"], refs["commit"], refs["location"], storage_endpoints
    )
    db = Database(None, conn=conn)
    return db, task
