"""Master: the version authority (ref: fdbserver/masterserver.actor.cpp).

Assigns each commit batch a half-open version window (prevVersion, version]
(getVersion :763-830): versions advance with wall/sim time at
VERSIONS_PER_SECOND so the MVCC window measured in versions corresponds to
real seconds (fdbserver/Knobs.cpp:59), and every batch learns the previous
batch's version so downstream roles (resolver, tlog) can enforce total
commit order by (prevVersion -> version) chaining.

Also tracks the cluster's committed version for GRV
(getLiveCommittedVersion, MasterProxyServer.actor.cpp:875 asks the master).
"""

from __future__ import annotations

from ..core.actors import NotifiedVersion
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import buggify, current_loop
from ..core.trace import TraceEvent


class Master:
    def __init__(self, init_version: int = 0):
        self.version = init_version        # last assigned commit version
        self.committed = NotifiedVersion(init_version)  # durable + reported
        # Reply-release chain of the commit-plane pipeline: windows may
        # resolve/log out of order across the (possibly several) proxies
        # of this generation, but client replies release strictly in
        # commit-version order (proxy.py phase 5 gates on it and advances
        # it after answering). It lives HERE because version windows are
        # assigned globally: a proxy's predecessor window may belong to
        # another proxy (ref: the committed-version chain the reference's
        # commitBatch waits on, masterserver.actor.cpp).
        self.replied = NotifiedVersion(init_version)
        self._reference_time = None        # (time, version) anchor

    def get_commit_version(self) -> tuple[int, int]:
        """(prevVersion, version] window for one commit batch."""
        loop = current_loop()
        prev = self.version
        if self._reference_time is None:
            self._reference_time = (loop.now(), self.version)
        t0, v0 = self._reference_time
        target = v0 + int(
            (loop.now() - t0) * SERVER_KNOBS.VERSIONS_PER_SECOND
        )
        # At least +1; at most MAX_READ_TRANSACTION_LIFE_VERSIONS per
        # batch (ref: getVersion clamps per batch,
        # masterserver.actor.cpp:784-800).
        step = max(1, target - self.version)
        if buggify("master_version_jump"):
            step += SERVER_KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS // 2
        step = min(step, SERVER_KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS)
        # Versions-in-flight bound: with PROXY_PIPELINE_DEPTH windows
        # dispatching before their elders report committed, assigned
        # versions must not run unboundedly ahead of the committed
        # frontier (ref: getVersion's MAX_VERSIONS_IN_FLIGHT wait) — clamp
        # the step so version stays within one read-transaction lifetime
        # of committed, while every window still advances by >= 1.
        room = (self.committed.get()
                + SERVER_KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS - prev)
        step = max(1, min(step, room))
        self.version = prev + step
        TraceEvent("MasterGetVersion").detail("Version", self.version).log()
        return prev, self.version

    def report_committed(self, version: int) -> None:
        """Proxy reports a batch fully durable (ref: updateCommittedVersion
        path via masterProxyServerCore)."""
        if version > self.committed.get():
            self.committed.set(version)

    def get_live_committed_version(self) -> int:
        """(ref: getLiveCommittedVersion, masterserver.actor.cpp:830 +
        MasterProxyServer.actor.cpp:875)."""
        return self.committed.get()
