"""One-process cluster wiring (SURVEY.md §7 step 3).

Builds the full commit path — master (version authority) -> proxy (batcher
+ 5-phase pipeline) -> resolver role (over a pluggable ConflictSet backend)
-> memory tlog -> MVCC storage — on the current deterministic event loop
and hands back a `Database` client.

The port's twin of foundationdb_tpu/cluster/cluster.py. By default both
device components run on the CUDA card: the resolver role's conflict set
is ConflictSetGPU and the storage server's MVCC window is KeyValueStoreGPU
(SERVER_KNOBS.STORAGE_ENGINE_IMPL, storage_engine/factory.py), both on
`device` (None: the card, which must be present; "cpu" runs their plain
torch versions). Passing `conflict_set` (for example the oracle
ConflictSetCPU) replaces the resolver's backend; the storage knob set to
"memory" gives the host VersionedMap window.
"""

from __future__ import annotations

from ..resolver.gpu import ConflictSetGPU
from .master import Master
from .proxy import CommitProxy
from .ratekeeper import Ratekeeper
from .resolver_role import ResolverRole
from .storage import StorageServer
from .tlog import MemoryTLog


class LocalCluster:
    def __init__(self, conflict_set=None, init_version: int = 0,
                 device=None):
        self.master = Master(init_version)
        self.resolver = ResolverRole(
            conflict_set if conflict_set is not None
            else ConflictSetGPU(init_version, device=device),
            init_version,
        )
        self.tlog = MemoryTLog(init_version)
        self.storage = StorageServer(self.tlog, init_version, device=device)
        self.ratekeeper = Ratekeeper(self.tlog, self.storage)
        self.proxy = CommitProxy(self.master, self.resolver, self.tlog,
                                 ratekeeper=self.ratekeeper)
        self._started = False

    def start(self) -> "LocalCluster":
        assert not self._started
        self._started = True
        from ..core.metrics import global_registry

        reg = global_registry()
        self.tlog.register_metrics(reg)
        self.storage.register_metrics(reg)
        self.storage.start()
        self.ratekeeper.start()
        self.proxy.start()
        return self

    def stop(self) -> None:
        self.proxy.stop()
        self.ratekeeper.stop()
        self.storage.stop()
        self._started = False

    def database(self):
        from ..client.database import Database

        return Database(self)
