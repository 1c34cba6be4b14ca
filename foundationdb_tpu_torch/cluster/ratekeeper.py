"""Ratekeeper: cluster-wide admission control (ref:
fdbserver/Ratekeeper.actor.cpp).

The reference tracks every storage server's and tlog's queue depth
(StorageQueueInfo :77) and computes a transactions-per-second budget from
the worst queues (updateRate :253-513); the master distributes the rate to
proxies, which delay GRVs so new transactions start no faster than the
cluster drains (MasterProxyServer.actor.cpp:85-150). Same control loop
here: the monitored signals are the storage node's version lag behind the
durable log (the MVCC pipeline's queue) and the log's unpopped backlog;
the actuator is a token bucket consulted by the proxy's GRV batcher.
"""

from __future__ import annotations

from ..core.knobs import SERVER_KNOBS
from ..core.runtime import Task, current_loop, spawn
from ..core.trace import TraceEvent


class Ratekeeper:
    def __init__(self, tlog, storage):
        self.tlog = tlog
        # Operator throttle (ref: fdbcli `throttle`): None = automatic
        # only; a number caps the computed rate. Per-instance state.
        self.manual_limit = None
        # One storage server or a fleet: the rate follows the WORST lag,
        # exactly like the reference's worst-queue selection (updateRate's
        # limiting storage server, Ratekeeper.actor.cpp:310-380).
        self.storages = list(storage) if isinstance(storage, (list, tuple)) \
            else [storage]
        # Tags DD/failure detection declared dead: a failed server's
        # frozen version must not clamp the cluster's rate forever (the
        # reference excludes failure-monitor-failed servers from the
        # limiting computation).
        self.excluded_tags: set = set()
        self.tps_limit = float("inf")
        self._tokens = 0.0
        self._last_refill = 0.0
        self._task: Task | None = None
        # Smoothed lag (ref: smoothDurableBytes etc. — Smoother-filtered
        # queue signals so one slow fsync doesn't slam the rate to zero).
        from ..core.stats import Smoother

        self._lag = Smoother(e_folding_time=1.0)
        # Control targets (ref: Knobs TARGET_BYTES_PER_STORAGE_SERVER /
        # MAX_VERSION_DIFFERENCE family, restated in version-lag terms).
        self.target_lag_versions = SERVER_KNOBS.STORAGE_DURABILITY_LAG_VERSIONS // 10
        self.max_lag_versions = SERVER_KNOBS.STORAGE_DURABILITY_LAG_VERSIONS

    def register_metrics(self, registry=None) -> None:
        """The control loop's observable state on the MetricRegistry: the
        computed admission limit and the smoothed lag driving it — the
        queue telemetry the reference's Ratekeeper scrapes, re-exported."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        reg.register_gauge(
            "ratekeeper.limit_tps",
            lambda: -1.0 if self.tps_limit == float("inf")
            else round(self.tps_limit, 3),
            replace=True,
            help="admission budget in tps (-1 = unlimited)",
        )
        reg.register_smoother("ratekeeper.smoothed_lag_versions", self._lag,
                              replace=True)
        reg.register_gauge(
            "ratekeeper.durability_lag_versions",
            lambda: self._durable() - min(
                s.version.get() for s in self._live_storages()
            ),
            replace=True,
        )

    def start(self) -> None:
        self._task = spawn(self._update_loop(), name="ratekeeper")
        self.register_metrics()

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def set_excluded(self, tags) -> None:
        self.excluded_tags = set(tags)

    def _live_storages(self):
        live = [s for s in self.storages
                if getattr(s, "tag", None) not in self.excluded_tags]
        return live or self.storages

    def _durable(self) -> int:
        if hasattr(self.tlog, "durable_version"):
            return self.tlog.durable_version()
        return self.tlog.durable.get()

    # -- control loop (ref: updateRate) --
    def _compute_rate(self) -> float:
        auto = self._compute_rate_auto()
        if self.manual_limit is not None:
            return min(auto, float(self.manual_limit))
        return auto

    def _compute_rate_auto(self) -> float:
        raw = self._durable() - min(
            s.version.get() for s in self._live_storages()
        )
        self._lag.set_total(raw)
        # Smoothing damps transient spikes; a genuinely drained pipeline
        # lifts the limit immediately (throttling longer than the backlog
        # exists only hurts).
        if raw <= self.target_lag_versions:
            self._lag.reset(raw)
        lag = self._lag.smooth_total()
        if lag <= self.target_lag_versions:
            return float("inf")
        if lag >= self.max_lag_versions:
            return 0.0
        # Linear back-off between target and max, against a nominal
        # full-speed rate (the reference smooths against measured release
        # rates; the shape of the controller is what matters here).
        frac = 1.0 - (lag - self.target_lag_versions) / (
            self.max_lag_versions - self.target_lag_versions
        )
        return max(10.0, frac * 100_000.0)

    async def _update_loop(self):
        from ..core.runtime import buggify

        loop = current_loop()
        while True:
            await loop.delay(SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL)
            if buggify("ratekeeper_stale_update"):
                # A tick's worth of stale inputs (slow status RPCs).
                await loop.delay(
                    SERVER_KNOBS.RATEKEEPER_UPDATE_INTERVAL
                    * loop.random.random01()
                )
            new_rate = self._compute_rate()
            if buggify("ratekeeper_budget_collapse", 0.1):
                new_rate = 1.0  # transient near-zero admission
            if new_rate != self.tps_limit:
                TraceEvent("RkUpdate").detail("TPSLimit", new_rate).detail(
                    "DurabilityLag",
                    self._durable()
                    - min(s.version.get() for s in self._live_storages()),
                ).log()
            self.tps_limit = new_rate

    # -- actuator: token bucket the GRV batcher draws on --
    def admit_transactions(self, n: int) -> int:
        """How many of n new transactions may start now (a PREFIX of the
        batch — the rest is deferred). Admitting prefixes rather than
        all-or-nothing means a batch larger than one second of budget
        still trickles through at the limit instead of starving (ref: the
        proxy's transactionStarter draining its rate budget)."""
        if self.tps_limit == float("inf"):
            return n
        loop = current_loop()
        now = loop.now()
        elapsed = now - self._last_refill
        self._last_refill = now
        self._tokens = min(
            max(self.tps_limit, 1.0),  # burst cap: one second of budget
            self._tokens + elapsed * self.tps_limit,
        )
        k = min(n, int(self._tokens))
        self._tokens -= k
        return k
