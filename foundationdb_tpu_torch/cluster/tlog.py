"""In-memory transaction log (ref: fdbserver/TLogServer.actor.cpp).

Holds the committed mutation stream in version order; storage servers pull
from it (peek, :903) and advance their popped version (pop, :861). Commits
chain by (prevVersion -> version) exactly like tLogCommit :1115 — a commit
for version v waits until v's predecessor is durable, so the durable prefix
is always contiguous.

This is the memory tier; the durable DiskQueue-backed tier
(fdbserver/DiskQueue.actor.cpp two-file design) layers underneath it via
the storage engine work (SURVEY §7 step 4) without changing this interface.
"""

from __future__ import annotations

from ..core.actors import NotifiedVersion, PromiseStream, serve_requests
from ..core.errors import TLogStopped
from ..core.runtime import buggify, current_loop
from ..core.trace import TraceEvent, trace_txn_event


class MemoryTLog:
    def __init__(self, init_version: int = 0):
        self.commit_stream: PromiseStream = PromiseStream()
        self._entries: list[tuple[int, list]] = []  # (version, mutations)
        self.version = NotifiedVersion(init_version)   # highest received
        self.durable = NotifiedVersion(init_version)   # highest "fsynced"
        self.popped = init_version
        self.locked_epoch = 0
        # Versions <= available_from cannot be served by THIS log: they
        # were popped, or lost with a destroyed/behind incarnation and
        # recovered past by the lock quorum. Replicated tag cursors fail
        # over to a covering replica (log_system.TagView).
        self.available_from = init_version
        # Cleared while the hosting machine/process is dark (sim fault
        # topology flips it); a dark log can neither join the fsync
        # quorum nor serve peeks.
        self.reachable = True

    def queue_bytes(self) -> int:
        """Un-popped payload this log holds (ratekeeper/metrics input,
        ref: TLogQueueInfo). Spilled backlog counts too — the queue does
        not shrink just because it moved to disk."""
        total = sum(
            len(tm.mutation.param1) + len(tm.mutation.param2)
            for _, tms in self._entries for tm in tms
        )
        return total + getattr(self, "spilled_bytes", 0)

    def register_metrics(self, registry=None, labels=()) -> None:
        """Register this log's gauges on the per-process MetricRegistry
        (callers pass a `log` label for multi-log fleets)."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        lbl = tuple(labels)
        reg.register_gauge("tlog.latest_version",
                           lambda: self.version.get(),
                           labels=lbl, replace=True)
        reg.register_gauge("tlog.durable_version",
                           lambda: self.durable.get(),
                           labels=lbl, replace=True)
        reg.register_gauge(
            "tlog.queue_entries",
            lambda: len(self._entries) + getattr(self, "spilled_entries", 0),
            labels=lbl, replace=True,
        )
        reg.register_gauge("tlog.queue_bytes", self.queue_bytes,
                           labels=lbl, replace=True)

    def lock(self, epoch: int) -> int:
        """Epoch end (ref: TagPartitionedLogSystem::epochEnd :107): fence
        out every older generation — their in-flight commits will fail —
        and return the durable version the new generation recovers from.
        Entries received but never durable are PURGED: they belong to
        commits that never completed and must never become visible (their
        versions are simply skipped; storage follows the entry stream)."""
        assert epoch >= self.locked_epoch, "lock() by an older generation"
        self.locked_epoch = epoch
        d = self.durable.get()
        self._entries = [e for e in self._entries if e[0] <= d]
        # Advance the durability cursor over the purged gap so the new
        # generation's chain (which must start above every RECEIVED
        # version) can make progress; the gap holds no entries, so nothing
        # un-durable is ever exposed. Old-generation commits woken by this
        # advance re-check the epoch below and fail.
        self.durable.set(self.version.get())
        TraceEvent("TLogLocked").detail("Epoch", epoch).detail(
            "RecoveryVersion", d
        ).detail("ReceivedVersion", self.version.get()).log()
        return d

    async def commit(self, prev_version: int, version: int, mutations: list,
                     epoch: int = 0, debug_id=None):
        """Append one batch's mutations; resolves when durable (ref:
        tLogCommit waits version order then fsyncs via DiskQueue). A commit
        from a generation older than the lock epoch is refused.
        `debug_id` is the flight recorder's batch ID: a sampled batch
        emits TLog.Durable from THIS log's process once its copy is
        durable."""
        if epoch < self.locked_epoch:
            raise TLogStopped(f"locked by generation {self.locked_epoch}")
        await self.version.when_at_least(prev_version)
        if epoch < self.locked_epoch:  # re-check: lock may land mid-wait
            raise TLogStopped(f"locked by generation {self.locked_epoch}")
        if self.version.get() == prev_version:
            # Sole appender for this version window. Empty batches are
            # logged too: version advances must reach storage servers or a
            # GRV at the new committed version could never be served (the
            # reference's proxies push every batch, even empty, so tlog
            # cursors carry the version stream — commitBatch :800).
            self._entries.append((version, mutations))
            self.version.set(version)
        if buggify("tlog_slow_fsync"):
            await current_loop().delay(0.1 * current_loop().random.random01())
        await self.durable.when_at_least(prev_version)
        if epoch < self.locked_epoch:
            raise TLogStopped(f"locked by generation {self.locked_epoch}")
        if self.durable.get() == prev_version:
            self.durable.set(version)
            TraceEvent("TLogCommitDurable").detail("Version", version).log()
        await self.durable.when_at_least(version)
        # Final fence: a lock() that purged this batch also advanced the
        # durability cursor past it, waking this waiter — it must fail, not
        # report a never-durable commit as committed.
        if epoch < self.locked_epoch:
            raise TLogStopped(f"locked by generation {self.locked_epoch}")
        trace_txn_event("TLog.Durable", debug_id, Version=version)

    def confirm_epoch(self, epoch: int) -> None:
        """confirmEpochLive's per-log check (ref: TagPartitionedLogSystem::
        confirmEpochLive, fdbserver/TagPartitionedLogSystem.actor.cpp:553):
        a generation may only act on this log — in particular, answer GRVs
        from its master's committed version — while the log has not been
        locked by a newer generation. Raises TLogStopped otherwise."""
        if epoch < self.locked_epoch:
            raise TLogStopped(
                f"epoch {epoch} fenced by generation {self.locked_epoch}"
            )

    async def peek(self, from_version: int) -> list[tuple[int, list]]:
        """All DURABLE entries with version > from_version; awaits until at
        least one exists (ref: tLogPeekMessages blocking peek). Non-durable
        entries are invisible: storage must never apply (and e.g. fire
        watches for) a commit that could still be lost, or a reader could
        observe a commit before its client's commit() resolves."""
        if buggify("tlog_slow_peek"):
            # Storage cursors fall behind: un-popped log grows, and the
            # ratekeeper's queue-bytes input must react.
            await current_loop().delay(0.1 * current_loop().random.random01())
        while True:
            d = self.durable.get()
            out = [e for e in self._entries if from_version < e[0] <= d]
            if out:
                from .commit_wire import maybe_wire_peek

                return maybe_wire_peek(out)
            await self.durable.when_at_least(
                max(d, from_version) + 1
            )

    def start_serving(self):
        """Serve TLogCommitRequests from self.commit_stream so the
        proxy->log hop can cross a (simulated) network like the reference's
        RPC (TLogInterface.commit RequestStream). The reply resolves once
        the batch is durable; fence errors propagate to the caller."""
        from ..core.runtime import TaskPriority

        async def handle(req):
            from .interfaces import ConfirmEpochLiveRequest

            if isinstance(req, ConfirmEpochLiveRequest):
                self.confirm_epoch(req.epoch)
                return None
            await self.commit(req.prev_version, req.version, req.mutations,
                              epoch=req.epoch,
                              debug_id=getattr(req, "debug_id", None))
            return None

        return serve_requests(self.commit_stream, handle,
                              TaskPriority.TLOG_COMMIT, "tlogServe")

    def pop(self, upto_version: int) -> None:
        """Storage acknowledges durability through upto_version; the log can
        discard that prefix (ref: tLogPop)."""
        if upto_version <= self.popped:
            return
        self.popped = upto_version
        self._entries = [e for e in self._entries if e[0] > upto_version]
        self.available_from = max(self.available_from, upto_version)

    def skip_to(self, version: int) -> None:
        """Recovery gap-skip: advance the (received, durable) cursors to
        the new generation's start version without any entries. Needed on
        cold boot, where logs recover to DIFFERENT durable tops (one log
        fsynced a batch its peer hadn't when the process died): the behind
        log would otherwise block the new chain's when_at_least forever.
        Storage follows the entry stream, so the skipped window is
        invisible to it (same contract as lock()'s purge gap)."""
        if version > self.version.get():
            self.version.set(version)
        if version > self.durable.get():
            self.durable.set(version)

    def truncate_above(self, version: int) -> None:
        """Epoch-end quorum truncation: discard entries above the recovery
        version the log QUORUM agreed on (ref: epochEnd — a commit whose
        fsync quorum never completed never happened). Under k-way
        replication the quorum version may exceed THIS log's durable top
        (this log is one of the excludable k-1 worst); the missing window
        is marked unavailable so replicated tag cursors fail over to the
        peers that durably hold it. The durable tier overrides this to
        persist the truncation."""
        top = self._entries[-1][0] if self._entries else self.popped
        self._entries = [e for e in self._entries if e[0] <= version]
        if top < version:
            self.available_from = max(self.available_from, version)

    def quorum_durable(self) -> int:
        """The version durable across the WHOLE log quorum this log is part
        of — for a solo log, its own cursor. Storage engines flush only up
        to this horizon: anything beneath it can never be rolled back by a
        recovery (the recovery version is the quorum minimum, and it is
        monotone), so disk state never needs un-writing."""
        return self.durable.get()
