"""Commit proxy: batching + the 5-phase commit pipeline + GRV service
(ref: fdbserver/MasterProxyServer.actor.cpp).

commitBatch (:314) phases, reproduced 1:1:
  1 (:352) order by batch number, get the version window from the master;
  2 (:410) resolve — ship each txn's conflict ranges to the resolver(s)
           and await verdicts;
  3 (:414) merge verdicts and build the log payload from committed txns;
  4 (:800) push to the tlog and wait durability;
  5 (:804) advance the committed version and answer every client.

Successive batches PIPELINE: phase 1 of batch k+1 can start while batch k
is still logging, but version order is enforced where it matters — the
resolver chains on (prevVersion -> version) and the tlog chains durability
the same way (the reference's latestLocalCommitBatchResolving/Logging
NotifiedVersion pair, :352-417 — realized here by the same primitive).

The pipeline is EXPLICIT and bounded (the commit-plane twin of PR 7's
resolver pipelining, cluster/resolver_role.py): up to
SERVER_KNOBS.PROXY_PIPELINE_DEPTH commit versions are simultaneously in
flight across the proxy->resolver->tlog stages, governed by two chains —

  window take  a batch draws its (prev, version] window only when fewer
               than `depth` older windows await replies, so version
               assignment order IS dispatch order and backlog is bounded;
  _replied     a NotifiedVersion gating phase 5: replies (success AND
               every failure path) release in commit-version order, so
               clients observe exactly the serial path's reply semantics.

Depth 1 degenerates to the strictly serial one-window-at-a-time plane.
Per-stage wall (grv / batch form / resolve / tlog) rides ContinuousSample
reservoirs surfaced as the `commit_pipeline` status-json block.

Batch formation is ADAPTIVE: the batcher's deadline floats between the
INTERVAL_MIN/MAX knobs on recent-fill feedback against
COMMIT_BATCH_BYTES_TARGET (_AdaptiveBatchInterval; ref: the reference's
dynamic commitBatchInterval, MasterProxyServer.actor.cpp:244-262) —
underfull deadline-closed batches stretch the wait to coalesce more per
batch, full batches shave it back toward MIN.

GRV (getConsistentReadVersion, :925 transactionStarter): batches client
requests on GRV_BATCH_INTERVAL and answers with the master's live committed
version, so a read version can never precede a commit it was issued after.
When SERVER_KNOBS.GRV_CACHE_STALENESS_MS > 0 the quorum-liveness probe is
AMORTIZED across batches: a batch whose last successful confirm-epoch-live
is younger than the staleness bound serves the live committed version
without re-confirming (the fast path), bounding the stale-read window a
partitioned deposed proxy could serve to the knob's value — orders of
magnitude below any recovery — while heavy traffic pays one confirm per
staleness window instead of one per batch.
"""

from __future__ import annotations

from ..core.actors import ActorCollection, PromiseStream
from ..core.errors import NotCommitted, OperationFailed, TLogStopped, TransactionTooOld
from ..core.knobs import CLIENT_KNOBS, SERVER_KNOBS
from ..core.runtime import TaskPriority, buggify, current_loop, spawn
from ..core.trace import (
    TraceEvent,
    new_debug_id,
    trace_txn_attach,
    trace_txn_event,
)
from ..kv.keys import KeyRange
from ..resolver.types import COMMITTED, TOO_OLD, TxnConflictInfo
from .batcher import batcher
from .interfaces import (
    CommitID,
    CommitTransactionRequest,
    GetReadVersionRequest,
    Mutation,
    ResolveTransactionBatchRequest,
    TLogCommitRequest,
)
from .master import Master
from .resolver_role import ResolverRole
from .tlog import MemoryTLog


def mutation_write_ranges(m: Mutation) -> KeyRange:
    from ..kv.atomic import MutationType
    from ..kv.keys import key_after

    if m.type == MutationType.CLEAR_RANGE:
        return KeyRange(m.param1, m.param2)
    return KeyRange(m.param1, key_after(m.param1))


def commit_request_bytes(r: CommitTransactionRequest) -> int:
    """Byte estimate of one commit request (mutations + conflict ranges)
    — the batcher's bytes_of for COMMIT_BATCH_BYTES_TARGET coalescing."""
    n = 64
    for m in r.mutations:
        n += 16 + len(m.param1) + len(m.param2)
    for kr in r.read_conflict_ranges:
        n += len(kr.begin) + len(kr.end)
    for kr in r.write_conflict_ranges:
        n += len(kr.begin) + len(kr.end)
    return n


class _AdaptiveBatchInterval:
    """Floating commit-batch deadline (ref: the reference's dynamic
    commitBatchInterval feedback, MasterProxyServer.actor.cpp:244-262 —
    Ratekeeper-style control, not a fixed knob). Two signals:

    - smoothed PIPELINE LATENCY of recent batches (window take -> replies
      released): the deadline tracks LATENCY_FRACTION of it, so batch
      formation never costs more than ~10% of what the pipeline itself
      takes — light load keeps the wait near MIN, a loaded pipeline
      affords (and rewards) more coalescing;
    - smoothed FILL against the count/byte targets: batches that fill
      before the deadline pin the wait at MIN — load forms full batches
      without any coalescing delay (the byte/count triggers close them).

    Clamped to [COMMIT_TRANSACTION_BATCH_INTERVAL_MIN, _MAX]."""

    LATENCY_FRACTION = 0.1

    def __init__(self):
        self.value = float(SERVER_KNOBS.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN)
        self._fill = 0.0      # smoothed fill fraction of recent batches
        self._lat = 0.0       # smoothed batch pipeline latency (s)

    def _clamp(self, v: float) -> float:
        lo = SERVER_KNOBS.COMMIT_TRANSACTION_BATCH_INTERVAL_MIN
        hi = max(lo, SERVER_KNOBS.COMMIT_TRANSACTION_BATCH_INTERVAL_MAX)
        return min(hi, max(lo, v))

    def record_close(self, closed_by: str, n_txns: int, n_bytes: int) -> None:
        fill = max(
            n_txns / max(1, SERVER_KNOBS.COMMIT_TRANSACTION_BATCH_COUNT_MAX),
            n_bytes / max(1, SERVER_KNOBS.COMMIT_BATCH_BYTES_TARGET),
        )
        if closed_by != "deadline":
            fill = 1.0
        self._fill = 0.75 * self._fill + 0.25 * min(1.0, fill)

    def record_latency(self, batch_s: float) -> None:
        self._lat = (0.8 * self._lat + 0.2 * batch_s) if self._lat \
            else batch_s
        target = self.LATENCY_FRACTION * self._lat
        if self._fill > 0.75:
            # Full batches: the count/byte triggers are doing the
            # closing; any deadline slack only adds latency.
            target = 0.0
        self.value = self._clamp(target)


class CommitProxy:
    def __init__(self, master: Master, resolver: ResolverRole, tlog: MemoryTLog,
                 ratekeeper=None, generation: int = 0,
                 resolver_endpoint=None, tlog_endpoint=None,
                 log_system=None, shard_map=None,
                 resolvers=None, resolver_config=None,
                 metrics_labels=()):
        self.metrics_labels = tuple(metrics_labels)
        self.master = master
        self.resolver = resolver
        # Multi-resolver mode (ref: ResolutionRequestBuilder): when
        # `resolvers` + `resolver_config` are given, phase 2 clips each
        # txn's conflict ranges per resolver coverage and merges verdicts
        # with max; `resolver` is then resolvers[0] (system-keyspace home).
        self.resolvers = resolvers
        self.resolver_config = resolver_config
        # Per-resolver last window THIS proxy received state for (drives
        # the catch-up payload in replies — Resolver.actor.cpp:171-190).
        self._last_receive = 0
        # Merged-verdict feedback owed to resolver 0 (windows resolved by
        # this proxy whose system mutations await promotion).
        self._feedback: list = []
        self.tlog = tlog
        self.ratekeeper = ratekeeper
        self.generation = generation
        # When set, the resolver/log hops go through request endpoints
        # (possibly across a simulated network) instead of direct calls —
        # the role code is identical either way, as with FlowTransport.
        self.resolver_endpoint = resolver_endpoint
        self.tlog_endpoint = tlog_endpoint
        # Sharded tier: mutations are tagged per the shard map and pushed
        # through the tag-partitioned log system instead of the single
        # tlog (ref: phase-3 tag assignment + LogPushData,
        # MasterProxyServer.actor.cpp:414-800).
        self.log_system = log_system
        self.shard_map = shard_map
        # Committed mutations on \xff keys are interpreted here, exactly
        # like applyMetadataMutations updating the proxy's caches (ref:
        # fdbserver/ApplyMetadataMutation.h; called from commitBatch
        # phase 3, MasterProxyServer.actor.cpp:449).
        self.metadata_hook = None
        # Extra log tags every mutation is shipped to (DR subscribers).
        self.dr_tags: tuple = ()
        self.commit_stream: PromiseStream[CommitTransactionRequest] = PromiseStream()
        self.grv_stream: PromiseStream[GetReadVersionRequest] = PromiseStream()
        # Shard-location service (ref: readRequestServer :1036).
        self.location_stream: PromiseStream = PromiseStream()
        self._tasks = ActorCollection()
        # Commit-plane pipeline state (see module docstring): ascending
        # in-flight commit versions between window take and reply, the
        # reply-order chain, and the per-stage timing reservoirs.
        from collections import deque

        from ..core.stats import ContinuousSample

        self._commit_inflight: deque[int] = deque()
        # The reply-order chain is GLOBAL (master.replied): with several
        # proxies per generation a window's predecessor may belong to a
        # sibling proxy, so gating on a proxy-local chain would deadlock.
        # The in-flight window bound stays per proxy.
        self._replied = master.replied
        self.max_commit_inflight = 0
        self.commit_stage_samples = {
            k: ContinuousSample(256)
            for k in ("grv_ms", "form_ms", "resolve_ms", "tlog_ms")
        }
        # Latency bands (core/stats.LatencyBands; ref: fdbclient's
        # latency_bands status): GRV and commit request latencies bucketed
        # into the knob-configured edges, surfaced per role in status json
        # and over TxnStatusRequest.
        from ..core.stats import LatencyBands

        self.latency_bands = {"grv": LatencyBands(), "commit": LatencyBands()}
        self._batch_interval = _AdaptiveBatchInterval()
        # GRV fast path: loop time of the last SUCCESSFUL epoch confirm
        # (None until one lands — the first batch always confirms).
        self._grv_confirmed_at = None
        # Commit statistics, flushed periodically as TraceEvents (ref:
        # ProxyStats, flow/Stats.h:55 CounterCollection).
        from ..core.stats import CounterCollection

        self.stats = CounterCollection("ProxyStats", id_="proxy")
        self._c_committed = self.stats.counter("TxnsCommitted")
        self._c_conflicted = self.stats.counter("TxnsConflicted")
        self._c_too_old = self.stats.counter("TxnsTooOld")
        self._c_grv = self.stats.counter("GRVsServed")
        self._c_grv_throttled = self.stats.counter("GRVsThrottled")
        self._c_grv_cached = self.stats.counter("GRVsCachedFastPath")
        self.register_metrics()

    def register_metrics(self, registry=None) -> None:
        """Register this proxy's instruments on the per-process
        MetricRegistry under stable dotted names (replace=True: a
        recovered generation's proxy supersedes its predecessor's)."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        lbl = self.metrics_labels
        for name, c in (
            ("proxy.txns_committed", self._c_committed),
            ("proxy.txns_conflicted", self._c_conflicted),
            ("proxy.txns_too_old", self._c_too_old),
            ("proxy.grvs_served", self._c_grv),
            ("proxy.grvs_throttled", self._c_grv_throttled),
            ("proxy.grvs_cached", self._c_grv_cached),
        ):
            reg.register_counter(name, c, labels=lbl, replace=True)
        reg.register_bands("proxy.grv_ms", self.latency_bands["grv"],
                           labels=lbl, replace=True)
        reg.register_bands("proxy.commit_ms", self.latency_bands["commit"],
                           labels=lbl, replace=True)
        for stage, s in self.commit_stage_samples.items():
            reg.register_sample(
                "proxy.commit_stage_ms", s,
                labels=lbl + (("stage", stage[:-3]),), replace=True,
            )
        reg.register_gauge("proxy.commit_inflight_depth",
                           lambda: len(self._commit_inflight),
                           labels=lbl, replace=True)
        reg.register_gauge("proxy.batch_interval_seconds",
                           lambda: round(self._batch_interval.value, 6),
                           labels=lbl, replace=True)

    @property
    def txns_committed(self) -> int:
        return self._c_committed.total

    @property
    def txns_conflicted(self) -> int:
        return self._c_conflicted.total

    @property
    def txns_too_old(self) -> int:
        return self._c_too_old.total

    def start(self) -> None:
        self._tasks.add(spawn(
            batcher(
                self.commit_stream,
                self._on_commit_batch,
                interval=lambda: self._batch_interval.value,
                max_count=SERVER_KNOBS.COMMIT_TRANSACTION_BATCH_COUNT_MAX,
                max_bytes=SERVER_KNOBS.COMMIT_BATCH_BYTES_TARGET,
                bytes_of=commit_request_bytes,
                with_info=True,
            ),
            TaskPriority.PROXY_COMMIT, name="commitBatcher",
        ))
        self._tasks.add(spawn(
            batcher(
                self.grv_stream,
                lambda b: self._tasks.add(spawn(
                    self._answer_grv_batch(b), TaskPriority.GRV,
                    name="grvBatch",
                )),
                interval=CLIENT_KNOBS.GRV_BATCH_INTERVAL,
                max_count=CLIENT_KNOBS.MAX_BATCH_SIZE,
                priority=TaskPriority.GRV,
            ),
            TaskPriority.GRV, name="grvBatcher",
        ))
        if self.shard_map is not None:
            from ..core.actors import serve_requests

            self._tasks.add(serve_requests(
                self.location_stream, self._serve_locations,
                TaskPriority.DEFAULT, "proxyLocations",
            ))
        self.stats.start_logging(5.0)

    def stop(self) -> None:
        self.stats.stop_logging()
        self._tasks.cancel_all()

    def _on_commit_batch(self, batch, info) -> None:
        """Batch closed: feed the adaptive-interval controller, record the
        formation stage, spawn the per-batch pipeline actor."""
        self._batch_interval.record_close(info.closed_by, len(batch),
                                          info.bytes)
        self.commit_stage_samples["form_ms"].add_sample(info.open_s * 1e3)
        self._tasks.add(spawn(
            self._commit_batch(batch), TaskPriority.PROXY_COMMIT,
            name="commitBatch",
        ))

    def commit_pipeline_status(self) -> dict:
        """The commit plane's observability block (`status json` proxy
        roles, both tiers — the commit-side mirror of PR 7's resolver
        pipeline block): configured/live/measured in-flight depth plus
        per-stage grv/form/resolve/tlog p50+p99."""
        from ..core.stats import stage_percentiles

        return {
            "depth_configured": SERVER_KNOBS.PROXY_PIPELINE_DEPTH,
            "in_flight": len(self._commit_inflight),
            "max_in_flight_measured": self.max_commit_inflight,
            "stages": stage_percentiles(self.commit_stage_samples),
            "latency_bands": {
                k: b.status() for k, b in self.latency_bands.items()
            },
            "batch_interval_ms": round(self._batch_interval.value * 1e3, 3),
            "grv_cache": {
                "staleness_ms": SERVER_KNOBS.GRV_CACHE_STALENESS_MS,
                "served_cached": self._c_grv_cached.total,
                "served_confirmed": self._c_grv.total
                - self._c_grv_cached.total,
            },
        }

    # -- GRV --
    async def _confirm_epoch_live(self) -> None:
        """Every GRV batch confirms this generation's log quorum is still
        live BEFORE answering (ref: MasterProxyServer.actor.cpp:875-889 ->
        TagPartitionedLogSystem.actor.cpp:553). Without it, a partitioned
        old-generation proxy/master pair could keep serving read versions
        that predate commits the NEW generation already made — stale
        reads, exactly when strict serializability matters most."""
        from .interfaces import ConfirmEpochLiveRequest

        if self.log_system is not None:
            await self.log_system.confirm_epoch_live(self.generation)
        elif self.tlog_endpoint is not None:
            await self._call_endpoint(
                self.tlog_endpoint, ConfirmEpochLiveRequest(self.generation)
            )
        else:
            self.tlog.confirm_epoch(self.generation)

    async def _answer_grv_batch(self, reqs: list[GetReadVersionRequest]) -> None:
        if getattr(self, "_epoch_dead", False):
            return  # deposed: clients time out and retry onto the successor
        loop = current_loop()
        t0 = loop.now()
        # Admission control: when the ratekeeper's budget is exhausted the
        # batch is deferred, not denied — GRVs simply start later, which is
        # exactly how the reference's transactionStarter applies the rate
        # (MasterProxyServer.actor.cpp:85-150). SYSTEM_IMMEDIATE requests
        # bypass the budget entirely (recovery/management traffic must not
        # be throttled by the very overload it is fixing); BATCH priority
        # yields first when the budget runs short.
        hi = GetReadVersionRequest.PRIORITY_IMMEDIATE
        immediate = [r for r in reqs if getattr(r, "priority", 1) >= hi]
        reqs = [r for r in reqs if getattr(r, "priority", 1) < hi]
        reqs.sort(key=lambda r: -getattr(r, "priority", 1))  # batch last
        rk = self.ratekeeper
        if rk is not None and reqs:
            admitted = rk.admit_transactions(len(reqs))
            if admitted < len(reqs):
                deferred = reqs[admitted:]
                reqs = reqs[:admitted]
                # GRVsThrottled counts REQUESTS, once each: a request
                # deferred across several refill windows is one throttled
                # GRV, not one per deferral.
                newly = [r for r in deferred
                         if not getattr(r, "_grv_throttled", False)]
                for r in newly:
                    r._grv_throttled = True
                self._c_grv_throttled.add(len(newly))
                TraceEvent("ProxyGRVThrottled").detail(
                    "Count", len(deferred)
                ).log()

                async def requeue():
                    await current_loop().delay(0.05)
                    # FIFO: deferred requests rejoin the FRONT of the
                    # stream in arrival order — requests that arrived
                    # during the throttle wait must not overtake them.
                    for r in reversed(deferred):
                        if not r.reply.is_set():
                            self.grv_stream.unpop(r)

                self._tasks.add(
                    spawn(requeue(), TaskPriority.GRV, name="grvThrottle")
                )
        reqs = immediate + reqs
        if not reqs:
            return
        # Read the version FIRST, then confirm the epoch: the confirmation
        # postdating the read guarantees no newer generation had committed
        # anything when this version was current (reference order,
        # MasterProxyServer.actor.cpp:875-889).
        if buggify("proxy_grv_delay"):
            # GRVs answered late: snapshots age before first use, widening
            # the conflict window clients actually experience.
            await current_loop().delay(0.05 * current_loop().random.random01())
        v = self.master.get_live_committed_version()
        # GRV fast path: within the staleness bound of the last successful
        # confirm, the quorum-liveness probe is amortized — the version
        # still comes from the live committed cache, only the re-confirm
        # is elided, so a served version can never exceed what this
        # generation committed.
        staleness = SERVER_KNOBS.GRV_CACHE_STALENESS_MS / 1e3
        cached = (
            staleness > 0.0
            and self._grv_confirmed_at is not None
            and loop.now() - self._grv_confirmed_at <= staleness
        )
        if cached:
            self._c_grv_cached.add(len(reqs))
        else:
            try:
                await self._confirm_epoch_live()
            except TLogStopped as e:
                # PROVEN deposed (a log is fenced by a newer generation):
                # latch dead. Answering would risk a stale read; clients
                # time out, retry, and land on the successor via discovery.
                self._epoch_dead = True
                TraceEvent("ProxyEpochDead", severity=30).detail(
                    "Generation", self.generation
                ).error(e).log()
                return
            except BaseException as e:
                from ..core.errors import ActorCancelled

                if isinstance(e, ActorCancelled):
                    raise
                # Liveness UNPROVEN (e.g. one lost control RPC on a lossy
                # link): drop this batch only — the next batch re-confirms,
                # exactly the reference's per-batch stall-and-retry. No
                # latch: a transient timeout must not permanently kill GRV
                # service on a live generation.
                TraceEvent("ProxyGRVEpochUnconfirmed", severity=20).detail(
                    "Generation", self.generation
                ).error(e).log()
                return
            self._grv_confirmed_at = loop.now()
        if getattr(self, "_epoch_dead", False):
            # Re-check the latch: a CONCURRENT batch can prove this
            # generation deposed (TLogStopped -> _epoch_dead) while this
            # one was parked in the buggify delay or its own confirm
            # round-trip raced the fencing. The version at `v` was read
            # before that proof — answering with it now would hand out a
            # possibly-stale snapshot the entry check can no longer catch.
            return
        TraceEvent("ProxyGRV").detail("Version", v).detail(
            "Count", len(reqs)
        ).log()
        answered = 0
        for r in reqs:
            if not r.reply.is_set():
                self._c_grv.add(1)
                r.reply.send(v)
                answered += 1
                # Flight recorder: a sampled transaction's GRV landed —
                # the first hop of its stitched timeline.
                trace_txn_event("GRV.Reply", getattr(r, "debug_id", None),
                                Version=v, Cached=cached)
        grv_s = loop.now() - t0
        self.commit_stage_samples["grv_ms"].add_sample(grv_s * 1e3)
        if answered:
            # Exemplar: a sampled request's debug ID rides the band it
            # landed in, so `cli.py top` can jump from a hot GRV band
            # straight to `cli.py trace <id>`.
            dbg = next((r.debug_id for r in reqs
                        if getattr(r, "debug_id", None)), None)
            self.latency_bands["grv"].add(grv_s, n=answered, exemplar=dbg)

    # -- commit pipeline --
    async def _commit_batch(self, reqs: list[CommitTransactionRequest]):
        # Depth gate (the commit-plane twin of the resolver's in-flight
        # bound): a batch draws its version window only when fewer than
        # PROXY_PIPELINE_DEPTH older windows still await replies. Parking
        # BEFORE the window take keeps version order == dispatch order and
        # bounds the proxy-side backlog; older windows' replies never need
        # this coroutine, so the wait cannot deadlock the chain. The
        # while re-checks because several parked batches can wake on one
        # reply and must not overshoot the bound together.
        depth = max(1, SERVER_KNOBS.PROXY_PIPELINE_DEPTH)
        while len(self._commit_inflight) >= depth:
            target = self._commit_inflight[len(self._commit_inflight) - depth]
            await self._replied.when_at_least(target)
        # Phase 1: version window (master is the version authority). Taken
        # OUTSIDE the try so the failure path can still drive this window
        # through the tlog chain.
        prev_version, version = self.master.get_commit_version()
        self._commit_inflight.append(version)
        self.max_commit_inflight = max(
            self.max_commit_inflight, len(self._commit_inflight)
        )
        t_start = current_loop().now()
        try:
            await self._commit_batch_impl(reqs, prev_version, version)
            batch_s = current_loop().now() - t_start
            self._batch_interval.record_latency(batch_s)
            # Band every answered commit at the batch's pipeline latency
            # (window take -> replies released) — the per-request shape
            # operators' latency_bands dashboards expect. A sampled txn's
            # debug ID rides as the band's exemplar (band -> trace <id>).
            dbg = next((r.debug_id for r in reqs
                        if getattr(r, "debug_id", None)), None)
            self.latency_bands["commit"].add(batch_s, n=len(reqs),
                                             exemplar=dbg)
        except GeneratorExit:
            # Interpreter GC of a parked coroutine (a dead generation's
            # batch collected during a LATER simulation run): not a
            # commit failure, and logging it would pollute the current
            # run's SevError count across run_spec boundaries.
            raise
        except BaseException as e:
            from ..core.errors import ActorCancelled

            if isinstance(e, ActorCancelled):
                # Generation teardown (proxy.stop cancels the tracked
                # batch actors, incl. ones parked at the depth gate): the
                # whole pipeline dies with the proxy — clients time out
                # and retry onto the successor; no compensation to run.
                raise
            # A wedged batch must never strand its clients or the batches
            # behind it. Nothing in this batch was reported committed, so
            # conservative all-abort semantics stay sound — but BOTH
            # version chains must still advance: the resolver's (done in
            # resolve_batch's own failure path) and the tlog's, via an
            # empty batch for this window (tlog.commit is idempotent per
            # window, so a failure after logging is safe too).
            from ..core.errors import (
                CommitUnknownResult,
                RequestMaybeDelivered,
                TLogFailed,
            )

            # An epoch fence is EXPECTED during recovery, and a lost role
            # RPC or an unreachable log quorum (a dark machine under k-way
            # replication: the push must stall, not shed a copy) is
            # environmental (severity 30); anything else is a real
            # failure (severity 40).
            fenced = isinstance(e, TLogStopped)
            lost_rpc = isinstance(e, (RequestMaybeDelivered, TLogFailed))
            TraceEvent("ProxyCommitBatchError",
                       severity=30 if (fenced or lost_rpc) else 40
                       ).error(e).log()
            if fenced:
                # Some log holds a newer lock (possibly a PARTIAL lock
                # from a recovery attempt that then lost a log host): this
                # generation can never commit again. Latch dead so the
                # health probe reports unhealthy and the controller keeps
                # recovering — without the latch, the compensation path
                # masks the fence as commit_unknown_result and a
                # half-locked cluster wedges forever (found by the
                # 2-log-host SIGKILL test).
                self._epoch_dead = True
            try:
                for role in (self.resolvers or [self.resolver]):
                    await role.skip_window(prev_version, version)
                await self._tlog_commit(prev_version, version, [])
                self.master.report_committed(version)
            except TLogStopped:
                # The tlog is locked by a newer generation: this proxy is
                # dead and recovery owns the chains now. Any OTHER failure
                # propagates loudly (a wedged chain must never be silent —
                # and the controller's commit-path health probe detects it).
                self._epoch_dead = True
            # Error mapping for clients: an epoch-locked tlog refusal
            # definitively did NOT commit (retryable not_committed, the
            # retry lands on the new generation); a lost role RPC is
            # genuinely ambiguous — the detached request may still land
            # after the compensation, in which case the tlog's sole-
            # appender-per-window rule keeps exactly one outcome — so
            # clients get commit_unknown_result and their dedup-pattern
            # retries stay correct. Everything else is a hard failure.
            if fenced:
                err = NotCommitted("transaction system recovered")
            elif lost_rpc:
                err = CommitUnknownResult(str(e))
            else:
                err = OperationFailed(str(e))
            # Failure replies honor the reply chain too: clients observe
            # every window's outcome in commit-version order, and the
            # chain ALWAYS advances so successor windows never wedge
            # behind a failed one.
            await self._replied.when_at_least(prev_version)
            for r in reqs:
                if not r.reply.is_set():
                    r.reply.send_error(err)
            self._advance_replied(version)

    def _advance_replied(self, version: int) -> None:
        """Release the reply chain past `version` and retire its in-flight
        window (called with the chain at the window's prev_version — every
        reply path gates on when_at_least(prev_version) first)."""
        if self._commit_inflight and self._commit_inflight[0] == version:
            self._commit_inflight.popleft()
        if self._replied.get() < version:
            self._replied.set(version)

    def _wire_on(self) -> bool:
        return bool(SERVER_KNOBS.RESOLVER_WIRE_BATCH)

    def _encode_wire(self, txns, reqs=None):
        """Columnar wire bytes of a resolve batch (resolver/wire.py),
        knob-gated. Built proxy-side — many proxies columnarize
        concurrently, ONE resolver packs, so this moves the per-object
        walk off the serialized resolve path. Sampled transactions' debug
        IDs ride the batch's sparse per-row debug column."""
        if not self._wire_on():
            return None
        from ..resolver.wire import WireBatch

        dbg = ()
        if reqs is not None:
            dbg = tuple(
                (i, r.debug_id) for i, r in enumerate(reqs)
                if getattr(r, "debug_id", None)
            )
        return WireBatch.from_txns(txns, debug_ids=dbg).to_bytes()

    async def _resolve_multi(self, prev_version, version, txns, reqs,
                             debug_id=None):
        """Fan resolution across the resolver partition and merge (ref:
        ResolutionRequestBuilder clipping per resolver,
        MasterProxyServer.actor.cpp:233-312, + the :431-447 merge — any
        resolver's CONFLICT/TOO_OLD wins)."""
        import numpy as np

        from ..core.actors import all_of
        from ..core.runtime import TaskPriority, spawn as _spawn
        from .resolution import clip_txns

        sys_muts = tuple(
            (idx, m)
            for idx, r in enumerate(reqs)
            for m in r.mutations
            if m.param1.startswith(b"\xff")
        )
        feedback, self._feedback = tuple(self._feedback), []
        batch_reqs = []
        for i, role in enumerate(self.resolvers):
            clipped = clip_txns(
                txns, self.resolver_config.coverage(i, version)
            )
            batch_reqs.append(ResolveTransactionBatchRequest(
                prev_version=prev_version,
                version=version,
                last_receive_version=(
                    self._last_receive if i == 0 else prev_version
                ),
                transactions=clipped,
                # clip_txns is positional 1:1 with reqs, so the wire
                # batch's sparse debug column keeps its row indices.
                wire=self._encode_wire(clipped, reqs),
                system_mutations=sys_muts if i == 0 else (),
                committed_feedback=feedback if i == 0 else (),
                epoch=self.generation,
                debug_id=debug_id,
            ))
        async def _one_resolver(role, br):
            if buggify("proxy_resolver_fanout_skew"):
                # Fan-out requests reach resolvers in scrambled order; the
                # per-resolver (prevVersion -> version) chain must still
                # serialize windows correctly.
                await current_loop().delay(
                    0.02 * current_loop().random.random01()
                )
            return await role.resolve_batch(br)

        tasks = [
            _spawn(_one_resolver(role, br), TaskPriority.RESOLVER,
                   name=f"resolve{i}")
            for i, (role, br) in enumerate(zip(self.resolvers, batch_reqs))
        ]
        results = await all_of([t.done for t in tasks])
        merged = np.zeros(len(txns), dtype=np.int64)
        for res in results:
            merged = np.maximum(merged, np.asarray(res.statuses))
        from ..resolver.types import ConflictBatchResult

        out = ConflictBatchResult([int(s) for s in merged])
        # Catch-up state from resolver 0 (windows other proxies committed)
        # is applied by the caller BEFORE this window's own metadata.
        out.state_mutations = getattr(results[0], "state_mutations", ())
        self._last_receive = prev_version
        if sys_muts:
            committed = tuple(
                idx for idx, s in enumerate(merged) if s == COMMITTED
            )
            self._feedback.append((version, committed))
        return out

    async def _call_endpoint(self, endpoint, req):
        """One role-to-role RPC with a deadline: a reply that never comes
        (dropped message over a failed link) must fail the batch as
        maybe-committed rather than wedge the pipeline forever — the
        FailureMonitor-shaped contract of the reference's loadBalance."""
        from ..core.actors import timeout
        from ..core.errors import RequestMaybeDelivered

        endpoint.send(req)
        lost = object()
        result = await timeout(
            req.reply.future, SERVER_KNOBS.ROLE_RPC_TIMEOUT, lost
        )
        if result is lost:
            raise RequestMaybeDelivered(
                f"{type(req).__name__} reply not received"
            )
        return result

    async def _serve_locations(self, req):
        """(ref: getKeyServersLocations answered from keyServers cache)."""
        from ..kv.keys import KeyRange

        slices = self.shard_map.intersecting(KeyRange(req.begin, req.end))
        if getattr(req, "reverse", False):
            return slices[-req.limit:]
        return slices[: req.limit]

    def _tag_mutations(self, mutations):
        from ..kv.atomic import MutationType
        from ..kv.keys import KeyRange
        from .log_system import TaggedMutation

        out = []
        for m in mutations:
            if m.type == MutationType.CLEAR_RANGE:
                tags = self.shard_map.tags_for_range(
                    KeyRange(m.param1, m.param2)
                )
            else:
                tags = self.shard_map.team_for_key(m.param1)
            # Extra subscriber tags (DR/backup log shipping): every
            # mutation also reaches these cursors (ref: backup workers
            # pulling dedicated tags; the v6.0 mechanism writes \xff/blog
            # via the proxy — tag subscription is the same architecture
            # on the tag-partitioned log).
            out.append(TaggedMutation(tuple(tags) + tuple(self.dr_tags), m))
        return out

    async def _tlog_commit(self, prev_version, version, mutations,
                           debug_id=None):
        if self.log_system is not None:
            await self.log_system.push(
                prev_version, version, self._tag_mutations(mutations),
                epoch=self.generation, debug_id=debug_id,
            )
            return
        if self.tlog_endpoint is not None:
            req = TLogCommitRequest(prev_version, version, tuple(mutations),
                                    epoch=self.generation,
                                    debug_id=debug_id)
            await self._call_endpoint(self.tlog_endpoint, req)
        else:
            await self.tlog.commit(prev_version, version, mutations,
                                   epoch=self.generation,
                                   debug_id=debug_id)

    async def _commit_batch_impl(
        self, reqs: list[CommitTransactionRequest], prev_version: int,
        version: int,
    ):
        loop = current_loop()
        TraceEvent("ProxyCommitBatch").detail("Version", version).detail(
            "Txns", len(reqs)
        ).log()

        # Flight recorder: a batch holding sampled transactions draws its
        # own debug ID (ref: commitBatch's nondeterministic debugID +
        # g_traceBatch.addAttach("CommitAttachID", ...)); each sampled
        # txn's ID attaches to it, and the BATCH ID rides every downstream
        # hop — one client ID reconstructs the whole cross-process,
        # cross-batch timeline.
        batch_dbg = None
        sampled = [r.debug_id for r in reqs
                   if getattr(r, "debug_id", None)]
        if sampled:
            batch_dbg = new_debug_id()
            trace_txn_event("Commit.BatchFormed", batch_dbg,
                            Version=version, PrevVersion=prev_version,
                            Txns=len(reqs), Sampled=len(sampled))
            for did in sampled:
                trace_txn_attach(did, batch_dbg, Version=version)

        # Versionstamp substitution: the version is known as of phase 1,
        # so SET_VERSIONSTAMPED_* become plain sets BEFORE resolution —
        # conflict ranges, tags, and the log all see final keys (ref: the
        # proxy's transformation, commitBatch phase 3; batch index is the
        # txn's position, MasterProxyInterface.h CommitID.batchIndex).
        from ..kv.atomic import (
            MutationType,
            pack_versionstamp,
            transform_versionstamp_mutation,
        )

        stamps = []
        for idx, r in enumerate(reqs):
            stamp = pack_versionstamp(version, idx)
            stamps.append(stamp)
            if any(m.type in (MutationType.SET_VERSIONSTAMPED_KEY,
                              MutationType.SET_VERSIONSTAMPED_VALUE)
                   for m in r.mutations):
                try:
                    r.mutations = tuple(
                        transform_versionstamp_mutation(m, stamp)
                        for m in r.mutations
                    )
                except ValueError as e:
                    # A malformed stamp offset fails ITS transaction, not
                    # the shared batch (clients validate; this is the
                    # server-side backstop against hostile payloads).
                    if not r.reply.is_set():
                        r.reply.send_error(OperationFailed(str(e)))
                    r.mutations = ()
                    r.read_conflict_ranges = ()
                    r.write_conflict_ranges = ()

        # Phase 2: resolution.
        t_resolve = loop.now()
        txns = [
            TxnConflictInfo(
                read_snapshot=r.read_snapshot,
                read_ranges=tuple(r.read_conflict_ranges),
                write_ranges=tuple(r.write_conflict_ranges)
                + tuple(mutation_write_ranges(m) for m in r.mutations),
            )
            for r in reqs
        ]
        if self.resolvers is not None:
            result = await self._resolve_multi(
                prev_version, version, txns, reqs, debug_id=batch_dbg
            )
        elif self.resolver_endpoint is not None:
            # Cross-process hop: ship ONLY the columnar wire form — the
            # resolver-side pack is then the vectorized encoder and the
            # RPC never serializes per-range txn objects.
            resolve_req = ResolveTransactionBatchRequest(
                prev_version=prev_version,
                version=version,
                last_receive_version=prev_version,
                transactions=[] if self._wire_on() else txns,
                wire=self._encode_wire(txns, reqs),
                epoch=self.generation,
                debug_id=batch_dbg,
            )
            result = await self._call_endpoint(
                self.resolver_endpoint, resolve_req
            )
        else:
            resolve_req = ResolveTransactionBatchRequest(
                prev_version=prev_version,
                version=version,
                last_receive_version=prev_version,
                transactions=txns,
                wire=self._encode_wire(txns, reqs),
                epoch=self.generation,
                debug_id=batch_dbg,
            )
            result = await self.resolver.resolve_batch(resolve_req)

        self.commit_stage_samples["resolve_ms"].add_sample(
            (loop.now() - t_resolve) * 1e3
        )

        # Phase 3: merge verdicts, build the log payload; interpret
        # committed system-keyspace mutations (ApplyMetadataMutation).
        # Applied PRE-push like the reference's proxy-side
        # applyMetadataMutations: later batches' routing must see the new
        # config immediately. The fenced-commit hazard (a TLogStopped push
        # leaves never-durable effects in the caches) is handled the way
        # the reference handles it — a fence always coincides with a
        # recovery, and recovery re-derives the caches from durable state
        # (RecoverableShardedCluster._rebuild_metadata_caches, the
        # txnStateStore-rebuild analogue).
        mutations = []
        if self.metadata_hook is not None:
            # Other proxies' committed \xff effects first (resolver-0
            # catch-up state), in version order, then this window's own.
            for v, ms in getattr(result, "state_mutations", ()):
                for m in ms:
                    self.metadata_hook(m, v)
        for r, status in zip(reqs, result.statuses):
            if status == COMMITTED:
                mutations.extend(r.mutations)
                if self.metadata_hook is not None:
                    for m in r.mutations:
                        if m.param1.startswith(b"\xff"):
                            self.metadata_hook(m, version)
        if buggify("proxy_commit_delay"):
            await loop.delay(0.05 * loop.random.random01())

        # Phase 4: make the batch durable in version order.
        t_tlog = loop.now()
        await self._tlog_commit(prev_version, version, mutations,
                                debug_id=batch_dbg)
        self.commit_stage_samples["tlog_ms"].add_sample(
            (loop.now() - t_tlog) * 1e3
        )
        # Flight recorder: the FULL fsync quorum acked this window (the
        # push/commit above resolves only on quorum durability).
        trace_txn_event("TLog.QuorumAck", batch_dbg, Version=version)

        # Phase 5: advance committed version, answer clients — in
        # commit-version order (the _replied chain): with up to
        # PROXY_PIPELINE_DEPTH windows in flight, a younger window whose
        # tlog push finished first must still reply after its elders, so
        # clients observe exactly the serial plane's reply semantics.
        self.master.report_committed(version)
        await self._replied.when_at_least(prev_version)
        for idx, (r, status) in enumerate(zip(reqs, result.statuses)):
            if r.reply.is_set():
                continue
            if status == COMMITTED:
                self._c_committed.add(1)
                r.reply.send(CommitID(version, stamps[idx]))
            elif status == TOO_OLD:
                self._c_too_old.add(1)
                r.reply.send_error(TransactionTooOld())
            else:
                self._c_conflicted.add(1)
                r.reply.send_error(NotCommitted())
        trace_txn_event("Commit.Reply", batch_dbg, Version=version)
        self._advance_replied(version)
