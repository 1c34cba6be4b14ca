"""ClusterConnection: the client's view of the cluster's endpoints.

Bundles the three endpoints a client needs — GRV, commit, storage reads —
behind retry/timeout semantics faithful to the reference:

- Reads and GRVs are idempotent: on timeout they retry forever with
  backoff (the reference's loadBalance + failure monitoring keep retrying
  replicas, fdbrpc/LoadBalance.actor.h:164).
- Commits are NOT idempotent: a commit whose reply is lost surfaces as
  CommitUnknownResult (retryable at transaction level, with the documented
  maybe-committed ambiguity — fdbclient/NativeAPI.actor.cpp tryCommit's
  broken_promise/request_maybe_delivered handling).

Endpoints are anything with .send(req): the in-process PromiseStream
directly (LocalCluster) or a sim.RemoteStream routing through the
simulated network — same client code either way.
"""

from __future__ import annotations

from typing import Optional

from ..core.actors import timeout
from ..core.errors import CommitUnknownResult
from ..core.knobs import CLIENT_KNOBS
from ..core.runtime import current_loop
from ..cluster.interfaces import (
    CommitTransactionRequest,
    GetRangeRequest,
    GetReadVersionRequest,
    GetValueRequest,
    WatchValueRequest,
)

_LOST = object()


class ClusterConnection:
    def __init__(self, grv_endpoint, commit_endpoint, storage_endpoint):
        self.grv_endpoint = grv_endpoint
        self.commit_endpoint = commit_endpoint
        self.storage_endpoint = storage_endpoint
        # Client-side GRV coalescing (ref: the reference client funnels
        # concurrent getReadVersion calls through one batched request per
        # proxy, NativeAPI readVersionBatcher). A joiner piggybacks on the
        # in-flight request of its priority, but the shared request may
        # have been SERVED at the proxy before the joiner asked (the reply
        # can sit in flight, or in the retry loop's backoff, for a long
        # time under faults) — so the served version can predate a commit
        # this client has since seen acked. `_version_floor` tracks the
        # highest version this connection has causally observed (commit
        # acks and returned read versions); a joiner whose shared result
        # lands below the floor it captured at call time re-fetches fresh
        # instead of accepting a read version that travels back across its
        # own acked writes (external consistency, ref: NativeAPI's
        # getReadVersion ordering vs. commit acknowledgement).
        self._grv_shared: dict = {}  # priority -> Promise
        self._version_floor = 0
        # Client-side GRV/commit counters on the metrics plane (ref: the
        # reference's TransactionMetrics CounterCollection in NativeAPI):
        # what a client process's scrape shows of ITS half of the commit
        # path. One connection per process is the deployed shape; a later
        # connection on the same loop supersedes (replace=True).
        from ..core.metrics import global_registry
        from ..core.stats import Counter

        self.c_grvs = Counter("GRVsIssued")
        self.c_grvs_coalesced = Counter("GRVsCoalesced")
        self.c_grvs_stale_refetch = Counter("GRVsStaleRefetch")
        self.c_commits_started = Counter("CommitsStarted")
        self.c_commits_unknown = Counter("CommitsUnknownResult")
        reg = global_registry()
        reg.register_counter("client.grvs_issued", self.c_grvs,
                             replace=True)
        reg.register_counter("client.grvs_coalesced",
                             self.c_grvs_coalesced, replace=True)
        reg.register_counter("client.grvs_stale_refetch",
                             self.c_grvs_stale_refetch, replace=True)
        reg.register_counter("client.commits_started",
                             self.c_commits_started, replace=True)
        reg.register_counter("client.commits_unknown_result",
                             self.c_commits_unknown, replace=True)

    async def _retrying(self, make_req, endpoint, request_timeout: float):
        """Idempotent request: re-send (a fresh request) on timeout OR
        connection loss, backing off, forever — progress resumes when the
        network heals (ref: the client treating broken_promise from a
        role as a signal to re-resolve and retry, NativeAPI throughout)."""
        from ..core.errors import BrokenPromise, ConnectionFailed

        from ..core.runtime import buggify

        loop = current_loop()
        backoff = CLIENT_KNOBS.DEFAULT_BACKOFF
        while True:
            req = make_req()
            endpoint.send(req)
            try:
                result = await timeout(
                    req.reply.future, request_timeout, _LOST
                )
            except (ConnectionFailed, BrokenPromise):
                result = _LOST
            if result is not _LOST and buggify("client_reply_dropped", 0.1):
                # The reply made it but the client behaves as if it were
                # lost (timer raced the delivery): idempotent requests
                # must tolerate the duplicate re-send.
                result = _LOST
            if result is not _LOST:
                return result
            await loop.delay(backoff * (0.5 + loop.random.random01()))
            backoff = min(
                backoff * CLIENT_KNOBS.BACKOFF_GROWTH_RATE,
                CLIENT_KNOBS.DEFAULT_MAX_BACKOFF,
            )

    def _observe_version(self, version: int) -> None:
        """Raise the causal floor: this connection has now seen `version`
        (a commit ack or a returned read version), so no later read
        version it hands out may be below it."""
        if version > self._version_floor:
            self._version_floor = version

    async def get_read_version(self, priority: int = 1,
                               debug_id=None) -> int:
        # A sampled transaction bypasses client-side coalescing: its GRV
        # must carry ITS debug ID to the proxy (a piggybacked joiner's ID
        # would never reach the wire), and sample rates are low enough
        # that the extra request is noise.
        if not CLIENT_KNOBS.GRV_COALESCE or debug_id is not None:
            v = await self._grv_fetch(priority, debug_id)
            self._observe_version(v)
            return v
        floor = self._version_floor
        shared = self._grv_shared.get(priority)
        if shared is not None and not shared.future.is_set():
            self.c_grvs_coalesced.add(1)
        if shared is None or shared.future.is_set():
            from ..core.runtime import Promise, spawn

            shared = Promise()
            self._grv_shared[priority] = shared

            async def fetch(p=shared, prio=priority):
                try:
                    v = await self._grv_fetch(prio)
                except BaseException as e:
                    if not p.is_set():
                        p.send_error(e)
                    return
                if not p.is_set():
                    p.send(v)

            spawn(fetch(), name="grvCoalesced")
        v = await shared.future
        # The shared request may have been served before a commit this
        # caller already saw acknowledged — accepting it would read back
        # across the caller's own write. Re-fetch fresh: any GRV served
        # after the floor commit's ack returns at least the floor (the
        # acked commit is quorum-durable, so every later committed
        # version — across recoveries too — is >= it).
        while v < floor:
            self.c_grvs_stale_refetch.add(1)
            v = await self._grv_fetch(priority)
        self._observe_version(v)
        return v

    async def _grv_fetch(self, priority: int, debug_id=None) -> int:
        self.c_grvs.add(1)
        return await self._retrying(
            lambda: GetReadVersionRequest(priority=priority,
                                          debug_id=debug_id),
            self.grv_endpoint, CLIENT_KNOBS.GRV_TIMEOUT,
        )

    async def get_value(self, key: bytes, version: int):
        return await self._retrying(
            lambda: GetValueRequest(key, version), self.storage_endpoint,
            CLIENT_KNOBS.READ_TIMEOUT,
        )

    async def get_range(self, begin, end, version, limit=0, reverse=False):
        return await self._retrying(
            lambda: GetRangeRequest(begin, end, version, limit, reverse),
            self.storage_endpoint, CLIENT_KNOBS.READ_TIMEOUT,
        )

    def watch(self, req: WatchValueRequest):
        """Watches are long-lived: no client-side timeout; a lost watch
        surfaces when the owning caller re-reads (the reference's watches
        are similarly best-effort with client re-registration)."""
        self.storage_endpoint.send(req)
        return req.reply.future

    async def commit(self, req: CommitTransactionRequest):
        from ..core.errors import BrokenPromise, ConnectionFailed

        self.c_commits_started.add(1)
        self.commit_endpoint.send(req)
        try:
            result = await timeout(
                req.reply.future, CLIENT_KNOBS.COMMIT_TIMEOUT, _LOST
            )
        except (ConnectionFailed, BrokenPromise) as e:
            # The connection died with the commit in flight: ambiguous
            # (the proxy may have pushed the batch before the link broke).
            self.c_commits_unknown.add(1)
            raise CommitUnknownResult(str(e))
        if result is _LOST:
            # The batch may or may not have committed — the defining OCC
            # client ambiguity (ref: commit_unknown_result).
            self.c_commits_unknown.add(1)
            raise CommitUnknownResult()
        self._observe_version(result.version)
        return result


class ShardedConnection(ClusterConnection):
    """Client view of a sharded, replicated cluster: reads are routed by a
    location cache and load-balanced across each shard's replica team
    (ref: getKeyLocation, fdbclient/NativeAPI.actor.cpp:1059 + loadBalance
    per-shard reads :1146,1367; cache invalidation on wrong_shard_server
    :1176-1180).

    `storage_endpoints` maps storage tag -> read endpoint;
    `location_endpoint` answers GetKeyServerLocationsRequest from the
    proxy's shard map.
    """

    def __init__(self, grv_endpoint, commit_endpoint, location_endpoint,
                 storage_endpoints: dict, failure_monitor=None,
                 failure_names: Optional[dict] = None,
                 commit_batch_endpoint=None):
        super().__init__(grv_endpoint, commit_endpoint,
                         storage_endpoint=None)
        self.location_endpoint = location_endpoint
        # Commit wire batching (cluster/commit_wire.py): when the server
        # publishes a batch endpoint (multiprocess txn host) and
        # CLIENT_KNOBS.COMMIT_WIRE_BATCH is on, concurrent commits from
        # this process coalesce into ONE columnar buffer per flush window
        # instead of N pickled request objects.
        self.commit_batch_endpoint = commit_batch_endpoint
        self._commit_coalesce: Optional[list] = None
        self._commit_flush_armed = False
        # Kept by REFERENCE: discovery (monitor_leader) updates the same
        # mapping in place when a recovery republishes endpoints.
        self.storage_endpoints = storage_endpoints
        self.failure_monitor = failure_monitor
        self.failure_names = failure_names or {}
        from ..kv.keyrange_map import KeyRangeMap

        self._locations = KeyRangeMap(None)  # key -> (end, team) | None
        from .load_balance import QueueModel

        self.queue_model = QueueModel()

    # -- commit wire batching (cluster/commit_wire.py) --
    async def commit(self, req: CommitTransactionRequest):
        if (self.commit_batch_endpoint is None
                or not CLIENT_KNOBS.COMMIT_WIRE_BATCH):
            return await super().commit(req)
        from ..core.errors import BrokenPromise, ConnectionFailed
        from ..core.runtime import spawn

        self.c_commits_started.add(1)
        if self._commit_coalesce is None:
            self._commit_coalesce = []
        self._commit_coalesce.append(req)
        if (len(self._commit_coalesce)
                >= CLIENT_KNOBS.COMMIT_WIRE_BATCH_COUNT_MAX):
            self._flush_commits()
        elif not self._commit_flush_armed:
            self._commit_flush_armed = True
            spawn(self._commit_flush_timer(), name="commitFlushTimer")
        # Same outcome semantics as the direct path: a lost reply is the
        # defining maybe-committed ambiguity; server-reported outcomes
        # (conflict, too_old, ...) surface as the same exceptions.
        try:
            result = await timeout(
                req.reply.future, CLIENT_KNOBS.COMMIT_TIMEOUT, _LOST
            )
        except (ConnectionFailed, BrokenPromise) as e:
            self.c_commits_unknown.add(1)
            raise CommitUnknownResult(str(e))
        if result is _LOST:
            self.c_commits_unknown.add(1)
            raise CommitUnknownResult()
        self._observe_version(result.version)
        return result

    def _flush_commits(self) -> None:
        reqs, self._commit_coalesce = self._commit_coalesce, []
        if not reqs:
            return
        from ..core.runtime import spawn

        spawn(self._ship_commit_batch(reqs), name="commitWireBatch")

    async def _commit_flush_timer(self):
        try:
            await current_loop().delay(
                CLIENT_KNOBS.COMMIT_WIRE_BATCH_INTERVAL
            )
        finally:
            self._commit_flush_armed = False
        self._flush_commits()

    async def _ship_commit_batch(self, reqs) -> None:
        """One columnar buffer for the whole flush window; per-txn
        outcomes fan back onto each request's reply promise."""
        from ..cluster.commit_wire import (
            OUTCOME_COMMITTED,
            OUTCOME_CONFLICT,
            OUTCOME_MAYBE_COMMITTED,
            OUTCOME_TOO_OLD,
            CommitBatchRequest,
            CommitWireBatch,
            unpack_outcomes,
        )
        from ..cluster.interfaces import CommitID
        from ..core.errors import (
            BrokenPromise,
            ConnectionFailed,
            NotCommitted,
            OperationFailed,
            TransactionTooOld,
        )

        breq = CommitBatchRequest(CommitWireBatch.from_reqs(reqs).to_bytes())
        self.commit_batch_endpoint.send(breq)
        try:
            outs = await timeout(
                breq.reply.future, CLIENT_KNOBS.COMMIT_TIMEOUT, _LOST
            )
        except (ConnectionFailed, BrokenPromise):
            outs = _LOST
        if outs is not _LOST:
            outs = unpack_outcomes(outs)
        if outs is _LOST or len(outs) != len(reqs):
            err = CommitUnknownResult("commit batch reply not received")
            for r in reqs:
                if not r.reply.is_set():
                    r.reply.send_error(err)
            return
        for r, (code, version, stamp, msg) in zip(reqs, outs):
            if r.reply.is_set():
                continue
            if code == OUTCOME_COMMITTED:
                r.reply.send(CommitID(version, stamp))
            elif code == OUTCOME_CONFLICT:
                r.reply.send_error(NotCommitted(msg))
            elif code == OUTCOME_TOO_OLD:
                r.reply.send_error(TransactionTooOld(msg))
            elif code == OUTCOME_MAYBE_COMMITTED:
                r.reply.send_error(CommitUnknownResult(msg))
            else:
                r.reply.send_error(OperationFailed(msg))

    # -- location cache (ref: getKeyLocation/locationCache) --
    async def _locate(self, key: bytes) -> tuple[bytes, tuple]:
        """(shard_end, team) for the shard containing `key`."""
        hit = self._locations[key]
        if hit is not None:
            return hit
        from ..cluster.shards import GetKeyServerLocationsRequest
        from ..kv.keys import KeyRange, key_after

        slices = await self._retrying(
            lambda: GetKeyServerLocationsRequest(key, key_after(key)),
            self.location_endpoint, CLIENT_KNOBS.READ_TIMEOUT,
        )
        for b, e, team in slices:
            self._locations.insert(KeyRange(b, e), (e, tuple(team)))
        hit = self._locations[key]
        if hit is None:
            from ..core.errors import OperationFailed

            raise OperationFailed(f"no shard location for {key!r}")
        return hit

    def _invalidate(self, key: bytes) -> None:
        """(ref: invalidateCache on wrong_shard_server)."""
        from ..kv.keys import KeyRange, key_after

        hit = self._locations[key]
        end = hit[0] if hit else key_after(key)
        self._locations.insert(
            KeyRange(key, max(end, key_after(key))), None
        )

    def _alternatives(self, team: tuple):
        return [(t, self.storage_endpoints[t]) for t in team
                if t in self.storage_endpoints]

    async def _shard_read(self, key_for_routing: bytes, make_req):
        """One load-balanced read against key_for_routing's team, with
        location-cache invalidation + retry on wrong_shard_server."""
        from ..core.errors import WrongShardServer
        from .load_balance import load_balance

        while True:
            _, team = await self._locate(key_for_routing)
            try:
                return await load_balance(
                    self.queue_model, self._alternatives(team), make_req,
                    self.failure_monitor, self.failure_names,
                )
            except WrongShardServer:
                self._invalidate(key_for_routing)

    async def get_value(self, key: bytes, version: int):
        return await self._shard_read(
            key, lambda: GetValueRequest(key, version)
        )

    async def _read_slice(self, cursor: bytes, end: bytes, version, limit,
                          reverse):
        """One shard-sized sub-read, RE-LOCATING on every attempt: a shard
        boundary that moves mid-read must shrink the request to the new
        shard, not livelock on a frozen range (ref: getExactRange's
        re-resolution after wrong_shard_server, NativeAPI.actor.cpp:1445).
        Returns (rows, sub_end_used)."""
        from ..core.errors import WrongShardServer
        from .load_balance import load_balance

        while True:
            shard_end, team = await self._locate(cursor)
            sub_end = min(shard_end, end)
            try:
                rows = await load_balance(
                    self.queue_model, self._alternatives(team),
                    lambda c=cursor, se=sub_end: GetRangeRequest(
                        c, se, version, limit, reverse,
                    ),
                    self.failure_monitor, self.failure_names,
                )
                return rows, sub_end
            except WrongShardServer:
                self._invalidate(cursor)

    async def get_range(self, begin, end, version, limit=0, reverse=False):
        """Iterates shard slices, reading each from its own team (ref:
        getExactRange's per-shard loop, NativeAPI.actor.cpp:1367)."""
        out = []
        remaining = limit if limit else 0
        if not reverse:
            cursor = begin
            while cursor < end:
                rows, sub_end = await self._read_slice(
                    cursor, end, version, remaining, False
                )
                out.extend(rows)
                if limit:
                    remaining -= len(rows)
                    if remaining <= 0:
                        return out[:limit]
                cursor = sub_end
            return out
        # Reverse: walk shards top-down, asking for the LAST shard of the
        # remaining range each step — boundaries that move mid-walk are
        # re-resolved, so no slice is skipped or split-blind.
        from ..cluster.shards import GetKeyServerLocationsRequest
        from ..core.errors import WrongShardServer
        from ..kv.keys import KeyRange
        from .load_balance import load_balance

        cur_end = end
        while cur_end > begin:
            slices = await self._retrying(
                lambda: GetKeyServerLocationsRequest(
                    begin, cur_end, limit=1, reverse=True
                ),
                self.location_endpoint, CLIENT_KNOBS.READ_TIMEOUT,
            )
            if not slices:
                break
            b, e, team = slices[-1]
            self._locations.insert(KeyRange(b, e), (e, tuple(team)))
            sub_b = max(b, begin)
            try:
                rows = await load_balance(
                    self.queue_model, self._alternatives(team),
                    lambda sb=sub_b, ce=cur_end: GetRangeRequest(
                        sb, ce, version, remaining, True,
                    ),
                    self.failure_monitor, self.failure_names,
                )
            except WrongShardServer:
                self._invalidate(sub_b)
                continue
            out.extend(rows)
            if limit:
                remaining -= len(rows)
                if remaining <= 0:
                    return out[:limit]
            cur_end = sub_b
        return out

    def watch(self, req: WatchValueRequest):
        """Watches are LONG-LIVED: routed to one healthy team replica with
        no deadline and no hedging (the base-class contract; ref:
        watchValue's single-replica wait, NativeAPI.actor.cpp:1292).
        wrong_shard_server re-locates and re-registers."""

        async def run():
            from ..core.errors import WrongShardServer

            while True:
                _, team = await self._locate(req.key)
                alts = self._alternatives(team)
                if self.failure_monitor is not None and self.failure_names:
                    healthy = [
                        a for a in alts if not self.failure_monitor.is_failed(
                            self.failure_names.get(a[0], "")
                        )
                    ]
                    alts = healthy or alts
                if not alts:
                    from ..core.errors import RequestMaybeDelivered

                    raise RequestMaybeDelivered("no replicas for watch")
                inner = WatchValueRequest(req.key, req.value, req.version)
                alts[0][1].send(inner)
                try:
                    return await inner.reply.future
                except WrongShardServer:
                    self._invalidate(req.key)

        from ..core.runtime import spawn

        task = spawn(run(), name="watch")

        def forward(f):
            if req.reply.is_set():
                return
            if f.is_error():
                req.reply.send_error(f._value)
            else:
                req.reply.send(f._value)

        task.done.add_callback(forward)
        return req.reply.future
