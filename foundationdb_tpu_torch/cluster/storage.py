"""MVCC storage server (ref: fdbserver/storageserver.actor.cpp).

Pulls the mutation stream from the tlog (`update`, :2321 — the ingest
loop), applies it into the VersionedMap window (`applyMutation`, :2232 /
StorageUpdater), answers reads at versions (`getValueQ` :680 with
`waitForVersion` :627), fires watches (`watchValue_impl` :758, triggered at
:1588-1594), and trims the window as durability advances (`updateStorage`
:2536 + `forget_before` ≙ PTree forgetVersionsBefore).
"""

from __future__ import annotations

from typing import Optional

from ..core.actors import NotifiedVersion, PromiseStream
from ..core.errors import TransactionTooOld
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import TaskPriority, buggify, current_loop, spawn
from ..core.trace import TraceEvent
from ..kv.atomic import MutationType, apply_atomic
from ..kv.keys import KeyRange, key_after
from .interfaces import GetRangeRequest, GetValueRequest, Mutation, WatchValueRequest
from .tlog import MemoryTLog


_DURABLE_VERSION_KEY = b"\xff\xff/storage/durableVersion"


class StorageServer:
    def __init__(self, tlog: MemoryTLog, init_version: int = 0,
                 tag: int | None = None, engine=None, device=None):
        self.tlog = tlog
        self.tag = tag  # this server's log tag (None = untagged/solo)
        # MVCC window backend: VersionedMap (host reference) or the
        # device-resident KeyValueStoreGPU on `device` (None: the CUDA
        # card), per SERVER_KNOBS.STORAGE_ENGINE_IMPL
        # (storage_engine/factory.py).
        from ..storage_engine.factory import make_mvcc_window

        self.data = make_mvcc_window(device=device)
        # Read batcher (device window only): concurrent get/get_range
        # requests coalesce into ONE fused device dispatch through the
        # engine's submit_reads/read_verdicts split — see _read_batch_loop.
        self._read_batch_q: list = []
        self._read_batch_wake = PromiseStream()
        self.read_batches = 0
        self.read_batch_peak = 0
        # Durable tier (ref: updateStorage :2536 writing the oldest MVCC
        # versions into the IKeyValueStore + restoreDurableState :2765 on
        # boot). `engine` is any IKeyValueStore-shaped store (memory/ssd);
        # applied mutations are captured in a flush log and written to it
        # up to the log system's QUORUM-durable horizon, which a recovery
        # can never roll back (the recovery version is the quorum minimum
        # and monotone) — so disk state never needs un-writing.
        self.engine = engine
        self.engine_durable = init_version
        self._flush_log: list = []  # (version, "s", key, value)|( , "c", b, e)
        self.version = NotifiedVersion(init_version)  # applied through here
        self.oldest_version = init_version
        self._watches: list[WatchValueRequest] = []
        # Shard ownership: reads outside owned ranges answer
        # wrong_shard_server so clients refresh their location cache (ref:
        # ShardInfo readable check, storageserver.actor.cpp:87-141).
        from ..kv.keyrange_map import KeyRangeMap

        self.owned = KeyRangeMap(True)
        # Assignment: mutations for unassigned ranges are DISCARDED from
        # the stream (ref: ShardInfo notAssigned shards dropping
        # mutations, storageserver.actor.cpp:87-141) — an evicted team
        # member must not resurrect moved data from late union-tagged
        # commits.
        self.assigned = KeyRangeMap(True)
        # Active shard fetches: while a range is being fetched, its stream
        # mutations are BUFFERED and replayed after the snapshot lands
        # (ref: AddingShard's update buffering, storageserver.actor.cpp
        # :77,:1761 — applying an atomic op against a half-fetched base
        # would corrupt the replica).
        self._fetches: list[tuple[KeyRange, list]] = []
        # Bumped by rollback_to: an update batch peeked BEFORE a rollback
        # must not keep applying after it (its entries were truncated).
        self._rollback_epoch = 0
        # Byte-sampled metrics for DD sizing/splitting (ref:
        # StorageMetrics.actor.h; fed from the apply path like
        # byteSampleApplySet, storageserver.actor.cpp:2870).
        from .storage_metrics import StorageServerMetrics

        self.metrics = StorageServerMetrics()
        # Read endpoint (ref: StorageServerInterface.h:31 — getValue,
        # getKeyValues, watchValue request streams served by one role).
        self.read_stream: PromiseStream = PromiseStream()
        # Read latency bands (core/stats.LatencyBands; ref: fdbclient's
        # latency_bands): point + range read service times bucketed into
        # the knob-configured edges, surfaced in the storage role's
        # status block.
        from ..core.stats import LatencyBands

        self.read_bands = LatencyBands()
        self._tasks = []
        if engine is not None:
            self._restore_durable_state()

    def register_metrics(self, registry=None, labels=()) -> None:
        """Register this storage server's gauges + read-latency bands on
        the per-process MetricRegistry (callers pass a `tag` label)."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        lbl = tuple(labels)
        reg.register_gauge("storage.data_version",
                           lambda: self.version.get(),
                           labels=lbl, replace=True)
        reg.register_gauge("storage.keys", lambda: len(self.data),
                           labels=lbl, replace=True)
        reg.register_gauge("storage.stored_bytes",
                           lambda: int(self.metrics.byte_sample.total),
                           labels=lbl, replace=True)
        reg.register_gauge("storage.watches_count",
                           lambda: len(self._watches),
                           labels=lbl, replace=True)
        reg.register_bands("storage.read_ms", self.read_bands,
                           labels=lbl, replace=True)
        if hasattr(self.data, "register_metrics"):
            # per-engine read-path metrics (batch width, probe/gather/d2h
            # stage samples, compaction cadence)
            self.data.register_metrics(reg, labels=lbl)
        reg.register_gauge("storage.read_batches_total",
                           lambda: self.read_batches,
                           labels=lbl, replace=True)
        reg.register_gauge("storage.read_batch_peak_count",
                           lambda: self.read_batch_peak,
                           labels=lbl, replace=True)

    def start(self) -> None:
        from ..core.actors import serve_requests

        self._tasks = [
            spawn(self._update_loop(), TaskPriority.STORAGE,
                  name="storage_update"),
            serve_requests(self.read_stream, self._serve_one,
                           TaskPriority.STORAGE, "storage_serve"),
            # The batcher runs for EVERY engine impl: the engine decides
            # HOW a batch is answered (fused device dispatch vs host
            # oracle loop), never WHEN. Identical awaits on both paths
            # keep the sim schedule — and so every downstream
            # loop.random draw — invariant under STORAGE_ENGINE_IMPL,
            # which is what makes the cross-engine chaos fingerprint
            # differential (and seed-stable engine randomization) hold.
            spawn(self._read_batch_loop(), TaskPriority.STORAGE,
                  name="storage_read_batch"),
        ]
        if self.engine is not None:
            self._tasks.append(
                spawn(self._flush_loop(), TaskPriority.STORAGE,
                      name="storage_flush")
            )

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._tasks = []

    # -- durable tier (ref: updateStorage :2536 / restoreDurableState) --
    def _restore_durable_state(self) -> None:
        """Boot: rebuild the MVCC base from the engine's recovered state at
        its recorded durable version (ref: restoreDurableState :2765)."""
        raw = self.engine.get(_DURABLE_VERSION_KEY)
        if raw is None:
            return
        dv = int(raw)
        n = 0
        for k, v in self.engine.get_range(b"", b"\xff\xff"):
            self.data.set_snapshot(k, v, dv)
            self.metrics.on_set(k, v)
            n += 1
        self.engine_durable = dv
        if dv > self.version.get():
            self.version.set(dv)
        self.oldest_version = max(self.oldest_version, dv)
        TraceEvent("StorageDurableRestored").detail("Tag", self.tag).detail(
            "Version", dv
        ).detail("Rows", n).log()

    def _log_durable_set(self, key: bytes, value: bytes, version: int):
        if self.engine is not None:
            self._flush_log.append((version, "s", key, value))

    def _log_durable_clear(self, begin: bytes, end: bytes, version: int):
        if self.engine is not None:
            self._flush_log.append((version, "c", begin, end))

    def _flush_once(self) -> int:
        """Write every captured effect at versions <= the quorum-durable
        horizon into the engine, fsync, record the new durable version.
        Returns the horizon it reached."""
        horizon = min(self.version.get(), self.tlog.quorum_durable())
        if horizon <= self.engine_durable:
            return self.engine_durable
        # Select by VERSION, not position: the flush log is apply-ordered,
        # and end_fetch appends fetched-snapshot rows at their (older)
        # fence version after newer live-stream entries — a prefix split
        # would advance the durable version past unflushed fetch rows and
        # lose them on restore. The stable sort preserves apply order
        # within a version.
        batch = sorted(
            (e for e in self._flush_log if e[0] <= horizon),
            key=lambda e: e[0],
        )
        self._flush_log = [e for e in self._flush_log if e[0] > horizon]
        for _v, op, a, b in batch:
            if op == "s":
                self.engine.set(a, b)
            else:
                self.engine.clear_range(a, b)
        self.engine.set(_DURABLE_VERSION_KEY, str(horizon).encode())
        self.engine.commit()  # the fsync
        self.engine_durable = horizon
        return horizon

    async def _flush_loop(self):
        loop = current_loop()
        while True:
            await loop.delay(SERVER_KNOBS.STORAGE_COMMIT_INTERVAL)
            if buggify("storage_flush_stall"):
                # A long fsync: the tlog keeps the un-popped prefix and
                # the ratekeeper sees the growing durability lag.
                await loop.delay(0.2 * loop.random.random01())
            before = self.engine_durable
            horizon = self._flush_once()
            if horizon > before:
                self.tlog.pop(horizon)
                TraceEvent("StorageDurable").detail("Tag", self.tag).detail(
                    "Version", horizon
                ).log()

    # -- request serving: each request answered via its reply promise so the
    #    endpoint works identically in-process and across the sim network --
    async def _serve_one(self, req):
        if isinstance(req, (GetValueRequest, GetRangeRequest)):
            t0 = current_loop().now()
            out = await self._batched_read(req)
            self.read_bands.add(current_loop().now() - t0)
            return out
        if isinstance(req, WatchValueRequest):
            # watch_value resolves req.reply itself on change; returning
            # its result is harmless (reply already set). Watches are
            # open-ended waits, not reads — no latency band.
            return await self.watch_value(req)
        raise TypeError(f"unknown storage request {type(req)}")

    # -- ingest (ref: update :2321) --
    async def _update_loop(self):
        loop = current_loop()
        while True:
            entries = await self.tlog.peek(self.version.get())
            epoch = self._rollback_epoch
            for version, mutations in entries:
                if buggify("storage_slow_apply"):
                    await loop.delay(0.05 * loop.random.random01())
                if self._rollback_epoch != epoch:
                    break  # rolled back under us: these entries are gone
                if not self._apply_bulk(mutations, version):
                    for m in mutations:
                        self._apply(m, version)
                self.version.set(version)
                self._trigger_watches(version)
            # Window maintenance: keep MVCC history for the read-life window
            # behind the applied version, then let the log discard.
            new_oldest = max(
                self.oldest_version,
                self.version.get()
                - SERVER_KNOBS.MAX_READ_TRANSACTION_LIFE_VERSIONS,
            )
            if new_oldest > self.oldest_version:
                self.oldest_version = new_oldest
                self.data.forget_before(new_oldest)
            # With an engine, the log may discard only what the ENGINE has
            # made durable (the flush loop pops); without one, applied =
            # done, the memory tier's contract.
            if self.engine is None:
                self.tlog.pop(self.version.get())

    def rollback_to(self, version: int) -> None:
        """Epoch-end rollback: discard applied state above `version` (ref:
        storageServerRollbackRebooter, worker.actor.cpp:346 — the
        reference reboots the role and replays its durable prefix; the
        in-memory node trims its MVCC chains instead)."""
        if self.version.get() <= version:
            return
        self._rollback_epoch += 1
        self.data.rollback_above(version)
        self.version.rollback_to(version)
        # The durable tier flushes only up to the QUORUM durable horizon,
        # which the recovery version can never undercut — so a rollback
        # below engine_durable indicates a broken invariant, not a state
        # this server can repair (the reference reboots + refetches there).
        if self.engine is not None:
            if version < self.engine_durable:  # pragma: no cover
                TraceEvent("StorageRollbackBelowDurable",
                           severity=40).detail("Tag", self.tag).detail(
                    "Version", version
                ).detail("Durable", self.engine_durable).log()
            self._flush_log = [
                e for e in self._flush_log if e[0] <= version
            ]
        TraceEvent("StorageRollback", severity=30).detail(
            "Tag", self.tag
        ).detail("Version", version).log()

    # -- shard fetch buffering (ref: AddingShard, :77) --
    def begin_fetch(self, r: KeyRange) -> None:
        self._fetches.append((r, []))

    def end_fetch(self, r: KeyRange, rows, fence_version: int) -> None:
        """Apply the fetched snapshot, then replay everything the stream
        delivered for the range since begin_fetch, in order."""
        for i, (fr, buffered) in enumerate(self._fetches):
            if fr == r:
                del self._fetches[i]
                break
        else:
            raise ValueError(f"no active fetch for {r!r}")
        for k, v in rows:
            self.data.set_snapshot(k, v, fence_version)
            self._log_durable_set(k, v, fence_version)
            self.metrics.on_set(k, v)
        for version, m in buffered:
            if version > fence_version:
                self._apply(m, version)

    def abort_fetch(self, r: KeyRange) -> None:
        """Abandon an in-progress fetch: drop its buffer (the range was
        never readable here) (ref: AddingShard cancellation)."""
        self._fetches = [
            (fr, buf) for fr, buf in self._fetches if fr != r
        ]

    def _fetch_buffer_for(self, key: bytes):
        for fr, buffered in self._fetches:
            if fr.contains(key):
                return buffered
        return None

    def _apply_bulk(self, mutations, version: int) -> bool:
        """Columnar apply fast path: an all-SET, fully-assigned,
        fetch-free peek entry lands in the device window through ONE
        engine set_bulk call (the whole row set staged for the next
        packed fold — the shape commit_wire.decode_set_columns produces
        from a TaggedMutationBatch without building Mutation objects).
        Returns False when any row needs the per-mutation path."""
        if not mutations or self._fetches \
                or not hasattr(self.data, "set_bulk"):
            return False
        for m in mutations:
            if m.type != MutationType.SET_VALUE \
                    or not self.assigned[m.param1]:
                return False
        self.data.set_bulk([m.param1 for m in mutations],
                           [m.param2 for m in mutations], version)
        for m in mutations:
            self._log_durable_set(m.param1, m.param2, version)
            self.metrics.on_set(m.param1, m.param2)
        return True

    def _apply(self, m: Mutation, version: int) -> None:
        if m.type == MutationType.CLEAR_RANGE:
            # Apply only the assigned slices of the cleared range. Parts
            # under an active fetch buffer — CLIPPED to the fetch range:
            # the assigned map coalesces, so one assigned slice can span
            # both fetching and live data, and the live part must clear
            # NOW (buffering it would serve stale rows until end_fetch).
            for b, e, ok in self.assigned.intersecting(
                KeyRange(m.param1, m.param2)
            ):
                if not ok:
                    continue
                e2 = e if e is not None else m.param2
                segs = [(b, e2)]
                for fr, buffered in self._fetches:
                    nxt = []
                    for sb, se in segs:
                        ib, ie = max(sb, fr.begin), min(se, fr.end)
                        if ib < ie:
                            buffered.append((
                                version,
                                Mutation(MutationType.CLEAR_RANGE, ib, ie),
                            ))
                            if sb < ib:
                                nxt.append((sb, ib))
                            if ie < se:
                                nxt.append((ie, se))
                        else:
                            nxt.append((sb, se))
                    segs = nxt
                for sb, se in segs:
                    self.data.clear_range(sb, se, version)
                    self._log_durable_clear(sb, se, version)
                    self.metrics.on_clear_range(sb, se)
            return
        if not self.assigned[m.param1]:
            return
        buf = self._fetch_buffer_for(m.param1)
        if buf is not None:
            buf.append((version, m))
            return
        if m.type == MutationType.SET_VALUE:
            self.data.set(m.param1, m.param2, version)
            self._log_durable_set(m.param1, m.param2, version)
            self.metrics.on_set(m.param1, m.param2)
        else:
            old = self.data.get(m.param1, version)
            new = apply_atomic(m.type, old, m.param2)
            if new is None:
                self.data.clear(m.param1, version)
                self._log_durable_clear(
                    m.param1, key_after(m.param1), version
                )
                self.metrics.on_clear_key(m.param1)
            else:
                self.data.set(m.param1, new, version)
                self._log_durable_set(m.param1, new, version)
                self.metrics.on_set(m.param1, new)

    def _trigger_watches(self, version: int) -> None:
        if not self._watches:
            return
        still = []
        for w in self._watches:
            if w.reply.is_set():
                continue
            cur = self.data.get(w.key, version)
            if cur != w.value:
                w.reply.send(version)
            else:
                still.append(w)
        self._watches = still

    # -- reads (ref: getValueQ :680) --
    async def _wait_for_version(self, version: int) -> None:
        """(ref: waitForVersion :627). Blocks until the node catches up; a
        read below the window raises TransactionTooOld (:634). The window
        check repeats AFTER the wait: the update loop can apply a large
        version jump and trim the window past `version` while this request
        was parked, and the VersionedMap's window assertion must never be
        reachable from a client request."""
        if version < self.oldest_version:
            raise TransactionTooOld()
        await self.version.when_at_least(version)
        if version < self.oldest_version:
            raise TransactionTooOld()

    def set_owned(self, begin: bytes, end: bytes, owned: bool) -> None:
        self.owned.insert(KeyRange(begin, end), owned)

    def set_assigned(self, begin: bytes, end: bytes, assigned: bool) -> None:
        self.assigned.insert(KeyRange(begin, end), assigned)

    def _check_owned(self, begin: bytes, end: bytes) -> None:
        from ..core.errors import WrongShardServer

        for _, _, owned in self.owned.intersecting(KeyRange(begin, end)):
            if not owned:
                raise WrongShardServer()

    async def get_value(self, req: GetValueRequest) -> Optional[bytes]:
        if buggify("storage_slow_read"):
            # A hot replica: hedged reads / load balance must route around.
            await current_loop().delay(0.05 * current_loop().random.random01())
        await self._wait_for_version(req.version)
        self._check_owned(req.key, key_after(req.key))
        self.metrics.on_read()
        return self.data.get(req.key, req.version)

    async def get_range(self, req: GetRangeRequest):
        if buggify("storage_slow_range"):
            await current_loop().delay(0.05 * current_loop().random.random01())
        await self._wait_for_version(req.version)
        self._check_owned(req.begin, req.end)
        self.metrics.on_read()
        return self.data.get_range(
            req.begin, req.end, req.version, req.limit, req.reverse
        )

    # -- batched read path (every engine impl; see _read_batch_loop) --
    async def _batched_read(self, req):
        """Version wait + shard checks per request (identical semantics
        to the direct path), then park on the batcher: concurrent reads
        coalesce into one fused device dispatch."""
        if isinstance(req, GetValueRequest):
            if buggify("storage_slow_read"):
                await current_loop().delay(
                    0.05 * current_loop().random.random01())
            await self._wait_for_version(req.version)
            self._check_owned(req.key, key_after(req.key))
        else:
            if buggify("storage_slow_range"):
                await current_loop().delay(
                    0.05 * current_loop().random.random01())
            await self._wait_for_version(req.version)
            self._check_owned(req.begin, req.end)
        self.metrics.on_read()
        from ..core.runtime import Promise

        p = Promise()
        self._read_batch_q.append((req, p))
        self._read_batch_wake.send(None)
        return await p.future

    async def _read_batch_loop(self):
        """Coalesce parked reads into fused dispatches, pipelined to
        SERVER_KNOBS.STORAGE_READ_PIPELINE_DEPTH handles in flight before
        the oldest one's verdicts are consumed (the submit/verdicts split
        mirrors the resolver's ResolveHandle: dispatch never blocks the
        host; read_verdicts is the ONE sync site).

        An engine without submit_reads (the memory oracle) takes the SAME
        loop — same coalescing delay, same depth gate, same yield — and
        is answered by host-side lookups at the consume site. Engine
        choice must never perturb the sim schedule: batches are parked,
        dispatched, and consumed at identical instants either way; only
        the host/device work between those instants differs (which is
        wall time, invisible to the simulated clock)."""
        from collections import deque

        loop = current_loop()
        batched = hasattr(self.data, "submit_reads")
        inflight: deque = deque()  # (handle, point promises, range promises)
        while True:
            if not self._read_batch_q and not inflight:
                await self._read_batch_wake.pop()
                continue  # re-check: the ping may be stale (queue drained)
            if self._read_batch_q:
                if (SERVER_KNOBS.STORAGE_READ_BATCH_INTERVAL > 0
                        and len(self._read_batch_q)
                        < SERVER_KNOBS.STORAGE_READ_BATCH_MAX):
                    # the coalescing window: let concurrent readers pile on
                    await loop.delay(SERVER_KNOBS.STORAGE_READ_BATCH_INTERVAL)
                # The slice re-reads the queue FRESH after the coalescing
                # park (that is the point: concurrent readers pile on),
                # and each request re-checks oldest_version below; the
                # PR 19 bug was snapshotting before the park, not after.
                # fdblint: allow[await-stale-guard] -- fresh re-read after park
                batch = self._read_batch_q[
                    : int(SERVER_KNOBS.STORAGE_READ_BATCH_MAX)
                ]
                del self._read_batch_q[: len(batch)]
                points, pts_p, ranges, rng_p = [], [], [], []
                for req, p in batch:
                    # The window can advance while a request is parked
                    # (the update loop may apply a version jump and trim
                    # past req.version): re-check the waitForVersion
                    # window guard here — and again at consume — so the
                    # VersionedMap's window assertion is never reachable
                    # from a client request.
                    if req.version < self.oldest_version:
                        if not p.is_set():
                            p.send_error(TransactionTooOld())
                        continue
                    if isinstance(req, GetValueRequest):
                        points.append((req.key, req.version))
                        pts_p.append(p)
                    else:
                        ranges.append((req.begin, req.end, req.version,
                                       req.limit, req.reverse))
                        rng_p.append(p)
                try:
                    handle = (self.data.submit_reads(points, ranges)
                              if batched else None)
                except BaseException as e:
                    for p in pts_p + rng_p:
                        if not p.is_set():
                            p.send_error(e)
                    continue
                inflight.append((handle, points, ranges, pts_p, rng_p))
                self.read_batches += 1
                self.read_batch_peak = max(self.read_batch_peak, len(batch))
            depth = max(1, int(SERVER_KNOBS.STORAGE_READ_PIPELINE_DEPTH))
            if len(inflight) >= depth or (inflight
                                          and not self._read_batch_q):
                # Yield before blocking on verdicts: arrivals just
                # unblocked must enqueue ahead of the host sync so the
                # NEXT dispatch overlaps this readback on device.
                await loop.yield_(TaskPriority.STORAGE)
                handle, pts, rngs, pts_p, rng_p = inflight.popleft()
                # The window can ALSO advance between dispatch and this
                # consume: verdicts for now-stale versions are discarded
                # and their readers get TransactionTooOld — identically
                # on both the device and host-oracle paths, so the reply
                # schedule stays engine-invariant.
                old = self.oldest_version
                try:
                    if batched:
                        pv, rv = self.data.read_verdicts(handle)
                    else:
                        pv = [None if v < old else self.data.get(k, v)
                              for k, v in pts]
                        rv = [None if v < old
                              else self.data.get_range(b, e, v, lim, rev)
                              for b, e, v, lim, rev in rngs]
                except BaseException as e:
                    for p in pts_p + rng_p:
                        if not p.is_set():
                            p.send_error(e)
                    continue
                for (_, v), p, val in zip(pts, pts_p, pv):
                    if p.is_set():
                        continue
                    if v < old:
                        p.send_error(TransactionTooOld())
                    else:
                        p.send(val)
                for (_, _, v, _, _), p, rows in zip(rngs, rng_p, rv):
                    if p.is_set():
                        continue
                    if v < old:
                        p.send_error(TransactionTooOld())
                    else:
                        p.send(rows)

    async def watch_value(self, req: WatchValueRequest) -> int:
        """Resolves req.reply (and returns) the version at which the value
        was seen to differ (ref: watchValue_impl :758)."""
        await self._wait_for_version(req.version)
        cur = self.data.get(req.key, self.version.get())
        if cur != req.value:
            if not req.reply.is_set():
                req.reply.send(self.version.get())
        else:
            self._watches.append(req)
            TraceEvent("StorageWatchStarted").detail("Key", req.key).log()
        return await req.reply.future
