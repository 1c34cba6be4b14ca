"""Resolver role: version-chained conflict resolution (ref:
fdbserver/Resolver.actor.cpp:71-260).

Wraps a ConflictSet backend (the CPU oracle or the device set — same
contract) in the ordering actor the reference runs: a batch for
(prevVersion, version] waits `version.whenAtLeast(prevVersion)` (:110-116)
so batches resolve in commit-version order no matter how proxies race, then
detects conflicts and advances the resolver's version. The OCC memory
window is MAX_WRITE_TRANSACTION_LIFE_VERSIONS behind the batch version
(:157, fdbserver/Knobs.cpp:61).

PIPELINED CONSUMPTION (device-backed conflict sets). A backend exposing
submit()/verdicts() (ConflictSetGPU) splits a
resolve into a dispatch that never syncs the device and a verdict D2H.
The role exploits the split with TWO version chains:

  version    gates DISPATCH: window (prev, v] submits as soon as window
             prev dispatched — the conflict-set state update is ordered
             by dispatch, which is all correctness needs (the device
             state is a pure function of the dispatch sequence).
  _consumed  gates CONSUMPTION: verdicts are read back and replied in
             commit-version order, so proxies observe exactly the
             synchronous path's reply semantics.

Between a window's dispatch and its consumption, up to
SERVER_KNOBS.TPU_PIPELINE_DEPTH batches are in flight on the device —
the phase-1/2/3 steps of batch N+1 overlap batch N's readback, which is
what turns the batch-scaled kernel into a batch-scaled pipeline
(ROADMAP: h2d+pack < 20% of batch latency). Verdicts are bit-identical
to the synchronous path because neither the dispatch order nor the
per-batch device program changes — only WHEN the host blocks.

ONE SCHEDULE ON EVERY BACKEND (the port's departure from the JAX
package, whose role yields before each readback so that the successors
its version bump woke dispatch first). The role never suspends between a
window's dispatch and its readback, so a window takes the steps of the
event loop that the synchronous path takes, and a simulated seed replays
to the same schedule and fingerprint whichever backend
CONFLICT_SET_IMPL draws. The price: under the cooperative event loop a
window's dispatch and readback fall in one step, so one batch is in
flight at a time. The split still times the stages, and the two chains
and the depth gate stay as the contract above states them.

Batches may arrive as wire bytes (resolver/wire.py columnar batches,
SERVER_KNOBS.RESOLVER_WIRE_BATCH): device backends pack them with the
vectorized encoder, object backends decode once.
"""

from __future__ import annotations

from collections import deque

from ..core.actors import NotifiedVersion
from ..core.errors import OperationFailed
from ..core.knobs import SERVER_KNOBS
from ..core.rand import DeterministicRandom
from ..core.stats import ContinuousSample, LatencyBands
from ..core.trace import TraceEvent, trace_txn_event
from ..resolver.types import ConflictBatchResult
from .interfaces import ResolveTransactionBatchRequest

# Stage keys of the pipeline breakdown, in pipeline order. The seams:
# pack = host rows -> fused buffer; h2d = host fence ranking + transfer/
# kernel ENQUEUE; device = wait until the device finished the batch at
# consumption; d2h = the verdict readback itself.
_STAGES = ("pack_ms", "h2d_ms", "device_ms", "d2h_ms")


class ResolverRole:
    def start_serving(self):
        """Serve ResolveTransactionBatchRequests from self.resolve_stream,
        so the proxy->resolver hop can cross a (simulated) network exactly
        like the reference's RPC (ResolverInterface.resolve RequestStream).
        Returns the serving task."""
        from ..core.actors import serve_requests
        from ..core.runtime import TaskPriority

        return serve_requests(self.resolve_stream, self.resolve_batch,
                              TaskPriority.RESOLVER, "resolverServe")

    async def skip_window(self, prev_version: int, version: int) -> None:
        """Advance the version chain over a window that resolved nothing
        (a proxy batch that failed before reaching this resolver). No-op
        if the window was already resolved — idempotent by construction.
        Both chains advance: a successor's verdict consumption waits on
        _consumed exactly like its dispatch waits on version."""
        await self.version.when_at_least(prev_version)
        if self.version.get() == prev_version:
            self.version.set(version)
        await self._consumed.when_at_least(prev_version)
        if self._consumed.get() == prev_version:
            self._consumed.set(version)

    def __init__(self, conflict_set, init_version: int = 0,
                 metrics_labels=()):
        from ..core.actors import PromiseStream

        self.metrics_labels = tuple(metrics_labels)
        self.cs = conflict_set
        self.resolve_stream = PromiseStream()
        self.version = NotifiedVersion(init_version)
        # Consumption chain + in-flight window queue (pipelined path).
        self._consumed = NotifiedVersion(init_version)
        self._inflight_q: deque[int] = deque()
        self.max_inflight = 0
        # Per-stage timing reservoirs (status json pipeline block). Only
        # the device path fills them, so once full they draw from a stream
        # of their own: a draw from the loop's stream would move every
        # later simulated decision of a device run off the host run's (the
        # JAX package's reservoirs draw from the loop's).
        stage_random = DeterministicRandom(0)
        self.stage_samples = {k: ContinuousSample(256, random=stage_random)
                              for k in _STAGES}
        # Whole-resolve latency bands (knob-configured edges), surfaced in
        # the pipeline status block both tiers + ResolverStatusRequest.
        self.latency_bands = LatencyBands()
        # Counters (ref: Resolver.actor.cpp:155-158 g_counters).
        self.conflict_batches = 0
        self.conflict_transactions = 0
        self.total_transactions = 0
        # Load accounting for resolutionBalancing (ref: the iopsSample
        # fed to the master, Resolver.actor.cpp:148-152): total conflict-
        # range keys judged, plus a reservoir of range-begin keys the
        # balancer splits on.
        self.keys_resolved = 0
        self._sample: list[bytes] = []
        self._sample_seen = 0
        # State-transaction retention (ref: Resolver.actor.cpp:171-190):
        # system-keyspace mutations of recent windows, kept so OTHER
        # proxies can catch their metadata caches up from resolve replies
        # (only resolver 0 is fed — the system keyspace's single home).
        self._pending_state: dict[int, list] = {}   # version -> [(idx, m)]
        self.state_store: dict[int, tuple] = {}     # version -> (Mutation,)
        self.register_metrics()

    def register_metrics(self, registry=None) -> None:
        """Register this resolver's instruments on the per-process
        MetricRegistry (replace=True: per-generation roles supersede;
        multi-resolver fleets disambiguate via metrics_labels)."""
        from ..core.metrics import global_registry

        reg = registry if registry is not None else global_registry()
        lbl = self.metrics_labels
        reg.register_gauge("resolver.batches_count",
                           lambda: self.conflict_batches,
                           labels=lbl, replace=True)
        reg.register_gauge("resolver.txns_count",
                           lambda: self.total_transactions,
                           labels=lbl, replace=True)
        reg.register_gauge("resolver.conflicts_count",
                           lambda: self.conflict_transactions,
                           labels=lbl, replace=True)
        reg.register_gauge("resolver.keys_resolved_count",
                           lambda: self.keys_resolved,
                           labels=lbl, replace=True)
        reg.register_gauge("resolver.inflight_depth",
                           lambda: len(self._inflight_q),
                           labels=lbl, replace=True)
        reg.register_bands("resolver.batch_ms", self.latency_bands,
                           labels=lbl, replace=True)
        for stage, s in self.stage_samples.items():
            reg.register_sample("resolver.stage_ms", s,
                                labels=lbl + (("stage", stage[:-3]),),
                                replace=True)

    _SAMPLE_CAP = 64

    def _sample_key(self, key: bytes) -> None:
        from ..core.runtime import current_loop

        self._sample_seen += 1
        if len(self._sample) < self._SAMPLE_CAP:
            self._sample.append(key)
            return
        j = current_loop().random.random_int(0, self._sample_seen)
        if j < self._SAMPLE_CAP:
            self._sample[j] = key

    def key_sample(self) -> list[bytes]:
        return list(self._sample)

    def pipeline_status(self) -> dict:
        """Per-stage timing breakdown + live depth for `status json`: the
        observable form of the ROADMAP bar "h2d+pack < 20% of batch
        latency" on a running cluster."""
        from ..core.stats import stage_percentiles

        return {
            "depth_configured": SERVER_KNOBS.TPU_PIPELINE_DEPTH,
            "in_flight": len(self._inflight_q),
            "max_in_flight_measured": self.max_inflight,
            "stages": stage_percentiles(self.stage_samples),
            "latency_bands": self.latency_bands.status(),
        }

    def _record_stages(self, handle) -> None:
        for key, val in (("pack_ms", handle.pack_ms),
                         ("h2d_ms", handle.dispatch_ms),
                         ("device_ms", handle.device_ms),
                         ("d2h_ms", handle.d2h_ms)):
            if val is not None:
                self.stage_samples[key].add_sample(val)

    def apply_feedback(self, feedback) -> None:
        """Proxy feedback: which txns of an earlier window globally
        committed — promote their retained system mutations (a resolver
        judges only its clip, so the MERGED verdict must come back)."""
        for version, committed_idxs in feedback:
            pend = self._pending_state.pop(version, None)
            if pend is None:
                continue
            keep = tuple(
                m for idx, m in pend if idx in set(committed_idxs)
            )
            if keep:
                self.state_store[version] = keep

    def recent_state(self, above: int, upto: int):
        """Retained committed system mutations in (above, upto]."""
        return tuple(
            (v, self.state_store[v])
            for v in sorted(self.state_store)
            if above < v <= upto
        )

    # -- batch accounting shared by both resolve paths --

    def _account_batch(self, req, wb, n_txns: int) -> None:
        self.total_transactions += n_txns
        if wb is not None:
            self.keys_resolved += wb.total_ranges()
            # Balancer key sample without a per-row loop: up to
            # _SAMPLE_CAP evenly strided write-begin keys through the
            # deterministic reservoir.
            nw = len(wb.wb_len)
            if nw:
                blob = wb.blob
                step = max(1, nw // self._SAMPLE_CAP)
                for i in range(0, nw, step):
                    o = int(wb.wb_off[i])
                    self._sample_key(
                        blob[o : o + int(wb.wb_len[i])].tobytes()
                    )
        else:
            for t in req.transactions:
                self.keys_resolved += len(t.read_ranges) + len(t.write_ranges)
                for w in t.write_ranges:
                    self._sample_key(w.begin)

    def _retain_state(self, req) -> None:
        # Retain this window's system mutations until the proxy reports
        # the merged verdicts (apply_feedback), then prune the write-life
        # horizon.
        sys_muts = getattr(req, "system_mutations", ())
        if sys_muts:
            self._pending_state[req.version] = list(sys_muts)
        horizon = req.version - SERVER_KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        for v in [v for v in self.state_store if v < horizon]:
            del self.state_store[v]
        for v in [v for v in self._pending_state if v < horizon]:
            del self._pending_state[v]

    async def resolve_batch(
        self, req: ResolveTransactionBatchRequest
    ) -> ConflictBatchResult:
        from ..core.runtime import buggify, current_loop

        if buggify("resolver_slow_batch"):
            # A straggling resolver: the proxy's verdict merge must wait
            # (and successor windows chain behind this one).
            await current_loop().delay(0.05 * current_loop().random.random01())
        self.apply_feedback(getattr(req, "committed_feedback", ()))
        await self.version.when_at_least(req.prev_version)
        if self.version.get() != req.prev_version:
            # This window was already driven past — e.g. the proxy timed
            # the request out over a slow link and compensated with
            # skip_window, or a newer generation recovered. Re-resolving
            # would re-merge writes; refuse instead (the reference keeps
            # recent outputs and replays them, :97-104 — here the caller
            # that compensated has already answered its clients).
            raise OperationFailed(
                f"resolver window ({req.prev_version}, {req.version}] "
                f"already superseded at version {self.version.get()}"
            )
        wb = None
        wire = getattr(req, "wire", None)
        if wire is not None:
            from ..resolver.wire import WireBatch

            wb = WireBatch.from_bytes(wire)
        n_txns = wb.n_txns if wb is not None else len(req.transactions)
        new_oldest = max(
            0, req.version - SERVER_KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS
        )
        pipelined = (
            hasattr(self.cs, "submit")
            and SERVER_KNOBS.TPU_PIPELINE_DEPTH > 1
        )
        # Flight recorder: Submit marks the batch entering the resolver
        # (depth-gate park + dispatch ahead); Verdict marks verdict
        # consumption — on the pipelined path their gap IS the
        # submit->verdicts handle lifetime, the device-resident window.
        dbg = getattr(req, "debug_id", None)
        t0 = current_loop().now()
        trace_txn_event("Resolver.Submit", dbg, Version=req.version,
                        Txns=n_txns, Pipelined=pipelined)
        if pipelined:
            result = await self._resolve_pipelined(req, wb, n_txns,
                                                   new_oldest)
        else:
            result = await self._resolve_sync(req, wb, n_txns, new_oldest)
        self.conflict_batches += 1
        self._account_batch(req, wb, n_txns)
        self._retain_state(req)
        n_conflict = sum(1 for s in result.statuses if s != 0)
        self.conflict_transactions += n_conflict
        self.latency_bands.add(current_loop().now() - t0, exemplar=dbg)
        trace_txn_event("Resolver.Verdict", dbg, Version=req.version,
                        Conflicts=n_conflict)
        if wb is not None:
            # Per-txn verdicts for the sampled rows riding the wire
            # batch's sparse debug column: the timeline shows WHICH
            # sampled transaction conflicted, not just that the batch did.
            for idx, did in getattr(wb, "dbg", ()):
                if 0 <= idx < len(result.statuses):
                    trace_txn_event("Resolver.TxnVerdict", did,
                                    Version=req.version,
                                    Status=int(result.statuses[idx]))
        TraceEvent("ResolverBatch").detail("Version", req.version).detail(
            "Transactions", n_txns
        ).detail("Conflicts", n_conflict).log()
        # Catch-up payload for the requesting proxy: committed system
        # mutations from windows it has not yet seen (in-process reply
        # attribute; the wire tier will lift this into the reply message
        # when proxies span processes).
        result.state_mutations = self.recent_state(
            req.last_receive_version, req.prev_version
        )
        return result

    def _batch_for_cs(self, req, wb, *, wants_wire: bool):
        """The batch in the form this backend consumes: device backends
        take the columnar WireBatch straight into the vectorized packer;
        object backends get the decoded (or original) txn list."""
        if wb is not None and wants_wire:
            return wb
        if req.transactions or wb is None:
            return req.transactions
        return wb.to_txns()

    async def _resolve_sync(self, req, wb, n_txns, new_oldest):
        """The synchronous path (object backends, or TPU_PIPELINE_DEPTH
        <= 1): resolve end to end, then advance both chains."""
        batch = self._batch_for_cs(
            req, wb, wants_wire=hasattr(self.cs, "submit")
        )
        try:
            result = self.cs.resolve(req.version, new_oldest, batch)
        except BaseException as e:
            # A failed batch commits NOTHING (no write merged, every client
            # answered with an error by the proxy), so advancing the version
            # chain is sound — and required, or the whole pipeline would
            # wedge behind this window forever. The reference instead
            # crashes the resolver role and relies on master recovery
            # (SURVEY §3.3); in-process, fail the batch and keep serving.
            TraceEvent("ResolverBatchError", severity=40).detail(
                "Version", req.version
            ).error(e).log()
            self.version.set(req.version)
            if self._consumed.get() == req.prev_version:
                self._consumed.set(req.version)
            raise
        self.version.set(req.version)
        if self._consumed.get() == req.prev_version:
            self._consumed.set(req.version)
        return result

    async def _resolve_pipelined(self, req, wb, n_txns, new_oldest):
        """Dispatch under the version chain, consume under the _consumed
        chain (see module docstring). The depth bound parks the dispatch
        until enough older verdicts were consumed."""
        depth = max(1, SERVER_KNOBS.TPU_PIPELINE_DEPTH)
        while len(self._inflight_q) >= depth:
            # Ascending in-flight versions; consuming through the
            # (len-depth)-th leaves depth-1 in flight. Older windows'
            # consumption never needs this coroutine, so parking here
            # cannot deadlock the chain. The while re-checks because
            # several parked dispatches can wake on one consumption bump
            # and must not overshoot the depth bound together.
            target = self._inflight_q[len(self._inflight_q) - depth]
            await self._consumed.when_at_least(target)
        if self.version.get() != req.prev_version:
            # The chain moved while this dispatch was parked at the depth
            # gate: the proxy timed the window out and compensated with
            # skip_window (or retried it, and the twin already dispatched).
            # resolve_batch's pre-check ran before the park, so it cannot
            # see this; dispatching now would re-merge the window's writes
            # into the conflict state. Refuse exactly like the pre-check.
            raise OperationFailed(
                f"resolver window ({req.prev_version}, {req.version}] "
                f"superseded at version {self.version.get()} while parked "
                "at the pipeline depth gate"
            )
        batch = self._batch_for_cs(req, wb, wants_wire=True)
        try:
            handle = self.cs.submit(req.version, new_oldest, batch)
        except BaseException as e:
            TraceEvent("ResolverBatchError", severity=40).detail(
                "Version", req.version
            ).error(e).log()
            self.version.set(req.version)
            # Keep the consumption chain intact for successor windows.
            await self._consumed.when_at_least(req.prev_version)
            if self._consumed.get() == req.prev_version:
                self._consumed.set(req.version)
            raise
        self._inflight_q.append(req.version)
        self.max_inflight = max(self.max_inflight, len(self._inflight_q))
        # Unblock the NEXT window's dispatch: device state is ordered by
        # the dispatch sequence, so the chain may advance before verdicts
        # are read back.
        self.version.set(req.version)
        # No yield before the readback (see ONE SCHEDULE in the module
        # docstring): the successors just woken run after this step.
        await self._consumed.when_at_least(req.prev_version)
        try:
            statuses = self.cs.verdicts(handle)
        except BaseException as e:
            TraceEvent("ResolverBatchError", severity=40).detail(
                "Version", req.version
            ).error(e).log()
            if self._inflight_q and self._inflight_q[0] == req.version:
                self._inflight_q.popleft()
            self._consumed.set(req.version)
            raise
        if self._inflight_q and self._inflight_q[0] == req.version:
            self._inflight_q.popleft()
        self._consumed.set(req.version)
        self._record_stages(handle)
        return ConflictBatchResult(statuses)
