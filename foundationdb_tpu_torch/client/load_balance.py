"""Replica selection with latency/queue modeling and hedging (ref:
fdbrpc/LoadBalance.actor.h:117,164 loadBalance; fdbrpc/QueueModel.cpp).

The reference picks the replica with the lowest penalty — smoothed
latency × (outstanding requests + 1) — sends there, and if no reply
arrives within a model-derived delay it issues a SECOND request to the
next-best replica and takes whichever answers first (second-request
hedging, LoadBalance.actor.h:289-340). Failed replicas (per the
FailureMonitor view) are skipped up front. Every reply feeds the model.

`wrong_shard_server` is NOT retried here: it means the location cache is
stale, and the caller must invalidate + re-resolve (NativeAPI's
getValue/getKeyLocation loop does exactly that).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..core.actors import any_of, timeout
from ..core.errors import RequestMaybeDelivered
from ..core.knobs import CLIENT_KNOBS
from ..core.runtime import current_loop
from ..core.stats import ContinuousSample, Smoother


class ReplicaModel:
    """Per-endpoint state (ref: QueueData, fdbrpc/QueueModel.h)."""

    __slots__ = ("latency", "sample", "outstanding", "failed_until")

    def __init__(self):
        self.latency = Smoother(e_folding_time=2.0)
        self.latency.reset(0.002)  # optimistic prior, like the reference
        self.sample = ContinuousSample(size=200)
        self.outstanding = 0
        self.failed_until = 0.0

    def penalty(self, now: float) -> float:
        base = self.latency.smooth_total() * (self.outstanding + 1)
        if now < self.failed_until:
            base += 1e6  # last resort only
        return base


class QueueModel:
    """id -> ReplicaModel registry shared by all requests of one client."""

    def __init__(self):
        self._models: dict = {}

    def model(self, replica_id) -> ReplicaModel:
        m = self._models.get(replica_id)
        if m is None:
            m = self._models[replica_id] = ReplicaModel()
        return m


async def load_balance(
    queue_model: QueueModel,
    alternatives: Sequence[tuple],  # [(replica_id, endpoint), ...]
    make_req: Callable[[], object],
    failure_monitor=None,
    failure_names: Optional[dict] = None,
):
    """Send make_req() to the best replica with hedging; returns the first
    reply. Errors from the winning reply (wrong_shard_server, too_old, …)
    propagate to the caller; silence from every tried replica raises
    RequestMaybeDelivered.

    `failure_names` maps replica_id -> process name for the monitor view.
    """
    loop = current_loop()
    alts = list(alternatives)
    if not alts:
        raise RequestMaybeDelivered("no replicas for shard")
    if failure_monitor is not None and failure_names:
        healthy = [
            a for a in alts
            if not failure_monitor.is_failed(failure_names.get(a[0], ""))
        ]
        if healthy:
            alts = healthy
    now = loop.now()
    alts.sort(key=lambda a: queue_model.model(a[0]).penalty(now))

    in_flight: list[tuple] = []  # (replica_id, req, sent_at)
    settled: set[int] = set()

    def send_to(alt_idx: int):
        rid, endpoint = alts[alt_idx]
        queue_model.model(rid).outstanding += 1
        req = make_req()
        endpoint.send(req)
        in_flight.append((rid, req, loop.now()))

    def settle(i: int, ok: bool):
        if i in settled:
            return
        settled.add(i)
        rid, _, sent_at = in_flight[i]
        m = queue_model.model(rid)
        m.outstanding = max(0, m.outstanding - 1)
        if ok:
            lat = loop.now() - sent_at
            m.latency.set_total(lat)
            m.sample.add_sample(lat)
        else:
            m.failed_until = loop.now() + 1.0

    try:
        send_to(0)
        # Hedge trigger: a multiple of the chosen replica's expected
        # latency, floored (ref: the QueueModel-derived delay before the
        # backup request).
        hedge_after = max(
            0.005, queue_model.model(alts[0][0]).latency.smooth_total() * 5
        )
        backup_sent = False
        deadline = loop.now() + CLIENT_KNOBS.READ_TIMEOUT
        _lost = object()
        while True:
            can_hedge = not backup_sent and len(alts) > 1
            wait = hedge_after if can_hedge else deadline - loop.now()
            if wait <= 0:
                raise RequestMaybeDelivered("all replicas timed out")
            got = await timeout(
                any_of([r.reply.future for _, r, _ in in_flight]),
                wait, _lost,
            )
            if got is _lost:
                if can_hedge:
                    backup_sent = True
                    send_to(1)
                    continue
                # A full deadline of silence: THIS is the failure signal
                # (a lost hedge race below is not).
                for i in range(len(in_flight)):
                    settle(i, ok=False)
                raise RequestMaybeDelivered("all replicas timed out")
            idx, value = got
            settle(idx, ok=True)
            return value
    finally:
        # Reconcile stragglers: errored replies (other than
        # wrong_shard_server, a fast healthy answer about a stale MAP)
        # mark their replica; merely-unanswered hedge losers just stop
        # counting as outstanding — losing a race is not a failure.
        from ..core.errors import WrongShardServer

        for i, (rid, req, sent_at) in enumerate(in_flight):
            if i in settled:
                continue
            fut = req.reply.future
            if not fut.is_ready():
                settled.add(i)
                m = queue_model.model(rid)
                m.outstanding = max(0, m.outstanding - 1)
                continue
            ok = not fut.is_error() or isinstance(
                fut._value, WrongShardServer
            )
            settle(i, ok=ok)
