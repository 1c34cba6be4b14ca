"""Generic request batcher (ref: fdbrpc/batcher.actor.h:29-60).

Collects items from a PromiseStream into batches closed by (a) item count,
(b) accumulated bytes, or (c) a deadline measured from the first item — the
same three triggers the reference's proxy uses to shape commit batches for
the resolver. For the TPU resolver the count trigger is what builds
accelerator-sized batches (SURVEY.md north star: the batcher is tuned to
feed the kernel 64K-class chunks).

`interval` may be a float or a zero-arg callable re-evaluated per batch —
the hook the proxy's adaptive coalescing controller uses to float the
deadline between the MIN/MAX knobs on recent-fill feedback (ref: the
reference's dynamic commitBatchInterval, MasterProxyServer.actor.cpp:244).
With `with_info=True`, on_batch also receives a BatchInfo describing how
the batch closed (trigger + open duration + bytes) — the controller's
feedback signal and the `form` stage of the commit-plane breakdown.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Awaitable, Callable

from ..core.actors import PromiseStream, timeout
from ..core.runtime import TaskPriority, current_loop


@dataclass
class BatchInfo:
    """How one batch closed: trigger in {"deadline", "count", "bytes"},
    the wall the batch spent open (first item -> close), and its size."""

    closed_by: str
    open_s: float
    bytes: int


async def batcher(
    stream: PromiseStream,
    on_batch: Callable[[list], None],
    *,
    interval,
    max_count: int = 1 << 30,
    max_bytes: int = 1 << 62,
    bytes_of: Callable[[object], int] = lambda _: 1,
    priority: int = TaskPriority.PROXY_COMMIT,
    with_info: bool = False,
):
    """Forever: gather a batch and hand it to on_batch (which typically
    spawns the per-batch actor so batching continues concurrently)."""
    from ..core.runtime import buggify

    loop = current_loop()
    sentinel = object()
    while True:
        first = await stream.pop()
        opened = loop.now()
        batch = [first]
        size = bytes_of(first)
        iv = interval() if callable(interval) else interval
        deadline = opened + iv
        if buggify("batcher_tiny_batches"):
            deadline = loop.now()  # close immediately: 1-item batches
        elif buggify("batcher_slow_flush"):
            deadline += iv * 4  # stragglers pile into one batch
        closed_by = "deadline"
        while True:
            if size >= max_bytes:
                closed_by = "bytes"
                break
            if len(batch) >= max_count:
                closed_by = "count"
                break
            remaining = deadline - loop.now()
            if remaining <= 0:
                break
            pop_f = stream.pop()
            nxt = await timeout(pop_f, remaining, default=sentinel)
            if nxt is sentinel:
                # The pop raced the deadline: if its value ever arrives,
                # refund it to the stream front so nothing is lost.
                pop_f.add_callback(
                    lambda f: stream.unpop(f._value) if f.is_set() else None
                )
                break
            batch.append(nxt)
            size += bytes_of(nxt)
        if with_info:
            on_batch(batch, BatchInfo(closed_by, loop.now() - opened, size))
        else:
            on_batch(batch)
        # Yield so the spawned batch actor starts before the next gather.
        await loop.yield_(priority)
