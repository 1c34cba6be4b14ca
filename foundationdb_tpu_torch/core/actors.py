"""Actor combinators (ref: flow/genericactors.actor.h).

`all_of`, `any_of`, `timeout`, streams, AsyncVar/AsyncTrigger — the
vocabulary the reference's control plane is written in, in idiomatic
async/await form.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Generic, Iterable, Optional, TypeVar

from .errors import ActorCancelled, EndOfStream, TimedOut
from .runtime import Future, Promise, Task, TaskPriority, current_loop, ready_future

T = TypeVar("T")


def all_of(futures: list[Future]) -> Future:
    """Resolves with the list of results, or the first error (ref: getAll)."""
    out = Promise()
    if not futures:
        out.send([])
        return out.future
    remaining = [len(futures)]
    results: list[Any] = [None] * len(futures)

    def make_cb(i):
        def cb(f: Future):
            if out.is_set():
                return
            if f.is_error():
                out.send_error(f._value)
                return
            results[i] = f._value
            remaining[0] -= 1
            if remaining[0] == 0:
                out.send(results)

        return cb

    for i, f in enumerate(futures):
        f.add_callback(make_cb(i))
    return out.future


def any_of(futures: list[Future]) -> Future:
    """Resolves with (index, value) of the first future to finish (ref: choose/waitForAny)."""
    if not futures:
        raise ValueError("any_of([]) can never resolve")
    out = Promise()

    def make_cb(i):
        def cb(f: Future):
            if out.is_set():
                return
            if f.is_error():
                out.send_error(f._value)
            else:
                out.send((i, f._value))

        return cb

    for i, f in enumerate(futures):
        f.add_callback(make_cb(i))
    return out.future


def _with_timer(fut: Future, seconds: float, on_expiry) -> Future:
    out = Promise()

    def on_fut(f: Future):
        if out.is_set():
            return
        if f.is_error():
            out.send_error(f._value)
        else:
            out.send(f._value)

    def on_timer(_):
        if not out.is_set():
            on_expiry(out)

    fut.add_callback(on_fut)
    current_loop().delay(seconds).add_callback(on_timer)
    return out.future


def timeout(fut: Future, seconds: float, default: Any = None) -> Future:
    """Value of fut, or `default` after `seconds` (ref: timeout, genericactors)."""
    return _with_timer(fut, seconds, lambda out: out.send(default))


def timeout_error(fut: Future, seconds: float) -> Future:
    """Like timeout(), but raises TimedOut instead of a default value."""
    return _with_timer(fut, seconds, lambda out: out.send_error(TimedOut()))


class PromiseStream(Generic[T]):
    """Multi-value channel (ref: PromiseStream/FutureStream, flow/flow.h:756-833).

    send() never blocks; pop() awaits the next value FIFO. close() makes
    subsequent pops raise EndOfStream.
    """

    def __init__(self):
        self._queue: deque[T] = deque()
        self._waiters: deque[Promise] = deque()
        self._closed: Optional[BaseException] = None

    def send(self, value: T) -> None:
        if self._closed is not None:
            return
        while self._waiters:
            w = self._waiters.popleft()
            if not w.is_set():
                w.send(value)
                return
        self._queue.append(value)

    def send_error(self, err: BaseException) -> None:
        self._closed = err
        while self._waiters:
            w = self._waiters.popleft()
            if not w.is_set():
                w.send_error(err)

    def close(self) -> None:
        self.send_error(EndOfStream())

    def pop(self) -> Future:
        if self._queue:
            # A queued value is consumed at pop() time: awaiting an already-
            # ready future never suspends the actor, so there is no window in
            # which cancellation could abandon it. (A popper that parks the
            # ready future and dies at some other await forfeits the value —
            # same as the reference, where popping dequeues immediately.)
            return ready_future(self._queue.popleft())
        if self._closed is not None:
            p = Promise()
            p.send_error(self._closed)
            return p.future
        p = Promise()

        def abandoned(fut: Future):
            if fut.is_set():
                self._queue.appendleft(fut._value)
            else:
                try:
                    self._waiters.remove(p)
                except ValueError:
                    pass

        p.future._abandon_cb = abandoned
        self._waiters.append(p)
        return p.future

    def unpop(self, value: T) -> None:
        """Return a value to the FRONT of the stream (a consumer that gave
        up on a pop — e.g. a batch deadline — puts the eventually-delivered
        value back so it is the next one popped). Single-consumer pattern:
        with concurrent poppers the refund's FIFO position is undefined."""
        if self._closed is not None:
            return
        while self._waiters:
            w = self._waiters.popleft()
            if not w.is_set():
                w.send(value)
                return
        self._queue.appendleft(value)

    def __len__(self):
        return len(self._queue)

    def is_empty(self) -> bool:
        return not self._queue


class AsyncVar(Generic[T]):
    """A mutable value whose changes can be awaited (ref: AsyncVar<T>)."""

    def __init__(self, value: T = None):
        self._value = value
        self._change = Promise()

    def get(self) -> T:
        return self._value

    def set(self, value: T) -> None:
        if value == self._value:
            return
        self._value = value
        self.trigger()

    def trigger(self) -> None:
        prev, self._change = self._change, Promise()
        prev.send(None)

    def on_change(self) -> Future:
        return self._change.future


class AsyncTrigger:
    """An awaitable edge trigger (ref: AsyncTrigger)."""

    def __init__(self):
        self._p = Promise()

    def trigger(self) -> None:
        prev, self._p = self._p, Promise()
        prev.send(None)

    def on_trigger(self) -> Future:
        return self._p.future


class NotifiedVersion:
    """Monotone version with whenAtLeast() waits (ref: NotifiedVersion).

    The ordering backbone of the commit pipeline: resolvers and tlogs chain
    batches by (prevVersion -> version) using exactly this.
    """

    def __init__(self, value: int = 0):
        self._value = value
        self._waiters: list[tuple[int, Promise]] = []

    def get(self) -> int:
        return self._value

    def set(self, value: int) -> None:
        assert value >= self._value, f"NotifiedVersion moved backwards {self._value} -> {value}"
        self._value = value
        still = []
        for at, p in self._waiters:
            if at <= value:
                if not p.is_set():
                    p.send(None)
            else:
                still.append((at, p))
        self._waiters = still

    def rollback_to(self, value: int) -> None:
        """Move the cursor BACKWARDS — recovery-only (ref: the storage
        rollback path, storageserver.actor.cpp rollback + rebooter).
        Waiters above the new value keep waiting: their versions will be
        reached again by the new generation's chain."""
        assert value <= self._value
        self._value = value

    def when_at_least(self, at: int) -> Future:
        if self._value >= at:
            return ready_future(None)
        p = Promise()
        self._waiters.append((at, p))
        return p.future


class ActorCollection:
    """Owns a set of tasks; cancels them all on cancel() (ref: ActorCollection)."""

    def __init__(self):
        self.tasks: list[Task] = []

    def add(self, task: Task) -> Task:
        self.tasks = [t for t in self.tasks if not t.done.is_ready()]
        self.tasks.append(task)
        return task

    def cancel_all(self) -> None:
        for t in self.tasks:
            t.cancel()
        self.tasks = []


def serve_requests(stream: "PromiseStream", handler, priority: int,
                   name: str) -> Task:
    """Spawn a request-serving loop: pop requests forever, handle each in
    its own task, and answer via the request's reply promise (errors
    included) — the standard endpoint shape every role uses (ref: the
    RequestStream serve loops in each *Interface)."""
    from .runtime import spawn

    async def serve_one(req):
        try:
            result = await handler(req)
            if not req.reply.is_set():
                req.reply.send(result)
        except BaseException as e:  # noqa: BLE001 — errors go to the caller
            if not req.reply.is_set():
                req.reply.send_error(e)

    async def serve():
        while True:
            req = await stream.pop()
            spawn(serve_one(req), priority, name=f"{name}_req")

    return spawn(serve(), priority, name=name)


async def recurring(fn, interval: float, priority: int = TaskPriority.DEFAULT):
    """Calls fn() every `interval` seconds forever (ref: recurring)."""
    loop = current_loop()
    while True:
        await loop.delay(interval, priority)
        fn()
