"""Thread-safe database facade (ref:
fdbclient/ThreadSafeTransaction.actor.cpp — every API call marshals onto
the network thread via onMainThread, returning a thread-safe future; the
C bindings wrap exactly this).

The framework's event loop is single-threaded and cooperative, like the
reference's. `ThreadSafeDatabase.run(body)` may be called from ANY
thread: it enqueues the transactional body on a thread-safe queue and
returns a concurrent.futures.Future; a drainer actor on the loop thread
executes bodies through the normal retry loop. On a real-clock loop with
a reactor, a wakeup socketpair interrupts the select() immediately; on a
simulated loop the drainer polls on a short timer (the sim clock makes
the poll free)."""

from __future__ import annotations

import collections
import concurrent.futures
import socket
import threading
from typing import Awaitable, Callable, Optional

from ..core.runtime import Task, TaskPriority, current_loop, spawn


class ThreadSafeDatabase:
    def __init__(self, db):
        self.db = db
        self._loop = current_loop()
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wake_r = self._wake_w = None
        reactor = getattr(self._loop, "reactor", None)
        if reactor is not None:
            self._wake_r, self._wake_w = socket.socketpair()
            self._wake_r.setblocking(False)
            reactor.register_read(self._wake_r.fileno(), self._drain_wake)
        self._task: Optional[Task] = spawn(
            self._drainer(), TaskPriority.DEFAULT, name="threadsafe_db"
        )

    def _drain_wake(self) -> None:
        try:
            self._wake_r.recv(4096)
        except BlockingIOError:
            pass

    # -- any thread --
    def run(self, body: Callable[..., Awaitable]) -> concurrent.futures.Future:
        """Schedule `db.transact(body)` on the loop thread; the returned
        future resolves with its result (or raises its error) and may be
        waited from any thread (ref: ThreadFuture)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._queue.append((body, fut))
        if self._wake_w is not None:
            try:
                self._wake_w.send(b"x")
            except OSError:
                pass
        return fut

    # -- loop thread --
    async def _drainer(self):
        loop = self._loop
        while True:
            job = None
            with self._lock:
                if self._queue:
                    job = self._queue.popleft()
            if job is None:
                await loop.delay(0.0005)
                continue
            body, fut = job

            async def run_one(body=body, fut=fut):
                try:
                    result = await self.db.transact(body)
                except BaseException as e:  # noqa: BLE001 — cross-thread
                    fut.set_exception(e)
                else:
                    fut.set_result(result)

            spawn(run_one(), TaskPriority.DEFAULT, name="threadsafe_txn")

    def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._wake_r is not None:
            reactor = getattr(self._loop, "reactor", None)
            if reactor is not None:
                reactor.unregister(self._wake_r.fileno())
            self._wake_r.close()
            self._wake_w.close()
