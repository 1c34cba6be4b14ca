"""Minimal async HTTP/1.1 client over the select() reactor (ref:
fdbrpc/HTTP.actor.cpp — request/response with Content-Length bodies, the
transport under the blobstore client).

One request per connection (`Connection: close`), Content-Length bodies
only — a response withOUT a Content-Length (or with chunked transfer
encoding) is REFUSED rather than silently read as empty: the blobstore
layer must never mistake a truncated reply for a zero-byte object. Real
network only: the simulator exercises containers through memory://,
exactly like the reference simulates blobstore with a local container.

One protocol state machine (`_Exchange`) backs both forms:
  - http_request       — awaitable, for actor call sites on a real-clock
                         loop (uses the loop's reactor);
  - http_request_sync  — for SYNC call sites already running ON the loop
                         (the BackupContainer contract): pumps a private
                         reactor, never re-entering the running loop.
"""

from __future__ import annotations

import errno
import socket
from typing import Callable, Optional

from ..core.errors import ConnectionFailed, TimedOut
from ..core.runtime import Promise, current_loop


class HTTPResponse:
    def __init__(self, status: int, reason: str, headers: dict[str, str],
                 body: bytes):
        self.status = status
        self.reason = reason
        self.headers = headers
        self.body = body


def _build_request(method: str, host: str, path: str,
                   headers: Optional[dict], body: bytes) -> bytes:
    h = {"Host": host, "Content-Length": str(len(body)),
         "Connection": "close"}
    if headers:
        h.update(headers)
    lines = [f"{method} {path} HTTP/1.1"]
    lines += [f"{k}: {v}" for k, v in h.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _parse_head(raw: bytes) -> tuple[int, str, dict[str, str], int]:
    head, _, _rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    proto, _, rest = lines[0].partition(" ")
    if not proto.startswith("HTTP/"):
        raise ConnectionFailed(f"not an HTTP response: {lines[0]!r}")
    code_s, _, reason = rest.partition(" ")
    headers: dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    try:
        code = int(code_s)
    except ValueError:
        raise ConnectionFailed(f"bad HTTP status line: {lines[0]!r}")
    return code, reason, headers, len(head) + 4


class _Exchange:
    """One request/response over one connection, driven by reactor
    callbacks; completion (HTTPResponse or exception) goes to `sink`
    exactly once. EVERY callback is exception-contained: a malformed
    response fails THIS exchange, never the reactor loop around it."""

    def __init__(self, reactor, host: str, port: int, method: str,
                 path: str, headers: Optional[dict], body: bytes,
                 sink: Callable):
        self.reactor = reactor
        self.host, self.port = host, port
        self.label = f"{method} {host}:{port}{path}"
        self.out = _build_request(method, host, path, headers, body)
        self.buf = bytearray()  # O(1) appends: bodies arrive in 64K chunks
        self.head = None
        self.done = False
        self.sink = sink
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setblocking(False)

    def start(self) -> None:
        try:
            self.sock.connect((self.host, self.port))
        except BlockingIOError:
            pass
        except OSError as e:
            return self._finish(ConnectionFailed(str(e)))
        self.reactor.register_write(self.sock.fileno(), self._on_writable)

    def cancel(self, e: BaseException) -> None:
        self._finish(e)

    def _finish(self, outcome) -> None:
        if self.done:
            return
        self.done = True
        try:
            self.reactor.unregister(self.sock.fileno())
        except Exception:  # noqa: BLE001 - fd already closed
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.sink(outcome)

    def _on_writable(self) -> None:
        try:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                return self._finish(ConnectionFailed(
                    f"{self.label}: {errno.errorcode.get(err, err)}"
                ))
            try:
                n = self.sock.send(self.out)
            except (BlockingIOError, InterruptedError):
                return
            self.out = self.out[n:]
            if not self.out:
                self.reactor.unregister_write(self.sock.fileno())
                self.reactor.register_read(self.sock.fileno(),
                                           self._on_readable)
        except BaseException as e:  # noqa: BLE001 - contain to the exchange
            self._finish(e if isinstance(e, ConnectionFailed)
                         else ConnectionFailed(f"{self.label}: {e}"))

    def _on_readable(self) -> None:
        try:
            try:
                chunk = self.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            if chunk:
                self.buf.extend(chunk)
            if self.head is None and b"\r\n\r\n" in self.buf:
                self.head = _parse_head(bytes(self.buf))
                code, _reason, hdrs, _off = self.head
                if "chunked" in hdrs.get("transfer-encoding", "").lower() \
                        or ("content-length" not in hdrs and code != 204):
                    raise ConnectionFailed(
                        f"{self.label}: response without Content-Length "
                        "(chunked/close-delimited bodies unsupported)"
                    )
            if self.head is not None:
                code, reason, hdrs, off = self.head
                need = int(hdrs.get("content-length", 0))
                if len(self.buf) - off >= need:
                    return self._finish(HTTPResponse(
                        code, reason, hdrs, bytes(self.buf[off:off + need])
                    ))
            if not chunk:  # EOF before a complete response
                raise ConnectionFailed(
                    f"{self.label}: connection closed mid-response"
                )
        except BaseException as e:  # noqa: BLE001 - contain to the exchange
            self._finish(e if isinstance(e, ConnectionFailed)
                         else ConnectionFailed(f"{self.label}: {e}"))


async def http_request(host: str, port: int, method: str, path: str,
                       headers: Optional[dict] = None, body: bytes = b"",
                       timeout: float | None = None) -> HTTPResponse:
    """One HTTP exchange; resolves with the full response or raises
    ConnectionFailed/TimedOut. The default deadline is
    CLIENT_KNOBS.HTTP_REQUEST_TIMEOUT (randomized under sim)."""
    if timeout is None:
        from ..core.knobs import CLIENT_KNOBS

        timeout = CLIENT_KNOBS.HTTP_REQUEST_TIMEOUT
    loop = current_loop()
    reactor = getattr(loop, "reactor", None)
    if reactor is None:
        raise RuntimeError("http_request needs a real-clock loop+reactor")

    done: Promise = Promise()

    def sink(outcome) -> None:
        if done.is_set():
            return
        if isinstance(outcome, BaseException):
            done.send_error(outcome)
        else:
            done.send(outcome)

    ex = _Exchange(reactor, host, port, method, path, headers, body, sink)
    ex.start()

    from ..core.actors import timeout as with_timeout

    lost = object()
    got = await with_timeout(done.future, timeout, lost)
    if got is lost:
        ex.cancel(TimedOut(ex.label))
        raise TimedOut(f"HTTP {ex.label}")
    return got


class TextHTTPServer:
    """Minimal HTTP/1.0 text server on the loop's reactor (real tier
    only — the same machinery the client side of this module rides). One
    render callback serves every GET with a Content-Length'd body and
    `Connection: close` — exactly the exchange shape `http_request`
    above expects, and all a Prometheus scraper needs for the
    `--metrics-port` text exposition endpoint. Every callback is
    exception-contained: a malformed request fails ITS connection,
    never the reactor loop."""

    def __init__(self, port: int, render: Callable[[], str],
                 content_type: str = "text/plain", host: str = "0.0.0.0"):
        self.port = port
        self.host = host
        self.render = render
        self.content_type = content_type
        self.reactor = None
        self._sock: Optional[socket.socket] = None
        self._conns: dict[int, dict] = {}

    def start(self) -> "TextHTTPServer":
        loop = current_loop()
        reactor = getattr(loop, "reactor", None)
        if reactor is None:
            raise RuntimeError(
                "TextHTTPServer needs a real-clock loop+reactor "
                "(simulated clusters expose metrics via status json / "
                "MetricsRequest instead)"
            )
        self.reactor = reactor
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(16)
        s.setblocking(False)
        self.port = s.getsockname()[1]  # resolved ephemeral port
        self._sock = s
        reactor.register_read(s.fileno(), self._on_accept)
        return self

    def stop(self) -> None:
        for fd in list(self._conns):
            self._close(fd)
        if self._sock is not None:
            self.reactor.unregister(self._sock.fileno())
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _close(self, fd: int) -> None:
        st = self._conns.pop(fd, None)
        if st is None:
            return
        self.reactor.unregister(fd)
        try:
            st["conn"].close()
        except OSError:
            pass

    def _on_accept(self) -> None:
        try:
            conn, _addr = self._sock.accept()
        except (BlockingIOError, InterruptedError, OSError):
            return
        conn.setblocking(False)
        fd = conn.fileno()
        st = {"conn": conn, "buf": bytearray(), "out": b""}
        self._conns[fd] = st
        self.reactor.register_read(fd, lambda: self._on_read(fd))

    def _respond(self, st: dict) -> bytes:
        head = bytes(st["buf"]).split(b"\r\n", 1)[0].decode(
            "latin-1", "replace"
        )
        parts = head.split()
        if len(parts) < 2 or parts[0] not in ("GET", "HEAD"):
            body = b"method not allowed\n"
            status = "405 Method Not Allowed"
            ctype = "text/plain"
        else:
            try:
                body = self.render().encode()
                status = "200 OK"
                ctype = self.content_type
            except Exception as e:  # noqa: BLE001 - contain to the request
                body = f"render failed: {type(e).__name__}: {e}\n".encode()
                status = "500 Internal Server Error"
                ctype = "text/plain"
        if parts and parts[0] == "HEAD":
            payload = b""
        else:
            payload = body
        return (
            f"HTTP/1.0 {status}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode() + payload

    def _on_read(self, fd: int) -> None:
        st = self._conns.get(fd)
        if st is None:
            return
        try:
            try:
                chunk = st["conn"].recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                return
            if chunk:
                st["buf"].extend(chunk)
            if b"\r\n\r\n" in st["buf"] or not chunk:
                st["out"] = self._respond(st)
                self.reactor.unregister_read(fd)
                self.reactor.register_write(fd, lambda: self._on_write(fd))
        except BaseException:  # noqa: BLE001 - contain to the connection
            self._close(fd)

    def _on_write(self, fd: int) -> None:
        st = self._conns.get(fd)
        if st is None:
            return
        try:
            try:
                n = st["conn"].send(st["out"])
            except (BlockingIOError, InterruptedError):
                return
            st["out"] = st["out"][n:]
            if not st["out"]:
                self._close(fd)
        except BaseException:  # noqa: BLE001 - contain to the connection
            self._close(fd)


def http_request_sync(host: str, port: int, method: str, path: str,
                      headers: Optional[dict] = None, body: bytes = b"",
                      timeout: float | None = None) -> HTTPResponse:
    """Synchronous form: drives its OWN private reactor to completion.
    The outer loop's timers simply wait — container ops are short and the
    caller is blocked on them anyway (long-running shipping should use
    the async form)."""
    import time as _time

    from .reactor import SelectReactor

    if timeout is None:
        from ..core.knobs import CLIENT_KNOBS

        timeout = CLIENT_KNOBS.HTTP_REQUEST_TIMEOUT
    reactor = SelectReactor()
    result: list = []
    ex = _Exchange(reactor, host, port, method, path, headers, body,
                   result.append)
    ex.start()
    # fdblint: allow[det-wall-clock] -- http_request_sync drives its own private SelectReactor on the calling OS thread (real-clock tier by construction); the sim tier uses the async form through the loop's timers.
    deadline = _time.monotonic() + timeout
    while not result:
        # fdblint: allow[det-wall-clock] -- same private-reactor deadline as above; unreachable from a simulated loop.
        if _time.monotonic() > deadline:
            ex.cancel(TimedOut(ex.label))
            raise TimedOut(f"HTTP {ex.label}")
        reactor.poll(0.05)
    if isinstance(result[0], BaseException):
        raise result[0]
    return result[0]
