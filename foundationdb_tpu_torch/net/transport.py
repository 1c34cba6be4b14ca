"""Typed RPC over real TCP (ref: fdbrpc/FlowTransport.actor.cpp).

Endpoints are (address, 64-bit token) pairs, exactly the reference's
addressing (fdbrpc/FlowTransport.h:64). A process creates one
`FlowTransport`, registers request streams under tokens, and hands
`TransportStream(addr, token)` handles to clients — the same `.send(req)`
duck type as the in-process PromiseStream and the sim RemoteStream, so
role code is transport-agnostic.

Wire behavior mirroring the reference:

- framing: [u32 length][u32 crc32c][payload], checksum verified on every
  frame (scanPackets, FlowTransport.actor.cpp:463-523);
- reply framing: small replies bound for one connection coalesce into a
  single kind=2 multi-reply frame per flush window
  (SERVER_KNOBS.REPLY_FRAME_INTERVAL / REPLY_FRAME_BYTES) — the
  reply-side mirror of the client's CommitWireBatch request coalescing:
  N GRV/read replies pay one frame + one crc + one send instead of N.
  INTERVAL 0 restores the one-frame-per-reply plane (set it when
  rolling a mixed-version cluster whose older binaries predate kind=2);
- the first frame on every connection is a ConnectPacket carrying the
  protocol version + the sender's canonical listen address (:196-210);
  version-incompatible peers are disconnected;
- serializing a request's reply Promise registers a one-shot local reply
  endpoint whose token travels with the request; the remote side's
  resolution of `req.reply` sends the value back to that token
  (networkSender, fdbrpc/fdbrpc.h:146-157);
- requests are reliable-until-connection-loss (FlowTransport.h:96-105):
  on disconnect every reply pending on that peer fails with
  ConnectionFailed, and the peer's connectionKeeper reconnects with
  backoff while traffic remains queued (:355).

TLS: pass an `ssl.SSLContext` pair via `tls_server`/`tls_client` to wrap
accepted/initiated sockets (ref: fdbrpc/TLSConnection.actor.cpp wrapping
any IConnection; FDBLibTLS/ builds the contexts — see net/tls.py).
"""

from __future__ import annotations

import errno
import socket
import ssl as _ssl
import struct
from typing import Optional

from ..core.errors import ConnectionFailed
from ..core.runtime import Promise, TaskPriority, current_loop, spawn
from ..core.serialize import (
    BinaryReader,
    BinaryWriter,
    ProtocolVersionMismatch,
    WIRE_FORMAT,
    crc32c,
    decode_value,
    encode_value,
)
from ..core.trace import TraceEvent

_MAX_FRAME = 64 << 20

# Well-known tokens (ref: WLTOKEN_* reserved endpoints, FlowTransport.h:109).
WLTOKEN_PING = 1
WLTOKEN_ENDPOINT_BASE = 100


def _frame(payload: bytes) -> bytes:
    return struct.pack("<II", len(payload), crc32c(payload)) + payload


class _Connection:
    """One TCP connection with read buffer + write backlog."""

    def __init__(self, transport: "FlowTransport", sock: socket.socket,
                 peer_hint: str = ""):
        self.transport = transport
        self.sock = sock
        self.fd = sock.fileno()
        self.peer_addr: Optional[str] = None  # canonical, from ConnectPacket
        self.peer_hint = peer_hint
        self._rbuf = bytearray()
        self._wbuf = bytearray()
        self._sent_connect = False
        self._got_connect = False
        self._closed = False
        # Reply-frame coalescing window (FlowTransport._send_reply).
        self._reply_buf: list[bytes] = []
        self._reply_bytes = 0
        self._reply_flush_armed = False

    # -- writing --
    def send_frame(self, payload: bytes) -> None:
        if self._closed:
            return
        if not self._sent_connect:
            self._sent_connect = True
            w = BinaryWriter()
            w.raw(b"FDBTPU\x00\x01")
            # Negotiated path ONLY: the lattice's current revision, never
            # a raw PROTOCOL_VERSION literal (fdblint enforces this).
            w.write_protocol_version().string(self.transport.local_address)
            self._wbuf += _frame(w.to_bytes())
        self._wbuf += _frame(payload)
        self._flush()

    def _flush(self) -> None:
        while self._wbuf:
            try:
                n = self.sock.send(self._wbuf)
            except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError):
                break
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                self.close(f"send: {e}")
                return
            if n <= 0:
                break
            self.transport._count_io(self, sent=n)
            del self._wbuf[:n]
        reactor = self.transport.reactor
        if self._wbuf and not self._closed:
            reactor.register_write(self.fd, self._flush)
        else:
            reactor.unregister_write(self.fd)

    # -- reading --
    def on_readable(self) -> None:
        try:
            while True:
                chunk = self.sock.recv(1 << 16)
                if chunk == b"":
                    self.close("peer closed")
                    return
                self.transport._count_io(self, received=len(chunk))
                self._rbuf += chunk
                if len(chunk) < (1 << 16):
                    break
        except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError):
            pass
        except OSError as e:
            if e.errno not in (errno.EAGAIN, errno.EWOULDBLOCK):
                self.close(f"recv: {e}")
                return
        self._parse()

    def _parse(self) -> None:
        while True:
            if len(self._rbuf) < 8:
                return
            length, crc = struct.unpack_from("<II", self._rbuf)
            if length > _MAX_FRAME:
                self.close(f"oversized frame {length}")
                return
            if len(self._rbuf) < 8 + length:
                return
            payload = bytes(self._rbuf[8 : 8 + length])
            del self._rbuf[: 8 + length]
            if crc32c(payload) != crc:
                TraceEvent("PacketChecksumError", severity=30).detail(
                    "Peer", self.peer_addr or self.peer_hint
                ).log()
                self.close("checksum mismatch")
                return
            if not self._got_connect:
                if not self._handle_connect_packet(payload):
                    return
                continue
            self.transport._dispatch(payload, self)

    def _handle_connect_packet(self, payload: bytes) -> bool:
        r = BinaryReader(payload)
        magic = r.raw(8)
        if magic != b"FDBTPU\x00\x01":
            self.close("bad connect magic")
            return False
        try:
            ver = WIRE_FORMAT.check_wire(
                r.u64(), where=self.peer_addr or self.peer_hint
            )
        except ProtocolVersionMismatch as e:
            # Typed (1109) + COUNTED per connection: operators see skew
            # in status json instead of a silent reconnect loop.
            peer = self.peer_addr or self.peer_hint
            self.transport.incompatible_connections += 1
            self.transport.incompatible_peers[peer] = (
                self.transport.incompatible_peers.get(peer, 0) + 1
            )
            TraceEvent("ConnectionRejected", severity=30).detail(
                "Reason", "IncompatibleProtocolVersion"
            ).detail("Peer", peer).detail("Error", str(e)).log()
            self.close("protocol mismatch")
            return False
        self.peer_addr = r.string()
        self._got_connect = True
        self.transport._adopt(self)
        return True

    def close(self, reason: str = "") -> None:
        if self._closed:
            return
        self._closed = True
        self.transport.reactor.unregister(self.fd)
        try:
            self.sock.close()
        except OSError:
            pass
        self.transport._on_connection_closed(self, reason)


class Peer:
    """Outgoing-traffic state for one remote address (ref: Peer,
    FlowTransport.actor.cpp:217; connectionKeeper :355)."""

    def __init__(self, transport: "FlowTransport", addr: str):
        self.transport = transport
        self.addr = addr
        self.conn: Optional[_Connection] = None
        self.queue: list[bytes] = []
        self.reconnect_delay = 0.05
        self._connecting = False

    def send(self, payload: bytes) -> None:
        if self.conn is not None and not self.conn._closed:
            self.conn.send_frame(payload)
            return
        self.queue.append(payload)
        self._ensure_connecting()

    def _ensure_connecting(self) -> None:
        if self._connecting:
            return
        self._connecting = True

        async def keeper():
            try:
                conn = await self.transport._connect(self.addr)
            except OSError as e:
                self._connecting = False
                TraceEvent("ConnectionFailed", severity=30).detail(
                    "Peer", self.addr
                ).detail("Error", str(e)).log()
                self.transport._fail_pending_to(self.addr)
                self.queue.clear()
                return
            self._connecting = False
            self.conn = conn
            queued, self.queue = self.queue, []
            for p in queued:
                conn.send_frame(p)

        spawn(keeper(), TaskPriority.DEFAULT, name=f"connectionKeeper:{self.addr}")

    def on_closed(self) -> None:
        self.conn = None


class TransportStream:
    """Client handle to a remote endpoint; same duck type as PromiseStream
    /sim RemoteStream (ref: RequestStream, fdbrpc/fdbrpc.h:212)."""

    def __init__(self, transport: "FlowTransport", addr: str, token: int):
        self.transport = transport
        self.addr = addr
        self.token = token

    def send(self, req) -> None:
        self.transport._send_request(self.addr, self.token, req)


class FlowTransport:
    def __init__(self, reactor, host: str = "127.0.0.1", port: int = 0,
                 tls_server: Optional[_ssl.SSLContext] = None,
                 tls_client: Optional[_ssl.SSLContext] = None):
        self.reactor = reactor
        self.tls_server = tls_server
        self.tls_client = tls_client
        self._endpoints: dict[int, object] = {}  # token -> PromiseStream-like
        self._pending_replies: dict[int, tuple[Promise, str]] = {}
        self._next_token = WLTOKEN_ENDPOINT_BASE
        self._next_reply_token = 1 << 32
        self._peers: dict[str, Peer] = {}
        self._conns: list[_Connection] = []
        # Protocol-skew observability (ref: the reference counting
        # incompatible connections for status): total rejections plus a
        # per-peer breakdown, surfaced by multiprocess_status.
        self.incompatible_connections = 0
        self.incompatible_peers: dict[str, int] = {}
        # Traffic counters in the process metric registry (core/metrics):
        # process totals plus a per-peer breakdown keyed by CANONICAL
        # peer address — counters persist across reconnects (a dict, not
        # per-_Connection state), so `cli top` and the bench scrape see
        # cumulative bytes, and peer cardinality is bounded by cluster
        # size, not connection churn.
        from ..core.stats import Counter

        self.bytes_in = Counter("transport.bytes_in")
        self.bytes_out = Counter("transport.bytes_out")
        self.replies_framed = Counter("transport.replies_framed")
        self._peer_io: dict[str, tuple] = {}
        self._metrics_registered = False

        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self._lsock.setblocking(False)
        h, p = self._lsock.getsockname()
        self.local_address = f"{h}:{p}"
        reactor.register_read(self._lsock.fileno(), self._on_accept)

    # -- endpoint registry --
    def register_endpoint(self, stream, token: Optional[int] = None) -> int:
        if token is None:
            token = self._next_token
            self._next_token += 1
        self._endpoints[token] = stream
        return token

    def unregister_endpoint(self, token: int) -> None:
        self._endpoints.pop(token, None)

    def remote_stream(self, addr: str, token: int) -> TransportStream:
        return TransportStream(self, addr, token)

    def close(self) -> None:
        self.reactor.unregister(self._lsock.fileno())
        self._lsock.close()
        for c in list(self._conns):
            c.close("transport shutdown")
        for p in self._peers.values():
            p.queue.clear()

    # -- accept/connect --
    def _on_accept(self) -> None:
        while True:
            try:
                sock, addr = self._lsock.accept()
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return
                raise
            if self.tls_server is not None:
                sock = self.tls_server.wrap_socket(
                    sock, server_side=True, do_handshake_on_connect=False
                )
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(self, sock, peer_hint=f"{addr[0]}:{addr[1]}")
            self._conns.append(conn)
            self.reactor.register_read(conn.fd, conn.on_readable)

    async def _connect(self, addr: str) -> _Connection:
        host, port_s = addr.rsplit(":", 1)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.connect((host, int(port_s)))
        except BlockingIOError:
            pass
        # Wait for writability = connected (or refused).
        done = Promise()
        self.reactor.register_write(sock.fileno(), lambda: (
            not done.is_set() and done.send(None)
        ))
        try:
            await done.future
        finally:
            self.reactor.unregister_write(sock.fileno())
        err = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err:
            sock.close()
            raise OSError(err, f"connect to {addr} failed")
        if self.tls_client is not None:
            host_only = host
            sock = self.tls_client.wrap_socket(
                sock, server_hostname=host_only,
                do_handshake_on_connect=False,
            )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Connection(self, sock, peer_hint=addr)
        conn.peer_addr = addr  # canonical: we dialed the listen address
        self._conns.append(conn)
        self.reactor.register_read(conn.fd, conn.on_readable)
        return conn

    def _adopt(self, conn: _Connection) -> None:
        """Accepted connection identified itself: future sends to that peer
        reuse it (the reference keeps one connection per peer pair)."""
        peer = self._peers.get(conn.peer_addr)
        if peer is not None and peer.conn is None:
            peer.conn = conn

    # -- request/reply --
    def _send_request(self, addr: str, token: int, req) -> None:
        reply_token = 0
        if getattr(req, "reply", None) is not None:
            reply_token = self._next_reply_token
            self._next_reply_token += 1
            self._pending_replies[reply_token] = (req.reply, addr)
        w = BinaryWriter()
        w.u8(0)  # request
        w.u64(token).u64(reply_token).string(self.local_address)
        encode_value(w, req)
        self._peer(addr).send(w.to_bytes())

    def _peer(self, addr: str) -> Peer:
        peer = self._peers.get(addr)
        if peer is None:
            peer = self._peers[addr] = Peer(self, addr)
        return peer

    def _ensure_metrics(self) -> bool:
        """Register the traffic counters once a loop is current (the
        registry is loop-scoped; the transport is constructed before the
        role host's loop runs)."""
        if self._metrics_registered:
            return True
        try:
            from ..core.metrics import global_registry

            reg = global_registry()
        except RuntimeError:
            return False  # no current loop yet: totals still accumulate
        reg.register_counter("transport.bytes_in", self.bytes_in,
                             replace=True)
        reg.register_counter("transport.bytes_out", self.bytes_out,
                             replace=True)
        reg.register_counter("transport.replies_framed",
                             self.replies_framed, replace=True)
        self._metrics_registered = True
        return True

    def _count_io(self, conn: _Connection, sent: int = 0,
                  received: int = 0) -> None:
        if sent:
            self.bytes_out.add(sent)
        if received:
            self.bytes_in.add(received)
        addr = conn.peer_addr
        if addr is None:
            return  # pre-ConnectPacket traffic: totals only
        pair = self._peer_io.get(addr)
        if pair is None:
            if not self._ensure_metrics():
                return
            from ..core.metrics import global_registry
            from ..core.stats import Counter

            cin = Counter("transport.peer.bytes_in")
            cout = Counter("transport.peer.bytes_out")
            reg = global_registry()
            reg.register_counter("transport.peer.bytes_in", cin,
                                 labels=(("peer", addr),), replace=True)
            reg.register_counter("transport.peer.bytes_out", cout,
                                 labels=(("peer", addr),), replace=True)
            pair = self._peer_io[addr] = (cin, cout)
        if sent:
            pair[1].add(sent)
        if received:
            pair[0].add(received)

    def _dispatch(self, payload: bytes, conn: _Connection) -> None:
        r = BinaryReader(payload)
        kind = r.u8()
        if kind == 0:
            self._dispatch_request(r, conn)
        elif kind == 1:
            self._dispatch_reply(r)
        elif kind == 2:
            # Reply frame: N length-prefixed kind-1 sub-messages
            # coalesced into one wire frame (_flush_replies).
            for _ in range(r.u32()):
                sub = BinaryReader(r.bytes_())
                if sub.u8() != 1:
                    conn.close("bad sub-message in reply frame")
                    return
                self._dispatch_reply(sub)
        else:
            conn.close(f"bad message kind {kind}")

    def _dispatch_request(self, r: BinaryReader, conn: _Connection) -> None:
        token, reply_token = r.u64(), r.u64()
        src_addr = r.string()
        try:
            req = decode_value(r)
        except Exception as e:  # noqa: BLE001 — malformed payloads drop conn
            conn.close(f"decode error: {e}")
            return
        stream = self._endpoints.get(token)
        if stream is None:
            # Unknown endpoint: reply with an error so callers fail fast
            # (the reference drops these; failing fast aids debugging).
            if reply_token:
                self._send_reply(conn, src_addr, reply_token,
                                 ConnectionFailed("unknown endpoint"), True)
            return
        if reply_token:
            req.reply = Promise()
            req.reply.future.add_callback(
                lambda f: self._send_reply(
                    conn, src_addr, reply_token,
                    f._value, f.is_error(),
                )
            )
        stream.send(req)

    def _send_reply(self, conn: _Connection, addr: str, reply_token: int,
                    value, is_error: bool) -> None:
        w = BinaryWriter()
        w.u8(1)
        w.u64(reply_token).u8(1 if is_error else 0)
        if is_error and not isinstance(value, BaseException):
            value = ConnectionFailed(str(value))
        encode_value(w, value)
        # Reply on the ORIGINATING connection when it is still up (the
        # reference answers on the same TCP stream; it also lets
        # listener-less clients — the C wire client — receive replies),
        # falling back to a dialed peer connection only if it died.
        if conn is not None and not conn._closed:
            self._queue_reply(conn, w.to_bytes())
        elif addr and not addr.startswith("0.0.0.0:"):
            self._peer(addr).send(w.to_bytes())
        # else: the source never advertised a real listen address
        # (listener-less wire client) and its connection is gone — the
        # reply has nowhere to go; reliable-until-connection-loss says
        # drop it.

    def _queue_reply(self, conn: _Connection, payload: bytes) -> None:
        """Coalesce small replies per connection into one kind=2 frame
        per flush window (the reply-side mirror of the client's commit
        coalescer). Oversized replies and INTERVAL=0 bypass: one frame
        per reply, the pre-framing plane."""
        from ..core.knobs import SERVER_KNOBS

        interval = SERVER_KNOBS.REPLY_FRAME_INTERVAL
        budget = SERVER_KNOBS.REPLY_FRAME_BYTES
        if interval <= 0 or len(payload) >= budget:
            conn.send_frame(payload)
            return
        conn._reply_buf.append(payload)
        conn._reply_bytes += len(payload)
        if conn._reply_bytes >= budget:
            self._flush_replies(conn)
            return
        if conn._reply_flush_armed:
            return
        conn._reply_flush_armed = True

        async def flush_later():
            await current_loop().delay(interval)
            conn._reply_flush_armed = False
            self._flush_replies(conn)

        spawn(flush_later(), TaskPriority.DEFAULT, name="replyFrameFlush")

    def _flush_replies(self, conn: _Connection) -> None:
        buf, conn._reply_buf = conn._reply_buf, []
        conn._reply_bytes = 0
        if not buf or conn._closed:
            # Connection died with replies buffered: reliable-until-
            # connection-loss — the requester's pending promise already
            # failed with ConnectionFailed; drop them.
            return
        if len(buf) == 1:
            conn.send_frame(buf[0])
            return
        w = BinaryWriter()
        w.u8(2).u32(len(buf))
        for p in buf:
            w.bytes_(p)
        conn.send_frame(w.to_bytes())
        self.replies_framed.add(len(buf))

    def _dispatch_reply(self, r: BinaryReader) -> None:
        reply_token, is_err = r.u64(), r.u8()
        value = decode_value(r)
        entry = self._pending_replies.pop(reply_token, None)
        if entry is None:
            return  # late reply after disconnect-failure; drop
        promise, _ = entry
        if promise.is_set():
            return
        if is_err:
            promise.send_error(value)
        else:
            promise.send(value)

    # -- failure propagation --
    def _on_connection_closed(self, conn: _Connection, reason: str) -> None:
        if conn in self._conns:
            self._conns.remove(conn)
        addr = conn.peer_addr
        TraceEvent("ConnectionClosed").detail("Peer", addr or conn.peer_hint
                                              ).detail("Reason", reason).log()
        if addr is not None:
            peer = self._peers.get(addr)
            if peer is not None and peer.conn is conn:
                peer.on_closed()
            self._fail_pending_to(addr)

    def _fail_pending_to(self, addr: str) -> None:
        """Reliable-until-connection-loss: break every reply waiting on
        that peer (ref: Peer::discardUnreliablePackets + broken_promise on
        disconnect)."""
        for tok in [t for t, (_, a) in self._pending_replies.items()
                    if a == addr]:
            promise, _ = self._pending_replies.pop(tok)
            if not promise.is_set():
                promise.send_error(ConnectionFailed(addr))


def real_loop_with_transport(host: str = "127.0.0.1", port: int = 0):
    """Convenience: a real-clock EventLoop wired to a reactor + transport."""
    from ..core.runtime import EventLoop
    from .reactor import SelectReactor

    loop = EventLoop()
    reactor = SelectReactor()
    loop.reactor = reactor
    transport = FlowTransport(reactor, host, port)
    return loop, transport
