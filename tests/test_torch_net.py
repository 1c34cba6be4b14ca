"""The port's real network tier (foundationdb_tpu_torch/net): every case of
tests/test_net_transport.py on the port's codec and FlowTransport over
real loopback sockets, and byte parity of the wire: for each message type
of the multi-process tier (cluster/multiprocess.py) and the commit wire,
the same field values framed by the port's net/transport._frame give the
same bytes as the JAX package's."""

import dataclasses
import struct

import pytest

from foundationdb_tpu_torch.cluster.interfaces import (
    CommitTransactionRequest,
    GetValueRequest,
    Mutation,
)
from foundationdb_tpu_torch.core import loop_context
from foundationdb_tpu_torch.core.actors import (
    PromiseStream,
    serve_requests,
    timeout_error,
)
from foundationdb_tpu_torch.core.errors import ConnectionFailed, NotCommitted
from foundationdb_tpu_torch.core.runtime import TaskPriority
from foundationdb_tpu_torch.core.serialize import (
    BinaryReader,
    BinaryWriter,
    ProtocolVersionMismatch,
    crc32c,
    decode_message,
    encode_message,
)
from foundationdb_tpu_torch.kv.atomic import MutationType
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.net import real_loop_with_transport

from _torch_mp import JAX, PORT, mod


# ---------------- serialization ----------------

def test_binary_writer_reader_roundtrip():
    w = BinaryWriter()
    w.write_protocol_version()
    w.u8(7).u32(1 << 30).i64(-5).u64(1 << 60).f64(2.5)
    w.bytes_(b"\x00\xff").string("héllo")
    r = BinaryReader(w.to_bytes())
    r.check_protocol_version()
    assert r.u8() == 7
    assert r.u32() == 1 << 30
    assert r.i64() == -5
    assert r.u64() == 1 << 60
    assert r.f64() == 2.5
    assert r.bytes_() == b"\x00\xff"
    assert r.string() == "héllo"
    assert r.empty()


def test_protocol_version_mismatch_rejected():
    w = BinaryWriter()
    w.u64(0xDEAD00)
    with pytest.raises(ProtocolVersionMismatch):
        BinaryReader(w.to_bytes()).check_protocol_version()


def test_message_roundtrip_preserves_everything_but_reply():
    req = CommitTransactionRequest(
        read_snapshot=42,
        read_conflict_ranges=[KeyRange(b"a", b"b\x00")],
        write_conflict_ranges=(KeyRange(b"c", b"d"),),
        mutations=[Mutation(MutationType.ADD_VALUE, b"k", b"\x01")],
    )
    out = decode_message(encode_message(req))
    assert out.read_snapshot == 42
    assert list(out.read_conflict_ranges) == [KeyRange(b"a", b"b\x00")]
    assert out.mutations[0].type == MutationType.ADD_VALUE
    assert out.reply is not req.reply  # fresh promise, never serialized


def test_error_values_cross_the_codec():
    err = decode_message(encode_message(NotCommitted("boom")))
    assert isinstance(err, NotCommitted)
    assert err.code == 1020


def test_crc32c_known_vectors():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA


# ---------------- transport over real sockets ----------------

def _kv_server(transport):
    """Register a tiny kv endpoint; returns (token, dict)."""
    data = {b"hello": b"world"}
    stream = PromiseStream()

    async def handle(req):
        if isinstance(req, GetValueRequest):
            return data.get(req.key)
        if isinstance(req, CommitTransactionRequest):
            if req.read_snapshot < 0:
                raise NotCommitted()
            for m in req.mutations:
                data[m.param1] = m.param2
            return len(data)
        raise TypeError(type(req))

    serve_requests(stream, handle, TaskPriority.DEFAULT, "kv")
    token = transport.register_endpoint(stream)
    return token, data


def test_request_reply_over_real_sockets():
    loop, t_client = real_loop_with_transport()
    with loop_context(loop):
        from foundationdb_tpu_torch.net import FlowTransport

        t_server = FlowTransport(loop.reactor)
        token, data = _kv_server(t_server)
        remote = t_client.remote_stream(t_server.local_address, token)

        async def main():
            req = GetValueRequest(key=b"hello", version=1)
            remote.send(req)
            assert await timeout_error(req.reply.future, 5.0) == b"world"
            big = bytes(range(256)) * 1024  # 256 KB: framing
            c = CommitTransactionRequest(
                read_snapshot=1, read_conflict_ranges=(),
                write_conflict_ranges=(),
                mutations=[Mutation(MutationType.SET_VALUE, b"big", big)],
            )
            remote.send(c)
            assert await timeout_error(c.reply.future, 5.0) == 2
            assert data[b"big"] == big
            bad = CommitTransactionRequest(
                read_snapshot=-1, read_conflict_ranges=(),
                write_conflict_ranges=(), mutations=(),
            )
            remote.send(bad)
            with pytest.raises(NotCommitted):
                await timeout_error(bad.reply.future, 5.0)

        loop.run(main(), timeout_sim_seconds=30.0)
        t_server.close()
        t_client.close()


@pytest.mark.parametrize("interval", [0.002, 0.0])
def test_reply_framing_coalesces_and_knob_disables(interval, monkeypatch):
    """With REPLY_FRAME_INTERVAL on, a burst of small replies coalesces
    into kind=2 frames and every reply lands; at 0 framing is off. The
    byte counters account the traffic either way."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS

    monkeypatch.setattr(SERVER_KNOBS, "REPLY_FRAME_INTERVAL", interval)
    loop, t_client = real_loop_with_transport()
    with loop_context(loop):
        from foundationdb_tpu_torch.net import FlowTransport

        t_server = FlowTransport(loop.reactor)
        token, _data = _kv_server(t_server)
        remote = t_client.remote_stream(t_server.local_address, token)

        async def main():
            reqs = [GetValueRequest(key=b"hello", version=i)
                    for i in range(64)]
            for r in reqs:
                remote.send(r)
            for r in reqs:
                assert await timeout_error(r.reply.future, 5.0) == b"world"

        loop.run(main(), timeout_sim_seconds=30.0)
        framed = t_server.replies_framed.total
        assert t_server.bytes_in.total > 0
        assert t_server.bytes_out.total > 0
        assert t_client.bytes_in.total > 0
        t_server.close()
        t_client.close()
    if interval > 0:
        assert framed > 0
    else:
        assert framed == 0


def test_reply_frame_bytes_budget_bypasses_oversized(monkeypatch):
    """A reply at or over REPLY_FRAME_BYTES goes out bare at once."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS

    monkeypatch.setattr(SERVER_KNOBS, "REPLY_FRAME_INTERVAL", 0.002)
    monkeypatch.setattr(SERVER_KNOBS, "REPLY_FRAME_BYTES", 64)
    loop, t_client = real_loop_with_transport()
    with loop_context(loop):
        from foundationdb_tpu_torch.net import FlowTransport

        t_server = FlowTransport(loop.reactor)
        token, data = _kv_server(t_server)
        data[b"big"] = b"x" * 4096
        remote = t_client.remote_stream(t_server.local_address, token)

        async def main():
            req = GetValueRequest(key=b"big", version=1)
            remote.send(req)
            assert await timeout_error(req.reply.future, 5.0) == b"x" * 4096

        loop.run(main(), timeout_sim_seconds=30.0)
        t_server.close()
        t_client.close()


def test_connection_refused_fails_pending_replies():
    loop, t_client = real_loop_with_transport()
    with loop_context(loop):
        import socket

        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
        remote = t_client.remote_stream(dead, 42)

        async def main():
            req = GetValueRequest(key=b"x", version=1)
            remote.send(req)
            with pytest.raises(ConnectionFailed):
                await timeout_error(req.reply.future, 5.0)

        loop.run(main(), timeout_sim_seconds=30.0)
        t_client.close()


def test_corrupt_frame_drops_connection():
    """A checksum-failing frame closes the connection, never crashes or
    delivers garbage."""
    loop, t_server = real_loop_with_transport()
    with loop_context(loop):
        token, data = _kv_server(t_server)
        import socket

        async def main():
            host, port = t_server.local_address.rsplit(":", 1)
            # fdblint: allow[async-blocking] -- deliberately opens a raw blocking socket to inject a corrupt frame at the real transport server; localhost connect, test-only.
            raw = socket.create_connection((host, int(port)))
            payload = b"garbage-payload"
            raw.sendall(struct.pack("<II", len(payload), 12345) + payload)
            from foundationdb_tpu_torch.core import delay

            await delay(0.2)
            raw.settimeout(1.0)
            assert raw.recv(1) == b""
            raw.close()

        loop.run(main(), timeout_sim_seconds=30.0)
        t_server.close()


def test_tls_request_reply(tmp_path):
    """A TLS transport pair (the openssl CLI mints the test cert)."""
    import shutil
    import subprocess

    if shutil.which("openssl") is None:
        pytest.skip("no openssl CLI to mint test certs")
    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1"],
        check=True, capture_output=True,
    )
    from foundationdb_tpu_torch.core.runtime import EventLoop
    from foundationdb_tpu_torch.net import FlowTransport, SelectReactor
    from foundationdb_tpu_torch.net.tls import client_context, server_context

    loop = EventLoop()
    loop.reactor = SelectReactor()
    with loop_context(loop):
        t_server = FlowTransport(
            loop.reactor,
            tls_server=server_context(str(cert), str(key),
                                      require_client_cert=False),
        )
        t_client = FlowTransport(
            loop.reactor, tls_client=client_context(ca_path=str(cert))
        )
        token, data = _kv_server(t_server)
        remote = t_client.remote_stream(t_server.local_address, token)

        async def main():
            req = GetValueRequest(key=b"hello", version=1)
            remote.send(req)
            assert await timeout_error(req.reply.future, 10.0) == b"world"

        loop.run(main(), timeout_sim_seconds=60.0)
        t_server.close()
        t_client.close()


# ---------------- byte parity with the JAX package ----------------

# The multi-process tier's role-to-role messages (multiprocess.py :70-245)
# and the commit wire's envelope.
MP_MESSAGES = (
    "TLogPeekRequest", "TLogPopRequest", "TLogLockRequest",
    "TLogTruncateRequest", "TLogSkipToRequest", "InitResolversRequest",
    "ResolverSkipWindowRequest", "ResolverStatusRequest",
    "ResolveBatchReply", "TLogHostDurableRequest", "TLogConfirmEpochRequest",
    "TLogStatusRequest", "StorageRollbackRequest", "StorageStatusRequest",
    "TraceEventsRequest", "MetricsRequest", "TxnStatusRequest",
)


def _value_for(f: dataclasses.Field, i: int):
    """A field value both packages encode: by the annotation's text."""
    t = str(f.type)
    if f.name == "reply":
        return None
    if "Optional[str]" in t or t == "str":
        return f"{f.name}-{i}"
    if t == "bool":
        return bool(i % 2)
    if t == "int":
        return (i + 1) * 1_000_003 + len(f.name)
    if t == "tuple":
        return (i, 1 << 40, -3)
    raise AssertionError(f"no test value for {f.name}: {t}")


def _framed(pkg: str, token: int, reply_token: int, msg) -> bytes:
    """A request envelope as FlowTransport._send_request builds it, framed
    by that package's net/transport._frame."""
    ser = mod(pkg, "core.serialize")
    w = ser.BinaryWriter()
    w.u8(0)
    w.u64(token).u64(reply_token).string("127.0.0.1:4500")
    ser.encode_value(w, msg)
    return mod(pkg, "net.transport")._frame(w.to_bytes())


def _build(pkg: str, name: str, i: int):
    cls = getattr(mod(pkg, "cluster.multiprocess"), name)
    kw = {f.name: _value_for(f, i) for f in dataclasses.fields(cls)
          if f.name != "reply"}
    return cls(**kw)


@pytest.mark.parametrize("name", MP_MESSAGES)
def test_multiprocess_message_frames_equal_the_jax_package(name):
    i = MP_MESSAGES.index(name)
    token = 500 + i
    port_bytes = _framed(PORT, token, (1 << 32) + i, _build(PORT, name, i))
    jax_bytes = _framed(JAX, token, (1 << 32) + i, _build(JAX, name, i))
    assert port_bytes == jax_bytes
    # and the port decodes the JAX package's frame into the same fields
    n, crc = struct.unpack("<II", jax_bytes[:8])
    assert len(jax_bytes) == 8 + n and crc == crc32c(jax_bytes[8:])
    from foundationdb_tpu_torch.core.serialize import decode_value

    r = BinaryReader(jax_bytes[8:])
    assert (r.u8(), r.u64(), r.u64(), r.string()) == (
        0, token, (1 << 32) + i, "127.0.0.1:4500")
    got = decode_value(r)
    want = _build(PORT, name, i)
    assert type(got) is type(want)
    for f in dataclasses.fields(want):
        if f.name != "reply":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def _commit_reqs(pkg: str) -> list:
    itf = mod(pkg, "cluster.interfaces")
    MT = mod(pkg, "kv.atomic").MutationType
    KR = mod(pkg, "kv.keys").KeyRange
    return [
        itf.CommitTransactionRequest(
            read_snapshot=100 + t,
            read_conflict_ranges=[KR(b"r%d" % t, b"r%d\x00" % t)],
            write_conflict_ranges=[KR(b"w%d" % t, b"w%d\x00" % t)],
            mutations=[itf.Mutation(MT.SET_VALUE, b"w%d" % t, b"v" * t),
                       itf.Mutation(MT.CLEAR_RANGE, b"a", b"b")],
        )
        for t in range(5)
    ]


def _tagged(pkg: str) -> list:
    itf = mod(pkg, "cluster.interfaces")
    TM = mod(pkg, "cluster.log_system").TaggedMutation
    MT = mod(pkg, "kv.atomic").MutationType
    return [TM((t, t + 1), itf.Mutation(MT.SET_VALUE, b"k%d" % t, b"x"))
            for t in range(4)]


@pytest.mark.parametrize("what", ["commit_batch", "tagged_push",
                                  "tagged_mutation", "peek_batch"])
def test_commit_wire_frames_equal_the_jax_package(what):
    """The commit wire: a columnar client commit batch, the txn host's
    packed push to a log, one TaggedMutation, and a columnar peek reply,
    framed by each package."""
    def message(pkg):
        cw = mod(pkg, "cluster.commit_wire")
        if what == "commit_batch":
            return cw.CommitBatchRequest(
                cw.CommitWireBatch.from_reqs(_commit_reqs(pkg)).to_bytes())
        if what == "tagged_push":
            itf = mod(pkg, "cluster.interfaces")
            return itf.TLogCommitRequest(
                7, 9, [], epoch=2, debug_id="dbg",
                wire=cw.pack_tagged_mutations(_tagged(pkg)))
        if what == "tagged_mutation":
            return _tagged(pkg)[0]
        return cw.TaggedMutationBatch.from_entries(
            [(11, _tagged(pkg)[:2]), (12, _tagged(pkg)[2:])]).to_bytes()

    assert _framed(PORT, 14, 7, message(PORT)) == \
        _framed(JAX, 14, 7, message(JAX))
