"""The C wire client (native/fdb_c_client.cpp, built by the port's
storage_engine/_native.py into build/native/) against the port's served
cluster, net/service.run_network_server on the CPU: the cases of
tests/test_c_client.py, with no Python on the client side of the socket."""

import ctypes
import threading

import pytest

from foundationdb_tpu_torch.storage_engine import _native


@pytest.fixture()
def served_cluster():
    from foundationdb_tpu_torch.net.service import run_network_server

    ready = threading.Event()
    stop = threading.Event()
    t = threading.Thread(target=run_network_server,
                         kwargs={"ready": ready, "stop_event": stop,
                                 "device": "cpu"},
                         daemon=True)
    t.start()
    assert ready.wait(timeout=30), "server did not come up"
    host, port = ready.address.rsplit(":", 1)
    yield host, int(port)
    stop.set()
    t.join(timeout=30)


def test_the_client_library_is_built_from_the_native_source():
    lib = _native.load_c_client()
    path = _native.c_client_path()
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert path.name.startswith("libfdbtpu_c-")
    assert [s.name for s in _native.C_CLIENT_SOURCES] == ["fdb_c_client.cpp"]
    assert lib.fdbc_commit.restype is ctypes.c_int64


def test_c_client_end_to_end(served_cluster):
    lib = _native.load_c_client()
    host, port = served_cluster
    h = lib.fdbc_connect(host.encode(), port)
    assert h, "connect failed"
    try:
        rv = lib.fdbc_get_read_version(h)
        assert rv >= 0
        lib.fdbc_tr_set(h, b"ckey", 4, b"cvalue", 6)
        cv = lib.fdbc_commit(h, rv, None, 0)
        assert cv > rv, cv
        rv2 = lib.fdbc_get_read_version(h)
        assert rv2 >= cv
        out = ctypes.c_void_p()
        out_len = ctypes.c_uint32()
        st = lib.fdbc_get(h, b"ckey", 4, rv2, ctypes.byref(out),
                          ctypes.byref(out_len))
        assert st == 1
        assert ctypes.string_at(out, out_len.value) == b"cvalue"
        st = lib.fdbc_get(h, b"nope", 4, rv2, ctypes.byref(out),
                          ctypes.byref(out_len))
        assert st == 0
        lib.fdbc_tr_clear_range(h, b"ckey", 4, b"ckez", 4)
        cv2 = lib.fdbc_commit(h, rv2, None, 0)
        assert cv2 > cv
        rv3 = lib.fdbc_get_read_version(h)
        st = lib.fdbc_get(h, b"ckey", 4, rv3, ctypes.byref(out),
                          ctypes.byref(out_len))
        assert st == 0
    finally:
        lib.fdbc_destroy(h)


def test_c_client_conflict_detection(served_cluster):
    """A read-write conflict through the wire: the second commit is
    rejected with not_committed (1020)."""
    lib = _native.load_c_client()
    host, port = served_cluster
    h = lib.fdbc_connect(host.encode(), port)
    assert h
    try:
        rv = lib.fdbc_get_read_version(h)
        lib.fdbc_tr_set(h, b"occ", 3, b"0", 1)
        assert lib.fdbc_commit(h, rv, None, 0) > 0
        s = lib.fdbc_get_read_version(h)
        lib.fdbc_tr_set(h, b"occ", 3, b"B", 1)
        assert lib.fdbc_commit(h, s, None, 0) > 0
        lib.fdbc_tr_set(h, b"other", 5, b"A", 1)
        rc = lib.fdbc_commit(h, s, b"occ", 3)
        assert rc == -2, rc
        assert lib.fdbc_last_error(h) == 1020  # not_committed
    finally:
        lib.fdbc_destroy(h)
