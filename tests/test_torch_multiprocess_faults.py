"""The kill and relaunch cases of tests/test_multiprocess.py on the port's
role hosts (`--device cpu`): SIGKILL of real role-host processes,
relaunches on the same datadirs, a destroyed log datadir under double log
replication, and a killed resolver host replaced by a fresh one."""

import hashlib
import os
import shutil
import signal

import pytest

from _torch_mp import client_run, launch, spawn_host, teardown


@pytest.fixture()
def cluster3(tmp_path):
    cf, procs = launch(tmp_path)
    try:
        yield cf, procs
    finally:
        teardown(procs)


def _kill(p) -> None:
    p.send_signal(signal.SIGKILL)
    p.wait(timeout=20)


def _kill_group(p) -> None:
    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
    p.wait(timeout=20)


def test_durability_across_process_kill(cluster3, tmp_path):
    """kill -9 the LOG host (the only fsync on the commit path) and the
    txn host; relaunch them on the same datadirs: acked writes survive."""
    cf, procs = cluster3

    async def write(db):
        for i in range(15):
            await db.set(b"d%02d" % i, b"v%d" % i)
        return True

    assert client_run(cf, write)
    for p in procs[:1] + procs[2:]:
        _kill(p)
    procs[0] = spawn_host("foundationdb_tpu_torch", "log", cf,
                          str(tmp_path / "data" / "log"))
    procs[2] = spawn_host("foundationdb_tpu_torch", "txn", cf,
                          str(tmp_path / "data" / "txn"))

    # No fixed sleep: the client's GRV/read retries are the readiness
    # probe, spinning until the boot recovery serves.
    async def verify(db):
        for i in range(15):
            assert await db.get(b"d%02d" % i) == b"v%d" % i, i
        await db.set(b"after", b"relaunch")
        assert await db.get(b"after") == b"relaunch"
        return True

    assert client_run(cf, verify, timeout_s=180)


def _fingerprint(rows) -> str:
    h = hashlib.sha256()
    for k, v in rows:
        h.update(b"%d:%b=%d:%b;" % (len(k), k, len(v), v))
    return h.hexdigest()


def test_double_log_replication_survives_datadir_destruction(tmp_path):
    """Under `double` log replication across two log hosts, SIGKILL one
    and DESTROY its datadir: the relaunched host recovers empty, the
    epoch-end quorum excludes it, the tag cursors fail over, and no acked
    write is lost."""
    classes = ("log0", "log1", "storage", "txn")
    cf, procs = launch(tmp_path, classes,
                       spec_extra={"n_log_hosts": 2, "n_logs": 2,
                                   "log_replication": "double"})
    try:
        async def write(db):
            for i in range(20):
                await db.set(b"w%02d" % i, b"v%d" % i)
            return _fingerprint(
                [(b"w%02d" % i, await db.get(b"w%02d" % i))
                 for i in range(20)])

        fp_before = client_run(cf, write)
        _kill(procs[0])
        shutil.rmtree(tmp_path / "data" / "log0")
        procs[0] = spawn_host("foundationdb_tpu_torch", "log0", cf,
                              str(tmp_path / "data" / "log0"))

        async def verify(db):
            fp = _fingerprint(
                [(b"w%02d" % i, await db.get(b"w%02d" % i))
                 for i in range(20)])
            await db.set(b"after", b"destroyed")
            assert await db.get(b"after") == b"destroyed"
            return fp

        assert client_run(cf, verify, timeout_s=180) == fp_before, \
            "acked writes lost with the destroyed log datadir"
    finally:
        teardown(procs)


def test_two_log_hosts_survive_one_host_sigkill(tmp_path):
    """The tlog quorum spans two log-host processes; SIGKILL one mid-run,
    relaunch it on its preserved disk: the controller re-recovers, acked
    writes survive and the Cycle invariant holds."""
    classes = ("log0", "log1", "storage", "txn")
    cf, procs = launch(tmp_path, classes,
                       spec_extra={"n_log_hosts": 2, "n_logs": 2})
    try:
        async def write(db):
            for i in range(15):
                await db.set(b"h%02d" % i, b"v%d" % i)
            return True

        assert client_run(cf, write)
        _kill(procs[1])
        procs[1] = spawn_host("foundationdb_tpu_torch", "log1", cf,
                              str(tmp_path / "data" / "log1"))

        async def verify(db):
            from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

            for i in range(15):
                assert await db.get(b"h%02d" % i) == b"v%d" % i, i
            w = CycleWorkload(db, nodes=8)
            await w.setup()
            await w.start(clients=2, txns_per_client=8)
            assert await w.check(), "cycle invariant after log-host loss"
            return True

        assert client_run(cf, verify, timeout_s=180)
    finally:
        teardown(procs)


def test_resolver_host_killed_and_replaced(tmp_path, monkeypatch):
    """SIGKILL the resolver host's process group mid-run and start a
    fresh one on the same class: the controller re-recruits it, commits
    flow again, and every acked write reads back (the chip smoke's
    [multiprocess] leg B, at a test's size). The client's commit timeout
    is cut from 20 s to 3 s: a commit sent while the transaction system
    recovers is dropped and only retried once that timeout ends."""
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS

    monkeypatch.setattr(CLIENT_KNOBS, "COMMIT_TIMEOUT", 3.0)
    classes = ("log0", "log1", "storage", "resolver", "txn")
    cf, procs = launch(tmp_path, classes,
                       spec_extra={"n_log_hosts": 2, "n_logs": 2,
                                   "log_replication": "double",
                                   "n_resolvers": 2})
    try:
        async def write(db):
            for i in range(10):
                await db.set(b"r%02d" % i, b"v%d" % i)
            return True

        assert client_run(cf, write)
        _kill_group(procs[3])
        procs[3] = spawn_host("foundationdb_tpu_torch", "resolver", cf,
                              str(tmp_path / "data" / "resolver"))

        async def verify(db):
            for i in range(10):
                assert await db.get(b"r%02d" % i) == b"v%d" % i, i
            await db.set(b"after", b"resolver")
            assert await db.get(b"after") == b"resolver"
            return True

        assert client_run(cf, verify, timeout_s=180)
    finally:
        teardown(procs)
