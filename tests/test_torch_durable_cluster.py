"""The port's durable cluster tier on the CPU: RecoverableShardedCluster
over a datadir (the DiskQueue tlogs, the memory and ssd storage engines,
FileCoordinatorRegister coordinators), cold-booted by a fresh incarnation.

- the cases of tests/test_durable_cluster.py on the port, each once per
  back end: "gpu" (ConflictSetGPU and KeyValueStoreGPU, device="cpu",
  every storage window restored from its engine onto the device) and
  "oracle" (ConflictSetCPU and the VersionedMap window); the kill -9 case
  runs the port's cluster in a child process;
- a same-seed differential against the JAX package with the host back
  ends pinned on both sides: a crash leg (the incarnation abandoned
  without close), a cold boot that reads every row back and writes on, a
  clean stop and a second cold boot give the same rows, versions,
  generations and trace digest, and the same bytes in every file of the
  datadir after each incarnation;
- a cold-booted KeyValueStoreGPU(device="cpu") window equals the
  VersionedMap window booted from a copy of the same datadir, and the
  boot rebuilds it once, not once per restored row;
- without a card the durable entry points raise.
"""

import hashlib
import importlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from foundationdb_tpu_torch.cluster.recovery import RecoverableShardedCluster
from foundationdb_tpu_torch.core import delay, loop_context
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.core.runtime import sim_loop
from foundationdb_tpu_torch.kv.atomic import MutationType
from foundationdb_tpu_torch.storage_engine.gpu_engine import KeyValueStoreGPU

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = {"gpu": "gpu", "oracle": "memory"}   # conflict set -> window


@pytest.fixture(params=sorted(BACKENDS))
def backend(request, monkeypatch):
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", request.param)
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL",
                        BACKENDS[request.param])
    return request.param


def _cluster(datadir, **kw):
    kw.setdefault("n_storage", 4)
    kw.setdefault("n_logs", 2)
    kw.setdefault("replication", "double")
    kw.setdefault("shard_boundaries", [b"m"])
    return RecoverableShardedCluster(datadir=str(datadir), device="cpu",
                                     **kw)


def _run(seed, coro):
    loop = sim_loop(seed=seed)
    with loop_context(loop):
        out = loop.run(coro, timeout_sim_seconds=600)
    loop.shutdown()
    return out


# ------------------------------------------ tests/test_durable_cluster.py


@pytest.mark.parametrize("engine", ["memory", "ssd"])
def test_cold_boot_after_clean_stop(tmp_path, engine, backend):
    d = tmp_path / "db"

    async def phase1():
        from foundationdb_tpu_torch.cluster.management import exclude_servers

        c = _cluster(d, engine=engine).start()
        db = c.database()
        for i in range(25):
            await db.set(b"k%02d" % i, b"v%d" % i)

        async def add(tr, n):
            tr.atomic_op(MutationType.ADD_VALUE, b"counter",
                         n.to_bytes(8, "little"))

        await db.transact(lambda tr: add(tr, 7))
        await db.transact(lambda tr: add(tr, 5))
        await exclude_servers(db, [3])
        v = c.inner.master.get_live_committed_version()
        c.stop()
        return v

    v1 = _run(11, phase1())

    async def phase2():
        from foundationdb_tpu_torch.cluster.management import (
            get_excluded_servers,
        )

        c = _cluster(d, engine=engine).start()
        db = c.database()
        for i in range(25):
            assert await db.get(b"k%02d" % i) == b"v%d" % i
        got = await db.get(b"counter")
        assert int.from_bytes(got, "little") == 12
        assert await get_excluded_servers(db) == {3}
        assert c.inner.master.get_live_committed_version() >= v1
        await db.set(b"post-boot", b"yes")
        assert await db.get(b"post-boot") == b"yes"
        for _ in range(200):
            if c.inner.excluded == {3}:
                break
            await delay(0.05)
        assert c.inner.excluded == {3}
        window = c.inner.storages[0].data
        c.stop()
        return type(window)

    window_type = _run(12, phase2())
    assert (window_type is KeyValueStoreGPU) == (backend == "gpu")


def test_cold_boot_after_crash_without_close(tmp_path, backend):
    d = tmp_path / "db"

    async def phase1():
        c = _cluster(d).start()
        db = c.database()
        for i in range(40):
            await db.set(b"a%02d" % i, b"x%d" % i)
        # no stop, flush or close: the process dies

    _run(21, phase1())

    async def phase2():
        c = _cluster(d).start()
        db = c.database()
        for i in range(40):
            assert await db.get(b"a%02d" % i) == b"x%d" % i, i
        c.stop()

    _run(22, phase2())


def test_unacked_commit_never_half_applied(tmp_path, backend):
    d = tmp_path / "db"

    async def phase1():
        c = _cluster(d).start()
        db = c.database()

        async def pair(tr, i):
            tr.set(b"L%03d" % i, b"%d" % i)
            tr.set(b"R%03d" % i, b"%d" % i)

        for i in range(20):
            await db.transact(lambda tr, i=i: pair(tr, i))

    _run(31, phase1())

    async def phase2():
        c = _cluster(d).start()
        db = c.database()
        for i in range(20):
            left = await db.get(b"L%03d" % i)
            right = await db.get(b"R%03d" % i)
            assert left == right or (left is None) == (right is None), (
                i, left, right)
        c.stop()

    _run(32, phase2())


def test_second_reboot_and_replica_consistency(tmp_path, backend):
    d = tmp_path / "db"

    async def writer(lo, hi):
        c = _cluster(d).start()
        db = c.database()
        for i in range(lo, hi):
            await db.set(b"w%03d" % i, b"v%d" % i)

    _run(41, writer(0, 15))
    _run(42, writer(15, 30))

    async def check():
        from foundationdb_tpu_torch.workloads.consistency_check import (
            ConsistencyCheckWorkload,
        )

        c = _cluster(d).start()
        db = c.database()
        for i in range(30):
            assert await db.get(b"w%03d" % i) == b"v%d" % i, i
        await delay(1.5)
        cc = ConsistencyCheckWorkload(c.inner)
        assert await cc.check(), cc.failures
        c.stop()

    _run(43, check())


STORM_CHILD = """
import sys
sys.path.insert(0, {root!r})
from foundationdb_tpu_torch.core import loop_context
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.core.runtime import sim_loop
from foundationdb_tpu_torch.cluster.recovery import RecoverableShardedCluster

SERVER_KNOBS.CONFLICT_SET_IMPL = {cs!r}
SERVER_KNOBS.STORAGE_ENGINE_IMPL = {window!r}


async def storm():
    c = RecoverableShardedCluster(
        n_storage=4, n_logs=2, replication="double",
        shard_boundaries=[b"m"], datadir={datadir!r}, device="cpu",
    ).start()
    db = c.database()
    sys.stdout.write("READY\\n")
    sys.stdout.flush()
    i = 0
    while True:
        await db.set(b"s%06d" % i, b"v%d" % i)
        sys.stdout.write("ACK %d\\n" % i)   # strictly after the ack
        sys.stdout.flush()
        i += 1


loop = sim_loop(seed=7)
with loop_context(loop):
    loop.run(storm(), timeout_sim_seconds=1e9)
"""


def test_kill9_mid_commit_storm(tmp_path, backend):
    d = str(tmp_path / "db")
    code = STORM_CHILD.format(root=str(ROOT), datadir=d, cs=backend,
                              window=BACKENDS[backend])
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, text=True, bufsize=1,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    acked = []
    try:
        assert p.stdout.readline().strip() == "READY"
        deadline = time.time() + 120
        while len(acked) < 60 and time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            if line.startswith("ACK "):
                acked.append(int(line.split()[1]))
        assert len(acked) >= 30, f"storm too slow: {len(acked)} acks"
        p.send_signal(signal.SIGKILL)
    finally:
        p.kill()
        p.wait(timeout=30)

    async def verify():
        c = _cluster(d).start()
        db = c.database()
        for i in acked:
            assert await db.get(b"s%06d" % i) == b"v%d" % i, (
                f"acked key {i} lost by kill -9")
        await db.set(b"after", b"kill")
        assert await db.get(b"after") == b"kill"
        c.stop()

    _run(55, verify())


# ------------------------------ same-seed differential vs the JAX package


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _incarnation(pkg: str, datadir: str, seed: int, engine: str, lo: int,
                 hi: int, close: bool):
    """One incarnation of one package's durable cluster on `datadir`
    under sim_loop(seed) with a fresh trace sink: read every row, write
    keys lo..hi, read every row again; stop cleanly, or abandon it."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    rt, tr = mod("core.runtime"), mod("core.trace")
    kw = {"device": "cpu"} if pkg == "foundationdb_tpu_torch" else {}
    sink = tr.TraceSink()
    old = tr.global_sink()
    tr.set_global_sink(sink)
    loop = rt.sim_loop(seed=seed)
    try:
        with rt.loop_context(loop):
            c = mod("cluster.recovery").RecoverableShardedCluster(
                n_storage=4, n_logs=2, replication="double",
                log_replication="double", shard_boundaries=[b"m"],
                engine=engine, datadir=datadir, **kw).start()
            db = c.database()

            async def main():
                async def dump(t):
                    return await t.get_range(b"", b"\xff")

                before = await db.transact(dump)
                for i in range(lo, hi):
                    await db.set(b"%c%03d" % (b"am"[i % 2], i), b"v%d" % i)
                after = await db.transact(dump)
                version = c.inner.master.get_live_committed_version()
                if close:
                    c.stop()
                return before, after, version, c.generation

            out = loop.run(main(), timeout_sim_seconds=600)
        loop.shutdown()
    finally:
        tr.set_global_sink(old)
    digest = hashlib.sha256("\n".join(
        json.dumps(e, sort_keys=True, default=str) for e in sink.events
    ).encode()).hexdigest()
    return {"result": out, "digest": digest, "files": _files(Path(datadir))}


@pytest.mark.parametrize("engine", ["memory", "ssd"])
def test_cold_boot_equals_the_jax_package(tmp_path, engine, monkeypatch):
    from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS

    for knobs in (JKNOBS, SERVER_KNOBS):
        monkeypatch.setattr(knobs, "CONFLICT_SET_IMPL", "oracle")
        monkeypatch.setattr(knobs, "STORAGE_ENGINE_IMPL", "memory")
    d = str(tmp_path / "db")
    legs = [(61, 0, 30, False), (62, 30, 50, True), (63, 50, 60, True)]
    runs = {}
    for pkg in ("foundationdb_tpu", "foundationdb_tpu_torch"):
        # both packages on the same path, so paths in events agree
        runs[pkg] = [_incarnation(pkg, d, seed, engine, lo, hi, close)
                     for seed, lo, hi, close in legs]
        shutil.move(d, str(tmp_path / pkg))
    want, got = runs["foundationdb_tpu"], runs["foundationdb_tpu_torch"]
    for leg, (w, g) in enumerate(zip(want, got)):
        assert g["result"] == w["result"], leg
        assert g["digest"] == w["digest"], leg
        assert g["files"] == w["files"], leg
    # the crash leg's acked rows came back in the cold boot
    before = dict(got[1]["result"][0])
    assert all(before[b"%c%03d" % (b"am"[i % 2], i)] == b"v%d" % i
               for i in range(30))
    assert len(got[2]["result"][1]) == 60
    assert got[2]["result"][3] > got[1]["result"][3] > got[0]["result"][3]


def test_cold_booted_gpu_window_equals_the_versioned_map(tmp_path,
                                                         monkeypatch):
    """One datadir booted twice (from copies): KeyValueStoreGPU windows
    on device="cpu", then VersionedMap windows; every storage server's
    restored window has the same entries() and reads, and each GPU window
    rebuilt once in the boot."""
    from foundationdb_tpu_torch.kv.versioned_map import VersionedMap

    d = tmp_path / "db"
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "oracle")
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "memory")

    async def load():
        c = _cluster(d).start()
        db = c.database()
        for i in range(120):
            await db.set(b"%c%03d" % (b"amz"[i % 3], i), b"v%d" % i * 3)

        async def clear(tr):
            tr.clear_range(b"a000", b"a030")

        await db.transact(clear)
        c.stop()

    _run(71, load())
    shutil.copytree(d, tmp_path / "copy")

    def boot(datadir, window):
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", window)

        async def main():
            c = _cluster(datadir).start()
            out = []
            for s in c.inner.storages:
                w = s.data
                n0 = (w.c_compactions.total
                      if isinstance(w, KeyValueStoreGPU) else None)
                rows = w.entries()
                n1 = (w.c_compactions.total
                      if isinstance(w, KeyValueStoreGPU) else None)
                v = s.version.get()
                out.append((type(w), rows, w.get_range(b"", b"\xff", v),
                            (n0, n1)))
            c.stop()
            return out

        return _run(72, main())

    gpu = boot(d, "gpu")
    host = boot(tmp_path / "copy", "memory")
    for (tg, rg, qg, comp), (th, rh, qh, _) in zip(gpu, host):
        assert tg is KeyValueStoreGPU and th is VersionedMap
        assert rg == rh and qg == qh
        # the constructor's empty build, then one rebuild of every
        # restored row at the first fold (not one per row); a window
        # that restored nothing rebuilds nothing
        assert comp == ((1, 2) if rg else (1, 1)), comp
    assert sum(bool(r) for _, r, _, _ in gpu) >= 2


def test_without_a_card_the_durable_entry_points_raise(tmp_path,
                                                       monkeypatch):
    import torch

    from foundationdb_tpu_torch.workloads.tester import run_restart_spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecoverableShardedCluster(datadir=str(tmp_path / "db"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_restart_spec({"cluster": {"kind": "restart"}, "phases": []})
