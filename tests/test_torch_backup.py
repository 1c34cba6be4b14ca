"""The port's snapshot backup against the JAX package's, on the CPU
(backup.py, backup_container.py; tests/_torch_twins.py runs each
scenario under the JAX package on its host backends and under the port on
the same and on its device backends, device="cpu", at the same seed):

- the same numpy-seeded contents give byte-identical snapshot files, in a
  file path and in file:// and memory:// containers;
- a snapshot the port wrote restores into a JAX cluster, and the reverse,
  to the same rows;
- the cases of tests/test_backup.py and the snapshot header case of
  tests/test_upgrade_formats.py, on the port, with their results equal to
  the JAX package's.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest

from _torch_twins import RUNS, assert_all_equal, run_twins


def _contents(seed: int, n: int = 400) -> list:
    """n rows of seeded keys (prefix, a numpy draw) and values (0-60
    random bytes, one in eight empty)."""
    rng = np.random.default_rng(seed)
    keys = sorted({b"row/%06d" % x for x in rng.integers(0, 10**6, n)})
    sizes = rng.integers(0, 61, len(keys))
    sizes[rng.random(len(keys)) < 0.125] = 0
    return [(k, rng.integers(0, 256, int(s), dtype=np.uint8).tobytes())
            for k, s in zip(keys, sizes)]


async def _fill(db, rows, per_txn: int = 100) -> None:
    for i in range(0, len(rows), per_txn):
        async def body(tr, chunk=rows[i:i + per_txn]):
            for k, v in chunk:
                tr.set(k, v)

        await db.transact(body)


async def _all_rows(db):
    return await db.transact(lambda tr: tr.get_range(b"", b"\xff"))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


# --------------------------------------------- byte-identical snapshots

@pytest.mark.parametrize("seed", [3, 8])
def test_snapshot_files_are_byte_identical(seed, tmp_path):
    rows = _contents(seed)

    async def main(pkg):
        bk = pkg.mod("backup")
        c = pkg.local()
        db = c.database()
        await _fill(db, rows)
        path = tmp_path / f"{pkg.which}-{pkg.backends}.fdbb"
        v = await bk.backup(db, str(path), chunk_rows=64)
        c.stop()
        return v, path.read_bytes()

    v, blob = assert_all_equal(run_twins(main, seed=seed))
    assert blob.startswith(b"FDBTPUB2") and v > 0


def test_container_files_are_byte_identical(tmp_path):
    """Two snapshots into a file:// container and one into memory://:
    the same file names and bytes in all three runs."""
    rows = _contents(5)

    async def main(pkg):
        bk = pkg.mod("backup")
        bc = pkg.mod("backup_container")
        c = pkg.local()
        db = c.database()
        await _fill(db, rows[:200])
        root = tmp_path / f"{pkg.which}-{pkg.backends}"
        v1 = await bk.backup_to_container(db, f"file://{root}")
        await _fill(db, rows[200:])
        await db.clear(rows[0][0])
        v2 = await bk.backup_to_container(db, f"file://{root}")
        name = f"twin-{pkg.which}-{pkg.backends}"
        bc.delete_memory_container(name)
        v3 = await bk.backup_to_container(db, f"memory://{name}")
        mem = bc.open_container(f"memory://{name}")
        files = {n: mem.read_file(n) for n in mem.list_files("")}
        bc.delete_memory_container(name)
        c.stop()
        return (v1, v2, v3, bc.open_container(f"file://{root}")
                .list_snapshots(), _tree(root), files)

    v1, v2, v3, snaps, tree, files = assert_all_equal(run_twins(main))
    assert snaps == [v1, v2] and len(tree) == 2 and len(files) == 1


# ---------------------------------------------- restores across packages

def _write_snapshot(which: str, backends: str, path: Path, rows) -> list:
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        await _fill(db, rows)
        await pkg.mod("backup").backup(db, str(path), chunk_rows=50)
        got = await _all_rows(db)
        c.stop()
        return got

    return run_twins(main, runs=[(which, backends)])[(which, backends)]


def _restore(which: str, backends: str, path: Path) -> list:
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        await db.set(b"stale", b"gone after the restore")
        n = await pkg.mod("backup").restore(db, str(path))
        got = await _all_rows(db)
        c.stop()
        return n, got

    return run_twins(main, runs=[(which, backends)])[(which, backends)]


@pytest.mark.parametrize("writer,reader", [
    (("port", "device"), ("jax", "host")),
    (("jax", "host"), ("port", "device")),
    (("port", "host"), ("jax", "host")),
    (("jax", "host"), ("port", "host")),
])
def test_snapshot_restores_across_packages(writer, reader, tmp_path):
    rows = _contents(11, 300)
    path = tmp_path / "snap.fdbb"
    want = _write_snapshot(*writer, path, rows)
    n, got = _restore(*reader, path)
    assert n == len(rows) and got == want == rows


# ------------------------------------------ tests/test_backup.py's cases

def test_backup_restore_roundtrip(tmp_path):
    async def main(pkg):
        bk = pkg.mod("backup")
        c = pkg.local()
        db = c.database()
        path = str(tmp_path / f"{pkg.which}-{pkg.backends}.fdbb")

        async def fill(tr):
            for i in range(500):
                tr.set(b"k%04d" % i, b"v%d" % i)

        await db.transact(fill)
        v = await bk.backup(db, path, chunk_rows=64)
        assert v > 0
        await db.set(b"k0001", b"CHANGED")
        await db.clear(b"k0002")
        await db.set(b"new", b"row")
        n = await bk.restore(db, path, chunk_rows=100)
        assert n == 500
        rows = await _all_rows(db)
        c.stop()
        return v, rows

    _, rows = assert_all_equal(run_twins(main, seed=1))
    assert len(rows) == 500
    assert (b"k0001", b"v1") in rows and (b"k0002", b"v2") in rows
    assert all(k != b"new" for k, _ in rows)


def test_backup_is_consistent_under_concurrent_writes(tmp_path):
    async def main(pkg):
        bk = pkg.mod("backup")
        spawn = pkg.mod("core.runtime").spawn
        c = pkg.local()
        db = c.database()
        path = str(tmp_path / f"{pkg.which}-{pkg.backends}.fdbb")

        async def init(tr):
            tr.set(b"pair/a", b"0")
            tr.set(b"pair/b", b"0")

        await db.transact(init)
        stop = [False]

        async def writer():
            i = 0
            while not stop[0]:
                i += 1

                async def bump(tr, i=i):
                    tr.set(b"pair/a", b"%d" % i)
                    tr.set(b"pair/b", b"%d" % i)

                await db.transact(bump)

        w = spawn(writer(), name="writer")
        v = await bk.backup(db, path, chunk_rows=1)
        stop[0] = True
        await w.done
        await bk.restore(db, path)
        rows = dict(await db.transact(
            lambda tr: tr.get_range(b"pair/", b"pair0")))
        c.stop()
        return v, rows

    _, rows = assert_all_equal(run_twins(main, seed=2))
    assert rows[b"pair/a"] == rows[b"pair/b"], "torn snapshot"


def test_backup_containers_roundtrip(tmp_path):
    async def main(pkg):
        bk = pkg.mod("backup")
        bc = pkg.mod("backup_container")
        c = pkg.local()
        db = c.database()
        url = f"file://{tmp_path}/{pkg.which}-{pkg.backends}"
        await db.set(b"a", b"1")
        v1 = await bk.backup_to_container(db, url)
        await db.set(b"a", b"2")
        await db.set(b"b", b"3")
        v2 = await bk.backup_to_container(db, url)
        assert bc.open_container(url).list_snapshots() == [v1, v2]
        c2 = pkg.local()
        db2 = c2.database()
        await bk.restore_from_container(db2, url)
        assert await db2.get(b"a") == b"2" and await db2.get(b"b") == b"3"
        await bk.restore_from_container(db2, url, version=v1)
        assert await db2.get(b"a") == b"1" and await db2.get(b"b") is None
        murl = f"memory://t1-{pkg.which}-{pkg.backends}"
        await bk.backup_to_container(db, murl)
        c3 = pkg.local()
        db3 = c3.database()
        await bk.restore_from_container(db3, murl)
        assert await db3.get(b"a") == b"2"
        p = bc.parse_blobstore_url("blobstore://k:s@host:443/bucket")
        assert p["bucket"] == "bucket"
        assert bc.open_container(
            "blobstore://k:s@host:443/bucket").bucket == "bucket"
        with pytest.raises(ValueError):
            bc.parse_blobstore_url("blobstore://nope")
        c.stop()
        c2.stop()
        c3.stop()
        return v1, v2, p

    assert_all_equal(run_twins(main))


# ---------------------- tests/test_upgrade_formats.py: the snapshot header

@pytest.mark.parametrize("which", ["jax", "port"])
def test_snapshot_header_lattice(which):
    from _torch_twins import Pkg

    pkg = Pkg(which, "host")
    bk = pkg.mod("backup")
    DURABLE_FORMAT = pkg.mod("core.serialize").DURABLE_FORMAT
    IncompatibleProtocolVersion = pkg.mod(
        "core.errors").IncompatibleProtocolVersion
    buf = io.BytesIO()
    buf.write(bk.MAGIC2 + struct.pack("<I", DURABLE_FORMAT.current)
              + struct.pack("<q", 42))
    buf.seek(0)
    assert bk.read_snapshot_header(buf) == (DURABLE_FORMAT.current, 42)
    buf = io.BytesIO(bk.MAGIC + struct.pack("<q", 7))
    assert bk.read_snapshot_header(buf) == (1, 7)
    buf = io.BytesIO(bk.MAGIC2 + struct.pack("<I", DURABLE_FORMAT.current + 1)
                     + struct.pack("<q", 9))
    with pytest.raises(IncompatibleProtocolVersion):
        bk.read_snapshot_header(buf)
    with pytest.raises(ValueError):
        bk.read_snapshot_header(io.BytesIO(b"NOTABACKUPFILE......"))


def test_formats_equal_the_jax_package():
    from foundationdb_tpu import backup as jbk
    from foundationdb_tpu.core.serialize import DURABLE_FORMAT as JDF
    from foundationdb_tpu_torch import backup as pbk
    from foundationdb_tpu_torch.core.serialize import DURABLE_FORMAT as PDF

    assert (pbk.MAGIC, pbk.MAGIC2, pbk.RESTORE_MARKER) == (
        jbk.MAGIC, jbk.MAGIC2, jbk.RESTORE_MARKER)
    assert (PDF.current, PDF.min_compatible, PDF.stamp()) == (
        JDF.current, JDF.min_compatible, JDF.stamp())
    assert pbk.BACKUP_TAG_BASE == jbk.BACKUP_TAG_BASE
    for v in (0, 1, 123456789):
        assert pbk._log_file_name(v) == jbk._log_file_name(v)
    assert len(RUNS) == 3
