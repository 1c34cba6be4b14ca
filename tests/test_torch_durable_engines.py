"""The port's durable storage tier against the JAX package's, on the CPU:
DiskQueue on both backends (the native C++ queue of native/diskqueue.cpp,
built by the port into build/native/, and the Python twin),
KeyValueStoreMemory and KeyValueStoreSSD (the native B+tree).

- every case of tests/test_storage_engine.py and tests/test_ssd_engine.py,
  run from those files with their classes swapped for the port's (the
  reference files are loaded under other module names and left as they
  are);
- the same numpy-seeded operations through the JAX class and the port's
  into two temporary directories: the files are byte-identical, each
  package recovers the other's files to the same records or rows, a torn
  tail loses only the records of the batch whose commit never returned,
  and an oversized record raises the same exception type per backend in
  both packages (OSError on native, AssertionError on the Python twin);
- the build rules: nothing is built or loaded at import, the library is
  built from native/*.cpp into build/native/, and a failed build raises
  with the compiler's stderr (no fallback to the Python twin).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from foundationdb_tpu.core import errors as jerrors
from foundationdb_tpu.storage_engine import diskqueue as jdq
from foundationdb_tpu.storage_engine import memory_engine as jmem
from foundationdb_tpu.storage_engine import ssd_engine as jssd
from foundationdb_tpu_torch.core import errors as perrors
from foundationdb_tpu_torch.storage_engine import _native
from foundationdb_tpu_torch.storage_engine import diskqueue as pdq
from foundationdb_tpu_torch.storage_engine import memory_engine as pmem
from foundationdb_tpu_torch.storage_engine import ssd_engine as pssd

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["python", "native"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_se = _load("test_storage_engine")
ref_ssd = _load("test_ssd_engine")


# ------------------------------------------- the reference files' cases


def _storage_engine_cases():
    cases = ["test_native_library_is_built",
             "test_memory_engine_crash_mid_snapshot"]
    for name in ("test_push_commit_recover", "test_torn_tail_is_dropped",
                 "test_file_swap_reclaims_space",
                 "test_memory_engine_crash_recover",
                 "test_memory_engine_snapshot_cycle"):
        cases += [f"{name}[{b}]" for b in BACKENDS]
    cases += ["test_backends_share_on_disk_format[python-native]",
              "test_backends_share_on_disk_format[native-python]"]
    return cases


@pytest.mark.parametrize("case", _storage_engine_cases())
def test_storage_engine_case_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_se, "DiskQueue", pdq.DiskQueue)
    monkeypatch.setattr(ref_se, "KeyValueStoreMemory",
                        pmem.KeyValueStoreMemory)
    monkeypatch.setattr(ref_se, "_NATIVE", pdq._native())
    name, _, params = case.partition("[")
    fn = getattr(ref_se, name)
    if name == "test_native_library_is_built":
        fn()
    elif name == "test_memory_engine_crash_mid_snapshot":
        fn(tmp_path)
    elif name == "test_backends_share_on_disk_format":
        fn(tmp_path, *params.rstrip("]").split("-"))
    else:
        fn(tmp_path, params.rstrip("]"))


SSD_CASES = sorted(n for n in dir(ref_ssd) if n.startswith("test_"))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_engine_case_on_the_port(case, tmp_path, monkeypatch):
    monkeypatch.setattr(ref_ssd, "KeyValueStoreSSD", pssd.KeyValueStoreSSD)
    # the corruption case imports the JAX package's IoError inside its
    # body: the port raises its own
    monkeypatch.setattr(jerrors, "IoError", perrors.IoError)
    getattr(ref_ssd, case)(tmp_path)


def test_uncommitted_ssd_writes_lost_when_the_port_dies(tmp_path):
    """The port's ssd engine killed without commit in a process of its
    own: the committed tree opens intact, the uncommitted writes are
    gone."""
    p = str(tmp_path / "kvs.db")
    code = f"""
import os, sys
sys.path.insert(0, {str(ROOT)!r})
from foundationdb_tpu_torch.storage_engine.ssd_engine import KeyValueStoreSSD
kvs = KeyValueStoreSSD({p!r})
for i in range(100):
    kvs.set(b"committed%03d" % i, b"yes")
kvs.commit()
for i in range(100):
    kvs.set(b"uncommitted%03d" % i, b"no")
os._exit(9)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=300)
    assert r.returncode == 9, r.stderr
    kvs = pssd.KeyValueStoreSSD(p)
    assert kvs.get(b"committed050") == b"yes"
    assert kvs.get(b"uncommitted050") is None
    assert len(kvs.get_range(b"", b"\xff")) == 100
    kvs.close()


# -------------------------------------------- same operations, both sides


def records(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, pdq.PAYLOAD_MAX + 1, n)
    lens[rng.random(n) < 0.5] %= 64   # many small records too
    return [rng.integers(0, 256, int(ln), dtype=np.uint8).tobytes()
            for ln in lens]


def drive_queue(cls, prefix: str, backend: str, recs, pops=True):
    """Push `recs` in numpy-seeded batches, commit each, pop behind; the
    last batch is pushed but never committed."""
    q = cls(prefix, backend=backend)
    rng = np.random.default_rng(len(recs))
    i = 0
    seqs = []
    while i < len(recs):
        k = int(rng.integers(1, 40))
        for r in recs[i:i + k]:
            seqs.append(q.push(r))
        i += k
        if i < len(recs):
            q.commit()
            if pops and rng.random() < 0.3:
                q.pop(seqs[len(seqs) // 2])
    q.close()


def files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.fixture
def small_budgets(monkeypatch):
    """A 64 KiB segment budget and 16 KiB snapshot cadence in both
    packages, so a few hundred records swap files and snapshot (the JAX
    package's Python twin runs a bit-serial CRC)."""
    for mod in (jdq, pdq):
        monkeypatch.setattr(mod, "SEGMENT_BUDGET", 1 << 16)
    for mod in (jmem, pmem):
        monkeypatch.setattr(mod, "SNAPSHOT_OP_BYTES", 1 << 14)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_diskqueue_files_equal_and_cross_recover(tmp_path, backend, seed,
                                                 small_budgets):
    recs = records(seed, 120)   # past one segment budget: file swaps
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    drive_queue(jdq.DiskQueue, str(tmp_path / "j" / "q"), backend, recs)
    drive_queue(pdq.DiskQueue, str(tmp_path / "p" / "q"), backend, recs)
    fj, fp = files(tmp_path / "j"), files(tmp_path / "p")
    assert fj.keys() == fp.keys() == {"q.q0", "q.q1"}
    assert fj == fp
    # each package recovers the other's files, on either backend
    for reader in BACKENDS:
        a = jdq.DiskQueue(str(tmp_path / "p" / "q"), backend=reader)
        b = pdq.DiskQueue(str(tmp_path / "j" / "q"), backend=reader)
        assert a.recovered == b.recovered
        assert a.next_seq == b.next_seq
        assert a.recovered, "nothing recovered"
        a.close()
        b.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_tail_loses_only_uncommitted_records(tmp_path, backend):
    """A batch whose commit never returned: its pages land partly (the
    file cut mid-batch, then a page's payload torn). Recovery keeps every
    committed record and at most a prefix of the torn batch, equally in
    both packages."""
    recs = records(3, 60)
    acked, torn = recs[:40], recs[40:]
    out = {}
    for tag, cls in (("j", jdq.DiskQueue), ("p", pdq.DiskQueue)):
        prefix = str(tmp_path / tag)
        q = cls(prefix, backend=backend)
        for r in acked:
            q.push(r)
        q.commit()
        for r in torn:
            q.push(r)
        q.commit()
        q.close()
        path = prefix + ".q0"
        keep = (40 + 7) * pdq.PAGE_SIZE
        with open(path, "r+b") as f:
            f.truncate(keep + 100)       # a partial page past the cut
            f.seek(keep - pdq.PAGE_SIZE + pdq.HEADER.size)
            f.write(b"\xde\xad")          # and the last whole page torn
        got = cls(prefix, backend=backend)
        out[tag] = [d for _, d in got.recovered]
        got.close()
    assert out["j"] == out["p"]
    assert out["p"] == acked + torn[:6]


@pytest.mark.parametrize("backend,exc", [("native", OSError),
                                         ("python", AssertionError)])
def test_oversized_record_raises_the_same_per_backend(tmp_path, backend,
                                                      exc):
    for cls, tag in ((jdq.DiskQueue, "j"), (pdq.DiskQueue, "p")):
        q = cls(str(tmp_path / tag), backend=backend)
        q.push(b"x" * pdq.PAYLOAD_MAX)   # the largest record fits
        with pytest.raises(exc) as info:
            q.push(b"x" * (pdq.PAYLOAD_MAX + 1))
        assert type(info.value) is exc
        q.close()


def drive_kv(kv, seed: int, n: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(n):
        op = rng.random()
        k = b"k%05d" % int(rng.integers(0, 200))
        if op < 0.8:
            kv.set(k, rng.integers(0, 256, int(rng.integers(0, 600)),
                                   dtype=np.uint8).tobytes())
        elif op < 0.9:
            kv.clear(k)
        else:
            kv.clear_range(k, b"k%05d" % (int(k[1:]) + 20))
        if rng.random() < 0.05:
            kv.commit()
    kv.commit()
    kv.set(b"never-committed", b"lost")
    kv.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_memory_engine_files_equal_and_cross_recover(tmp_path, backend,
                                                     small_budgets):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    # enough logged bytes for several snapshots and their log pops
    drive_kv(jmem.KeyValueStoreMemory(str(tmp_path / "j" / "kv"),
                                      backend=backend), 7, 400)
    drive_kv(pmem.KeyValueStoreMemory(str(tmp_path / "p" / "kv"),
                                      backend=backend), 7, 400)
    assert files(tmp_path / "j") == files(tmp_path / "p")
    a = jmem.KeyValueStoreMemory(str(tmp_path / "p" / "kv"),
                                 backend=backend)
    b = pmem.KeyValueStoreMemory(str(tmp_path / "j" / "kv"),
                                 backend=backend)
    rows = a.get_range(b"", b"\xff")
    assert rows == b.get_range(b"", b"\xff")
    assert len(rows) > 50 and a.get(b"never-committed") is None
    assert a.format_version == b.format_version
    a.close()
    b.close()


def test_ssd_engine_files_equal_and_cross_recover(tmp_path):
    drive_kv(jssd.KeyValueStoreSSD(str(tmp_path / "j.btree")), 8, 3000)
    drive_kv(pssd.KeyValueStoreSSD(str(tmp_path / "p.btree")), 8, 3000)
    assert (tmp_path / "j.btree").read_bytes() == \
        (tmp_path / "p.btree").read_bytes()
    a = jssd.KeyValueStoreSSD(str(tmp_path / "p.btree"))
    b = pssd.KeyValueStoreSSD(str(tmp_path / "j.btree"))
    rows = a.get_range(b"", b"\xff")
    assert rows == b.get_range(b"", b"\xff") and len(rows) > 50
    assert a.get(b"never-committed") is None
    a.close()
    b.close()


# ------------------------------------------------------ the build rules


def test_importing_builds_and_loads_nothing():
    code = (
        "import sys\n"
        "import foundationdb_tpu_torch.storage_engine as se\n"
        "from foundationdb_tpu_torch.storage_engine import _native, "
        "diskqueue, ssd_engine, memory_engine\n"
        "import foundationdb_tpu_torch.cluster.durable_tlog\n"
        "assert _native._lib is None and diskqueue._NATIVE is None\n"
        "assert ssd_engine._NATIVE is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_library_is_built_from_the_native_sources():
    path = _native.build()
    assert path.parent == ROOT / "build" / "native"
    assert [s.relative_to(ROOT).as_posix() for s in _native.SOURCES] == [
        "native/diskqueue.cpp", "native/btree_kvs.cpp", "native/crc32c.cpp"]
    assert path == _native.lib_path() and path.exists()
    # the default backend is native, and stays native
    q = pdq.DiskQueue(str(ROOT / "build" / "native" / "probe-q"))
    try:
        assert q.backend == "native"
        assert isinstance(q._impl, pdq._NativeQueue)
    finally:
        q.close()
        for s in (".q0", ".q1"):
            os.unlink(str(ROOT / "build" / "native" / "probe-q") + s)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCES", [bad])
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed") as info:
        _native.load()
    assert "bad.cpp" in str(info.value)
    assert not list((tmp_path / "out").glob("*.so"))
