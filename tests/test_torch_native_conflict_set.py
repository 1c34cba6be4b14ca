"""The port's ConflictSetNativeCPU (resolver/native_cpu.py over the
library storage_engine/_native.py builds from native/conflict_set.cpp)
against the port's oracle and the JAX package's ConflictSetNativeCPU.

The cases of tests/test_native_conflict_set.py (mixed key lengths, wide
ranges, empty and degenerate batches, tooOld, fused adjacent writes, the
long soak in the slow tier): the same seeded batches go through all three
sets, and statuses and entries() must be equal after every batch. Also:
resolve_columnar equals resolve, the set starts at init_version,
CONFLICT_SET_IMPL="native" recruits it, and a failed build raises.
"""

import struct

import numpy as np
import pytest

from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.native_cpu import (
    ConflictSetNativeCPU,
    _pack_keys_blob,
)
from foundationdb_tpu_torch.resolver.packing import flatten_batch
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo
from foundationdb_tpu_torch.storage_engine import _native


def k8(x: int) -> bytes:
    return struct.pack(">Q", x)


def gen_txns(rng, n, version, key_space=512, lag=200, mixed_len=False,
             wide=False):
    """tests/test_native_conflict_set.py's generator, on the port's
    types."""
    txns = []
    for _ in range(n):
        def key():
            a = int(rng.integers(0, key_space))
            if mixed_len:
                pick = int(rng.integers(0, 3))
                if pick == 0:
                    return bytes([a % 250])
                if pick == 1:
                    return k8(a) + bytes(int(rng.integers(0, 9))) + b"x"
            return k8(a)

        def ranges(count):
            out = []
            for _ in range(count):
                b = key()
                if wide and rng.random() < 0.5:
                    e = key()
                    if e <= b:
                        e = b + b"\x00" + e
                else:
                    e = b + b"\x00"
                out.append(KeyRange(b, e))
            return out

        rr = ranges(int(rng.integers(0, 5)))
        wr = ranges(int(rng.integers(0, 3)))
        snap = version - int(rng.integers(0, lag))
        txns.append(TxnConflictInfo(snap, rr, wr))
    return txns


def to_jax(txns):
    from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
    from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn

    return [JTxn(t.read_snapshot,
                 [JKeyRange(r.begin, r.end) for r in t.read_ranges],
                 [JKeyRange(r.begin, r.end) for r in t.write_ranges])
            for t in txns]


class Trio:
    """The port's oracle, the port's native set and the JAX package's
    native set, stepped together."""

    def __init__(self, init_version: int = 0):
        from foundationdb_tpu.resolver.native_cpu import (
            ConflictSetNativeCPU as JaxNative,
        )

        self.oracle = ConflictSetCPU(init_version)
        self.native = ConflictSetNativeCPU(init_version)
        self.jax = JaxNative(init_version)

    def resolve(self, version, new_oldest, txns, where=""):
        want = self.oracle.resolve(version, new_oldest, txns).statuses
        got = self.native.resolve(version, new_oldest, txns).statuses
        jax = self.jax.resolve(version, new_oldest, to_jax(txns)).statuses
        assert got == want == jax, where
        return got

    def check_entries(self, where=""):
        want = self.oracle.entries()
        assert self.native.entries() == want, where
        assert self.jax.entries() == want, where
        assert len(self.native) == len(want)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("mixed_len,wide", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_native_matches_oracle_and_jax(seed, mixed_len, wide):
    rng = np.random.default_rng(seed)
    sets = Trio()
    version = 1000
    for step in range(12):
        txns = gen_txns(rng, 40, version, mixed_len=mixed_len, wide=wide)
        new_oldest = max(0, version - int(rng.integers(50, 400)))
        sets.resolve(version, new_oldest, txns, f"step {step}")
        sets.check_entries(f"step {step}")
        version += int(rng.integers(10, 120))


def test_native_empty_and_degenerate_batches():
    sets = Trio()
    # Empty batch still advances + coalesces (gc runs every resolve).
    sets.resolve(100, 0, [TxnConflictInfo(90, [], [KeyRange(k8(5), k8(9))])])
    sets.check_entries()
    sets.resolve(200, 150, [])
    sets.check_entries()
    # Write-only txns never conflict; a later read of an earlier txn's
    # intra-batch write does.
    txns = [
        TxnConflictInfo(160, [], [KeyRange(k8(6), k8(7))]),
        TxnConflictInfo(160, [KeyRange(k8(6), k8(7))], []),
    ]
    assert sets.resolve(300, 150, txns) == [0, 1]
    sets.check_entries()


def test_native_too_old():
    sets = Trio()
    sets.resolve(100, 80, [TxnConflictInfo(95, [], [KeyRange(k8(1), k8(2))])])
    txns = [
        TxnConflictInfo(50, [KeyRange(k8(1), k8(2))], []),   # tooOld
        TxnConflictInfo(50, [], [KeyRange(k8(3), k8(4))]),   # write-only: ok
        TxnConflictInfo(90, [KeyRange(k8(9), k8(10))], []),  # fine
    ]
    assert sets.resolve(120, 80, txns) == [2, 0, 0]
    sets.check_entries()
    assert sets.native.oldest_version == 80


def test_native_adjacent_and_overlapping_writes_fuse():
    """Adjacent committed ranges [a,k)+[k,c) and overlapping ranges must
    leave the same coalesced step function as the oracle."""
    sets = Trio()
    txns = [
        TxnConflictInfo(0, [], [KeyRange(k8(10), k8(20))]),
        TxnConflictInfo(0, [], [KeyRange(k8(20), k8(30))]),
        TxnConflictInfo(0, [], [KeyRange(k8(25), k8(40))]),
        TxnConflictInfo(0, [], [KeyRange(k8(50), k8(60))]),
    ]
    sets.resolve(10, 0, txns)
    sets.check_entries()
    # Overwrite interior + exact-end-entry cases.
    sets.resolve(20, 0, [TxnConflictInfo(10, [], [KeyRange(k8(15), k8(50))])])
    sets.check_entries()


def test_native_starts_at_init_version():
    sets = Trio(init_version=7)
    assert sets.native.entries() == [(b"", 7)] == sets.oracle.entries()
    sets.resolve(20, 0, [TxnConflictInfo(5, [KeyRange(k8(1), k8(2))], [])])
    sets.check_entries()


@pytest.mark.parametrize("seed", [4, 5])
def test_resolve_columnar_equals_resolve(seed):
    """The columnar entry point, fed the rows flatten_batch gives, steps
    the set exactly as resolve does."""
    rng = np.random.default_rng(seed)
    by_objects, by_columns = ConflictSetNativeCPU(), ConflictSetNativeCPU()
    version = 1000
    for step in range(10):
        txns = gen_txns(rng, 40, version, mixed_len=True, wide=True)
        new_oldest = max(0, version - int(rng.integers(50, 400)))
        want = by_objects.resolve(version, new_oldest, txns).statuses
        (_, r_begin, r_end, r_txn, _, w_begin, w_end, w_txn) = flatten_batch(
            txns, by_columns.oldest_version)
        parts = [_pack_keys_blob(k) for k in (r_begin, r_end, w_begin,
                                              w_end)]
        shift = np.cumsum([0] + [p[0].size for p in parts[:-1]])
        blob = np.concatenate([p[0] for p in parts])
        (rb_off, rb_len), (re_off, re_len), (wb_off, wb_len), (
            we_off, we_len) = [(p[1] + s, p[2]) for p, s in zip(parts, shift)]
        got = by_columns.resolve_columnar(
            version, new_oldest, len(txns),
            np.array([t.read_snapshot for t in txns], np.int64),
            np.array([len(t.read_ranges) > 0 for t in txns], np.uint8),
            blob, np.asarray(r_txn, np.int32), rb_off, rb_len, re_off,
            re_len, np.asarray(w_txn, np.int32), wb_off, wb_len, we_off,
            we_len).statuses
        assert got == want, f"step {step}"
        assert by_columns.entries() == by_objects.entries(), f"step {step}"
        version += int(rng.integers(10, 120))


def test_the_host_library_is_the_ports_own():
    """Built from native/conflict_set.cpp and crc32c.cpp into
    build/native/, never a `make` product under native/."""
    path = _native.host_path()
    _native.load_host()
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert [s.name for s in _native.HOST_SOURCES] == [
        "conflict_set.cpp", "crc32c.cpp"]


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    """No g++ on PATH and no library built: recruiting the native set
    raises, naming g++; nothing falls back to the oracle."""
    from foundationdb_tpu_torch.resolver.factory import make_conflict_set

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_native, "_host", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        ConflictSetNativeCPU()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        make_conflict_set(0, impl="native")
    assert not (tmp_path / "out").exists()


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 8])
def test_native_long_soak_vs_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    sets = Trio(init_version=0)
    version = 10_000
    for step in range(40):
        txns = gen_txns(rng, 25, version, key_space=96, lag=300,
                        mixed_len=True, wide=True)
        sets.resolve(version, max(0, version - 500), txns, f"step {step}")
        version += int(rng.integers(5, 80))
    sets.check_entries()
