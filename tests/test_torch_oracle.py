"""The port's oracle ConflictSetCPU against the JAX package's copy.

The port's copy keeps phase 2's committed writes as a union of disjoint
intervals instead of a list it scans per read, and merges phase 3's
committed writes into the history in one pass; verdicts and entries()
must be those of the JAX copy on the same numpy-seeded batches: ranges
that nest, overlap, touch end to begin, repeat, are empty, abort chains
and tooOld waves.
"""

import struct

import numpy as np
import pytest

from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver.cpu import ConflictSetCPU as JOracle
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU as POracle
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn


def key(a: int) -> bytes:
    return struct.pack(">H", int(a))


def raw_batch(rng, n, version, space, lag):
    """Ranges over a small key space so writes of one batch overlap and
    touch each other; some end exactly where another begins, some are
    empty (begin == end) and some point ranges [k, k + b"\\x00")."""
    def rng_range():
        a = int(rng.integers(0, space))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            return key(a), key(a) + b"\x00"
        if kind == 1:
            return key(a), key(a)
        return key(a), key(a + int(rng.integers(1, 8)))

    out = []
    for _ in range(n):
        rr = [rng_range() for _ in range(int(rng.integers(0, 4)))]
        wr = [rng_range() for _ in range(int(rng.integers(0, 4)))]
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def txns(raw, jax_side: bool):
    T, KR = (JTxn, JKeyRange) if jax_side else (PTxn, PKeyRange)
    return [T(s, [KR(*r) for r in rr], [KR(*w) for w in wr])
            for s, rr, wr in raw]


@pytest.mark.parametrize("space,n", [(40, 60), (200, 150), (2000, 300),
                                     (16, 200)])
def test_port_oracle_matches_jax_oracle(space, n):
    rng = np.random.default_rng(space + n)
    want, got = JOracle(), POracle()
    v = 1000
    for b in range(12):
        v += 100
        raw = raw_batch(rng, n, v, space, lag=450)
        no = v - 600 if b % 3 else 0
        a = want.resolve(v, no, txns(raw, True)).statuses
        assert got.resolve(v, no, txns(raw, False)).statuses == a, b
        assert got.entries() == want.entries(), b


def test_touching_writes_do_not_conflict_but_overlaps_do():
    """Phase 2 at the interval edges: a write [b, c) merged into the union
    with [a, b) must not make a read ending at a, or beginning at c,
    conflict; a read of [b - 1, b + 1) must."""
    a, b, c = key(10), key(20), key(30)
    K, T = PKeyRange, PTxn
    batch = [
        T(5, [], [K(a, b)]),
        T(5, [], [K(b, c)]),
        T(5, [K(key(0), a)], []),
        T(5, [K(c, key(40))], []),
        T(5, [K(key(19), key(21))], []),
        T(5, [K(key(25), key(25))], []),  # empty: never conflicts
    ]
    assert POracle().resolve(10, 0, batch).statuses == [0, 0, 0, 0, 1, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wide_reads_match_jax_oracle(seed):
    """Reads over tens to thousands of entries, which phase 1 answers from
    its sparse table, give the JAX copy's verdicts and entries(), with
    snapshots on both sides of the versions they span. The readers come
    first in each batch and write nothing, so phase 2 cannot decide them
    in phase 1's place."""
    rng = np.random.default_rng(seed)
    want, got = JOracle(), POracle()
    v, space = 1000, 4000
    for b in range(10):
        v += 100
        raw = []
        for _ in range(100):
            a = int(rng.integers(0, space))
            w = int(rng.integers(1, 3)) if rng.random() < 0.3 else int(
                rng.integers(60, space // 4))
            raw.append((v - int(rng.integers(0, 350)),
                        [(key(a), key(min(a + w, space)))], []))
        for _ in range(100):
            raw.append((v, [], [(key(c), key(c) + b"\x00") for c in
                                rng.integers(0, space, 5)]))
        no = v - 500 if b % 4 else 0
        a = want.resolve(v, no, txns(raw, True)).statuses
        assert got.resolve(v, no, txns(raw, False)).statuses == a, b
        assert got.entries() == want.entries(), b
        if b:  # past the empty first batch, readers commit and abort
            assert 0 < sum(x != 0 for x in a[:100]) < 100, b
    assert len(got.entries()) > 1000  # the reads did span many entries


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 1000])
def test_sparse_max_table(n):
    from foundationdb_tpu_torch.resolver.cpu import sparse_max_table

    vers = np.random.default_rng(n).integers(0, 1 << 40, n).tolist()
    table = sparse_max_table(vers)
    for lo in range(0, n, max(1, n // 50)):
        for hi in range(lo + 1, n + 1, max(1, n // 37)):
            k = (hi - lo).bit_length() - 1
            assert max(table[k][lo], table[k][hi - (1 << k)]) == max(
                vers[lo:hi])
