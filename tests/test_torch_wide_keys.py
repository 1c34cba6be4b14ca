"""The port's word compares and carries are vectorized, so their op
count does not grow with the key width (the simulator's FuzzApi and
WriteDuringRead write keys of up to 10,000 bytes, 2,501 int32 words).
Each helper equals the JAX package's word loop at the main paths' widths
and far past them, and ConflictSetGPU and KeyValueStoreGPU
(device="cpu") on wide keys equal their oracles."""

import struct

import numpy as np
import pytest
import torch

from foundationdb_tpu.resolver import packing as jpacking
from foundationdb_tpu.resolver import wire as jwire
from foundationdb_tpu.resolver.tpu import _lex_lt_eq as jax_lex_lt_eq
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.kv.versioned_map import VersionedMap
from foundationdb_tpu_torch.resolver import gpu, packing, wire
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo
from foundationdb_tpu_torch.storage_engine.gpu_engine import KeyValueStoreGPU

WIDTHS = [1, 2, 3, 8, 9, 17, 64, 2501]
ALL_ONES = np.array([0xFFFFFFFF], dtype=np.uint32)


def word_rows(rng, w: int, n: int, p_same: float = 0.95):
    """Two (w, n) int32 word matrices equal but for a few words (so the
    first difference falls anywhere, or nowhere)."""
    a = rng.integers(-4, 4, (w, n)).astype(np.int32)
    b = a.copy()
    flip = rng.random((w, n)) > p_same
    b[flip] = rng.integers(-4, 4, int(flip.sum()))
    return a, b


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("or_equal", [False, True])
def test_lex_lt_eq_equals_the_jax_word_loop(w, or_equal):
    import jax.numpy as jnp

    rng = np.random.default_rng(w)
    for n in (1, 5, 300):
        a, b = word_rows(rng, w, n, p_same=1 - 1 / w)
        lt, eq = gpu._lex_lt_eq(torch.from_numpy(a), torch.from_numpy(b),
                                or_equal)
        jlt, jeq = jax_lex_lt_eq(jnp.asarray(a), jnp.asarray(b), or_equal)
        assert np.array_equal(lt.numpy(), np.asarray(jlt)), (w, n)
        assert np.array_equal(eq.numpy(), np.asarray(jeq)), (w, n)


@pytest.mark.parametrize("w", WIDTHS)
def test_incr_packed_keys_equals_the_jax_package(w):
    rng = np.random.default_rng(100 + w)
    top = (ALL_ONES ^ np.uint32(packing.BIAS)).view(np.int32)[0]
    for n in (0, 1, 40):
        words = rng.integers(-4, 4, (n, w)).astype(np.int32)
        # runs of all-ones words at the tail carry into the words before
        tail = rng.integers(0, w + 1, n)
        for i, t in enumerate(tail):
            words[i, w - t:] = top
        got, over = packing.incr_packed_keys(words)
        want, wover = jpacking.incr_packed_keys(words)
        assert np.array_equal(got, want) and np.array_equal(over, wover)


@pytest.mark.parametrize("w", WIDTHS)
def test_wire_lex_lt_equals_the_jax_package(w):
    rng = np.random.default_rng(200 + w)
    for n in (0, 1, 50):
        a, b = word_rows(rng, w, n, p_same=1 - 1 / w)
        al, bl = rng.integers(0, 4, n), rng.integers(0, 4, n)
        assert np.array_equal(wire._lex_lt(a.T.copy(), al, b.T.copy(), bl),
                              jwire._lex_lt(a.T.copy(), al, b.T.copy(), bl))


def wide_key(rng, space: int = 24) -> bytes:
    """A key of 40 to 10,000 bytes: a long shared prefix, then a small
    integer, so keys collide and compare deep into their words."""
    prefix = b"fuzz/" * int(rng.choice([8, 80, 800, 1998]))
    return prefix + struct.pack(">I", int(rng.integers(0, space)))


def test_conflict_set_on_wide_keys_equals_the_oracle():
    rng = np.random.default_rng(7)
    cs = gpu.ConflictSetGPU(device="cpu")
    oracle = ConflictSetCPU()
    v = 100
    for _ in range(6):
        v += 50
        txns = []
        for _ in range(12):
            rr = []
            for _ in range(int(rng.integers(0, 3))):
                k = wide_key(rng)
                rr.append(KeyRange(k, k + b"\x00")
                          if rng.random() < 0.5 else
                          KeyRange(k, k[:-1] + b"\xff\xff"))
            wr = [KeyRange(k, k + b"\x00")
                  for k in (wide_key(rng)
                            for _ in range(int(rng.integers(0, 3))))]
            txns.append(TxnConflictInfo(v - int(rng.integers(0, 80)),
                                        rr, wr))
        got = cs.resolve(v, v - 120, txns)
        want = oracle.resolve(v, v - 120, txns)
        assert list(map(int, got.statuses)) == list(want.statuses)
    assert max(len(k) for k, _ in cs.entries()) > 9000
    assert cs.entries() == oracle.entries()


def test_storage_window_on_wide_keys_equals_the_oracle():
    rng = np.random.default_rng(11)
    eng = KeyValueStoreGPU(device="cpu")
    oracle = VersionedMap()
    keys = sorted({wide_key(rng, space=40) for _ in range(60)})
    v = 10
    for step in range(80):
        k = keys[int(rng.integers(0, len(keys)))]
        if rng.random() < 0.8:
            eng.set(k, b"v%d" % step, v)
            oracle.set(k, b"v%d" % step, v)
        else:
            eng.clear(k, v)
            oracle.clear(k, v)
        v += 1
    for rv in (v - 30, v):
        pts = [(k, rv) for k in keys]
        rngs = [(keys[0], keys[-1], rv, 1000, False),
                (keys[3], keys[20], rv, 5, True)]
        pv, rv_rows = eng.read_verdicts(eng.submit_reads(pts, rngs))
        assert pv == [oracle.get(k, r) for k, r in pts]
        assert rv_rows == [oracle.get_range(b, e, r, lim, rev)
                           for b, e, r, lim, rev in rngs]
    assert eng.entries() == oracle.entries()
