"""The port's packing and wire codecs against the JAX package's.

foundationdb_tpu_torch keeps its own copies of resolver/packing.py and
resolver/wire.py (it imports nothing of foundationdb_tpu); the fused
buffers they build must equal the JAX package's bit for bit, or the two
kernels would not see the same batch. The port sorts endpoints with
np.lexsort only; the JAX package may take its native radix sort on large
batches, so one case is large enough to reach it.
"""

import struct

import numpy as np
import pytest

from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver import packing as jpack
from foundationdb_tpu.resolver import wire as jwire
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import packing as ppack
from foundationdb_tpu_torch.resolver import wire as pwire
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def raw_batch(rng, n, version, space=300, lag=400):
    """(snapshot, reads, writes) rows with every end mode: keyAfter point
    ranges, integer-increment ranges [k, k+1), explicit wide ends, empty
    ranges (dropped at admission) and variable-length keys."""
    out = []
    for _ in range(n):
        rr, wr = [], []
        for a in map(int, rng.integers(0, space, rng.integers(0, 4))):
            kind = int(rng.integers(0, 4))
            if kind == 0:
                rr.append((k8(a), k8(a) + b"\x00"))
            elif kind == 1:
                rr.append((k8(a), k8(a + 1)))
            elif kind == 2:
                rr.append((k8(a), k8(a + int(rng.integers(2, 9)))))
            else:
                rr.append((k8(a)[: int(rng.integers(1, 8))], k8(a)))
        for a in map(int, rng.integers(0, space, rng.integers(0, 3))):
            if rng.random() < 0.1:
                wr.append((k8(a + 3), k8(a)))  # empty: begin > end
            elif rng.random() < 0.5:
                wr.append((k8(a), k8(a) + b"\x00"))
            else:
                wr.append((k8(a), k8(a + int(rng.integers(1, 4)))))
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def both(raw):
    j = [JTxn(s, [JKeyRange(*r) for r in rr], [JKeyRange(*w) for w in wr])
         for s, rr, wr in raw]
    p = [PTxn(s, [PKeyRange(*r) for r in rr], [PKeyRange(*w) for w in wr])
         for s, rr, wr in raw]
    return j, p


def assert_same_packed(a, b):
    assert a.layout.key() == b.layout.key()
    assert a.buf.dtype == b.buf.dtype == np.int32
    np.testing.assert_array_equal(a.buf, b.buf)
    for f in ("n_txns", "base", "n_reads", "n_writes", "n_expl_r", "n_expl_w"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.wb_enc, b.wb_enc)
    np.testing.assert_array_equal(a.we_enc, b.we_enc)


@pytest.mark.parametrize("seed,n,n_words,oldest", [
    (0, 40, 3, 0),        # keyAfter / increment / explicit ends
    (1, 60, 4, 800),      # tooOld txns (snapshot below the horizon)
    (2, 0, 2, 0),         # empty batch
    (3, 1500, 3, 600),    # > 4096 endpoints: the JAX side's native sort
])
def test_pack_batch_bit_identical(seed, n, n_words, oldest):
    rng = np.random.default_rng(seed)
    jt, pt = both(raw_batch(rng, n, 1000))
    for caps in (None, (64, 32, 128)):
        assert_same_packed(
            jpack.pack_batch(jt, oldest, n_words, caps=caps),
            ppack.pack_batch(pt, oldest, n_words, caps=caps),
        )


def test_wire_round_trip_and_pack_bit_identical():
    """The port reads the JAX package's wire bytes, writes the same bytes,
    and packs them (sticky caps included) into the same buffers."""
    rng = np.random.default_rng(7)
    jsticky, psticky = jpack.StickyCaps(), ppack.StickyCaps()
    for b in range(4):
        jt, _ = both(raw_batch(rng, 50 + 20 * b, 2000))
        jwb = jwire.WireBatch.from_txns(jt)
        data = jwb.to_bytes()
        pwb = pwire.WireBatch.from_bytes(data)
        assert pwb.to_bytes() == data
        assert pwb.max_key_len() == jwb.max_key_len()
        assert (pwire.chunk_bounds(pwb, 17, 40)
                == jwire.chunk_bounds(jwb, 17, 40))
        assert_same_packed(
            jwire.pack_wire(jwb, 1500, 3, jsticky),
            pwire.pack_wire(pwb, 1500, 3, psticky),
        )
        assert jsticky.caps_for(jwb.n_txns) == psticky.caps_for(pwb.n_txns)


def test_wire_and_object_paths_agree_in_the_port():
    rng = np.random.default_rng(11)
    _, pt = both(raw_batch(rng, 80, 1000))
    assert_same_packed(
        ppack.pack_batch(pt, 700, 3),
        pwire.pack_batch_wire(pwire.WireBatch.from_txns(pt), 700, 3),
    )


def test_to_txns_decodes_like_the_jax_package():
    """WireBatch.to_txns (the oracle's decode) gives the txns the JAX
    package's gives for the same wire bytes, and a chunk of a batch
    decodes to the matching slice."""
    rng = np.random.default_rng(13)
    jt, pt = both(raw_batch(rng, 90, 3000))
    data = jwire.WireBatch.from_txns(jt).to_bytes()
    jwb = jwire.WireBatch.from_bytes(data)
    pwb = pwire.WireBatch.from_bytes(data)
    want = jwb.to_txns()
    got = pwb.to_txns()
    assert [(t.read_snapshot, [(r.begin, r.end) for r in t.read_ranges],
             [(w.begin, w.end) for w in t.write_ranges]) for t in got] == [
        (t.read_snapshot, [(r.begin, r.end) for r in t.read_ranges],
         [(w.begin, w.end) for w in t.write_ranges]) for t in want]
    assert all(type(t.read_snapshot) is int for t in got)
    assert pwb.slice(30, 55).to_txns() == got[30:55]


def test_block_state_helpers_identical():
    for n_words, NB, B in ((2, 8, 8), (3, 16, 32)):
        for a, b in zip(jpack.empty_block_state(n_words, NB, B, 77),
                        ppack.empty_block_state(n_words, NB, B, 77)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    words, lens = ppack.pack_keys([k8(int(x)) for x in rng.integers(0, 99, 20)], 3)
    np.testing.assert_array_equal(
        jpack.encode_packed_words(words, lens),
        ppack.encode_packed_words(words, lens),
    )
    h = ppack.empty_state(2, 64, 5)
    np.testing.assert_array_equal(ppack.widen_state(h, 2, 4),
                                  jpack.widen_state(h, 2, 4))
    assert [ppack.next_bucket(x) for x in range(1, 3000, 37)] == [
        jpack.next_bucket(x) for x in range(1, 3000, 37)
    ]
