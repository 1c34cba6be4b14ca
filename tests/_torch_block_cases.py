"""Batches and states for the block kernels' tests (tests/test_torch_block.py
on the CPU against the JAX package, tests/test_torch_block_card.py on a
card against the plain versions). Imports no JAX.

Batches are raw tuples (snapshot, read ranges, write ranges) of byte
keys, made from a numpy seed, so that either package's classes can be
built from them.
"""

import struct

import numpy as np

from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.resolver import gpu
from foundationdb_tpu_torch.resolver import packing as ppack


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def raw_batch(rng, n, version, space=400, lag=250, wide=0, span=0,
              hot=None):
    """n txns over 8-byte integer keys in [0, space): 0-3 reads each
    (keyAfter, increment or explicit ends; with `span`, one read in four
    spans up to `span` keys, across many blocks), 0-2 writes each (point
    or short ranges; with `hot`, one in three writes a key of `hot`, so
    that writes meet history keys and each other). `wide` adds up to that
    many random bytes to a third of the write begins."""
    out = []
    for _ in range(n):
        rr = []
        for a in map(int, rng.integers(0, space, rng.integers(0, 4))):
            kind = int(rng.integers(0, 4 if span else 3))
            end = (k8(a) + b"\x00", k8(a + 1),
                   k8(a + int(rng.integers(2, 7))),
                   k8(a + int(rng.integers(2, max(span, 3)))))[kind]
            rr.append((k8(a), end))
        wr = []
        for a in map(int, rng.integers(0, space, rng.integers(0, 3))):
            if hot is not None and rng.random() < 0.34:
                a = int(hot[int(rng.integers(0, len(hot)))])
            b = k8(a)
            if wide and rng.random() < 0.34:
                b += bytes(rng.integers(0, 256, int(rng.integers(1, wide + 1)),
                                        dtype=np.uint8))
            e = (b + b"\x00" if rng.random() < 0.7
                 else k8(a + int(rng.integers(1, 4))))
            wr.append((b, max(e, b + b"\x00")))
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def txns(raw, txn_cls, range_cls):
    return [txn_cls(s, [range_cls(*r) for r in rr],
                    [range_cls(*w) for w in wr]) for s, rr, wr in raw]


def grown(seed, *, B=32, max_key_bytes=9, capacity=2048, n_batches=4,
          space=400, wide=0, device="cpu"):
    """A port conflict set after a few random batches (txns built with the
    port's classes), the last one a compaction (every block at fill B/2,
    so small batches take the fast path), mirror fresh. Returns (cs, rng,
    version)."""
    from foundationdb_tpu_torch.kv.keys import KeyRange
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    rng = np.random.default_rng(seed)
    old = SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 3
    try:
        cs = gpu.ConflictSetGPU(max_key_bytes=max_key_bytes,
                                initial_capacity=capacity, block_slots=B,
                                device=device)
        v = 1000
        for i in range(n_batches):
            v += 100
            if i == n_batches - 1:
                cs._since_compact = 10**9
            cs.resolve(v, v - 400, txns(raw_batch(rng, 30, v, space,
                                                  wide=wide),
                                        TxnConflictInfo, KeyRange))
    finally:
        SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = old
    cs._refresh_mirror()
    return cs, rng, v


def history_keys(cs, limit=64):
    """Integer keys of the set's 8-byte history entries (writes to them
    meet history keys)."""
    ks = [k for k, _ in cs.entries() if len(k) == 8][:limit]
    return np.array([struct.unpack(">Q", k)[0] for k in ks] or [0])


def fast_buf(cs, pb, version, oldest, extra_k=0):
    """The fast path's fused buffer exactly as resolve_async builds it,
    with `extra_k` more pad rows in the touched-block list. Returns (buf,
    K, n_touched)."""
    touched, _ = gpu._touched_blocks(cs._fences_enc, pb.wb_enc, pb.we_enc,
                                     pb.n_writes)
    K = min(ppack.next_bucket(max(len(touched), 1)) + extra_k, cs.NB)
    buf = gpu.block_step_buf(pb.buf, pb.layout, touched, K, cs.NB,
                             version - cs._base, oldest - cs._base,
                             pb.base - cs._base)
    return buf, K, len(touched)


def fill_raw(cs, blk, version):
    """One txn whose writes take block `blk` (live, at fill F) to exactly
    B - 1 entries: a chain of ranges [u_i, u_i+1) over B - 1 - F novel
    keys, each the block's fence key extended by two bytes (between the
    fence and the block's next integer key)."""
    fw = cs.fences.cpu().numpy()
    key = ppack.unpack_key(fw[: cs.n_words, blk], int(fw[cs.n_words, blk]))
    n_new = cs.B - 1 - int(cs._fills[blk])
    us = [key + bytes([1, i + 1]) for i in range(n_new)]
    return [(version - 1, [], list(zip(us[:-1], us[1:])))]


# ------------------------------------------------- the kernels' edges

# The layout of the edge cases' larger batches (minimum R, Wr, T, Er, Ew):
# room for 300 txns of 3 reads and 2 writes, every end explicit, and one
# txn of 600 reads; the decode's and phase 3's grids then span several
# blocks and chunks on a card.
EDGE_CAPS = (1280, 640, 320, 1280, 640)
SMALL_CAPS = (100, 64, 64, 32, 32)   # P2 352 past the rows' 336 slots

# One fast step from a grown state for each edge of the block kernels
# (csrc/block.cu's decode and phase 3): name -> B.
EDGE_CASES = {
    # write endpoints many enough that their compacted runs cross the
    # chunk edges of phase 3's scan (and the decode's rows, its txns)
    "many_writes": 32,
    # a txn of 600 reads and 2 writes between txns owning no rows
    "big_txn_among_empty": 32,
    # every read and write end explicit, in runs across the row chunks
    "explicit_runs": 32,
    # a write range covering whole blocks: touched blocks with no
    # endpoint of their own, their entries all covered
    "covering_write": 32,
    # one write whose end is the first endpoint of its touched block and
    # the last compacted slot (its begin the first at c = 0)
    "spanning_write": 32,
    # no writes (nw = 0: every write row a pad, no touched block)
    "no_writes": 32,
    # every write in one block, K = 1
    "one_block": 32,
    # the touched list without its last block (K = n_g, no pad rows): that
    # block's endpoints lie past the last touched id and clip into it
    "clip_past_last": 32,
    # two touched leaves that are siblings: every ancestor shared
    "siblings": 32,
    # a write in every live block: more touched leaves than a warp holds,
    # in runs that merge into one a few levels up the tree
    "many_leaves": 8,
    # block sizes: the merge areas in shared memory (8) and in the
    # scratch (512, 1,024)
    "b8": 8,
    "b512": 512,
    "b1024": 1024,
}


def edge_state(name, seed, device="cpu"):
    """The grown state of an edge case: (cs, rng, version)."""
    B = EDGE_CASES[name]
    return grown(seed, B=B, capacity=max(4096, 8 * B), space=2000,
                 device=device)


def block_key(cs, blk, i):
    """A novel key inside live block blk: its fence key extended."""
    fw = cs.fences.cpu().numpy()
    key = ppack.unpack_key(fw[: cs.n_words, blk], int(fw[cs.n_words, blk]))
    return key + bytes([1, i + 1])


def edge_batch(name, cs, rng, v):
    """The edge case's batch at version v: (raw, caps, K or None for the
    fast path's own, drop_last: the touched list without its last
    block)."""
    hot = history_keys(cs)
    if name == "many_writes":   # writes in one txn of 8: no block fills
        raw = raw_batch(rng, 300, v, space=2000, lag=150, hot=hot)
        return [(s, rr, wr if i % 8 == 0 else [])
                for i, (s, rr, wr) in enumerate(raw)], EDGE_CAPS, 64, False
    if name == "big_txn_among_empty":
        big = [(k8(a), k8(a) + b"\x00")
               for a in rng.integers(0, 2000, 600)]
        w = [(k8(int(hot[1])), k8(int(hot[1]) + 1))]
        raw = ([(v - 5, [], [])] * 40 + [(v - 3, big, w)]
               + [(v - 5, [], [])] * 40
               + raw_batch(rng, 30, v, space=2000, lag=150))
        return raw, EDGE_CAPS, 64, False
    if name == "explicit_runs":
        raw = []
        for i in range(300):
            a = [int(x) for x in rng.integers(0, 2000, 4)]
            raw.append((v - int(rng.integers(0, 150)),
                        [(k8(x), k8(x + 3)) for x in a[:3]],
                        [(k8(a[3]), k8(a[3] + 2))] if i % 12 == 0 else []))
        return raw, EDGE_CAPS, 64, False
    if name == "covering_write":
        a = int(hot[2])
        return (raw_batch(rng, 20, v, space=2000, lag=150)
                + [(v - 1, [], [(k8(a), k8(a + 700))])]), SMALL_CAPS, 64, \
            False
    if name == "spanning_write":
        return [(v - 1, [], [(block_key(cs, 3, 0), block_key(cs, 5, 0))])], \
            SMALL_CAPS, 8, False
    if name == "no_writes":
        raw = raw_batch(rng, 20, v, space=2000, lag=150, span=300)
        return [(s, rr, []) for s, rr, _ in raw], SMALL_CAPS, 8, False
    if name == "one_block":
        ws = [(block_key(cs, 4, i), block_key(cs, 4, i + 1))
              for i in range(0, 6, 2)]
        return [(v - 1, [], ws[:2]), (v - 2, ws[2:], ws[2:])], SMALL_CAPS, \
            1, False
    if name == "clip_past_last":
        ws = [(block_key(cs, b, 0), block_key(cs, b, 1)) for b in (2, 6, 9)]
        return [(v - 1, [], ws)], SMALL_CAPS, 2, True
    if name == "siblings":
        ws = [(block_key(cs, b, i), block_key(cs, b, i + 1))
              for b in (6, 7) for i in (0, 2)]
        return [(v - 1, [], ws[:2]), (v - 1, ws[:1], ws[2:])], SMALL_CAPS, \
            8, False
    if name == "many_leaves":   # two novel keys a block: no block fills
        fw = cs.fences.cpu().numpy()
        live = int((fw[cs.n_words] != ppack.PAD_WORD).sum())
        ws = [(block_key(cs, b, 0), block_key(cs, b, 1))
              for b in range(1, live)]   # block 0's fence is the empty key
        return [(v - 1 - i, [], ws[i::4]) for i in range(4)], SMALL_CAPS, \
            None, False
    # the block sizes: a few txns, few enough that no block overflows
    return raw_batch(rng, 6, v, space=2000, lag=150, hot=hot), SMALL_CAPS, \
        None, False


def edge_step_buf(cs, pb, version, oldest, K, drop_last):
    """The fast step's fused buffer of an edge case (fast_buf's, with the
    case's K and touched list). Returns (buf, K, n_touched)."""
    touched, _ = gpu._touched_blocks(cs._fences_enc, pb.wb_enc, pb.we_enc,
                                     pb.n_writes)
    if drop_last:
        touched = touched[:-1]
    if K is None:
        K = min(ppack.next_bucket(max(len(touched), 1)), cs.NB)
    assert len(touched) <= K
    buf = gpu.block_step_buf(pb.buf, pb.layout, touched, K, cs.NB,
                             version - cs._base, oldest - cs._base,
                             pb.base - cs._base)
    return buf, K, len(touched)


def positions_out_of_range(buf, lay):
    """Move some rows' sorted positions where packing.py never puts them
    (the decode's exactness there): past P2 and below -P2 (dropped), and
    into the slots [2 (R + Wr), P2) that no row owns (wrapped from a
    negative one too), which leaves the rows' own slots empty. Needs
    P2 >= 2 (R + Wr) + 5 and 4 reads and a write."""
    assert lay.P2 >= 2 * (lay.R + lay.Wr) + 5
    buf = buf.copy()
    buf[lay.off_q_begin + 0] = lay.P2 + 3
    buf[lay.off_q_end + 1] = -(lay.P2 + 2)
    buf[lay.off_q_end + 2] = lay.P2 - 1
    buf[lay.off_q_begin + 3] = -5
    buf[lay.off_s_begin + 0] = lay.P2
    return buf
