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
