"""Phase-2 operands made from numpy-seeded batches, for the port's phase-2
tests (tests/test_torch_phase2.py on the CPU against the JAX package,
tests/test_torch_phase2_card.py on a CUDA card against the plain version).

A case is a raw batch [(snapshot, reads, writes)] of 8-byte keys. It goes
through the port's own packers: gpu.py's FusedLayout buffer, decoded by
block.decode_fused, for the block/dense kernels' phase 2, and a
ConflictSetRankFed's RankLayout buffer for the rank-fed set's. Nothing
here imports JAX.
"""

import struct

import numpy as np
import torch

from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver import block
from foundationdb_tpu_torch.resolver import packing
from foundationdb_tpu_torch.resolver import rankfed, rankfed_ops
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

N_WORDS = 3            # 9-byte keyAfter ends of 8-byte keys
VERSION = 1000


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def point(a: int):
    return (k8(a), k8(a) + b"\x00")


def txns(raw):
    return [TxnConflictInfo(s, [KeyRange(*r) for r in rr],
                            [KeyRange(*w) for w in wr]) for s, rr, wr in raw]


def random_raw(rng, n: int, space: int = 96, lag: int = 250):
    """n txns of 0-3 reads (point, keyAfter-free spans of 1-6 keys) and
    0-3 writes (points and spans of 1-3 keys) over `space` keys: most
    reads have several potential writers, earlier and later."""
    out = []
    for _ in range(n):
        rr = []
        for a in map(int, rng.integers(0, space, rng.integers(0, 4))):
            rr.append(point(a) if rng.random() < 0.5
                      else (k8(a), k8(a + int(rng.integers(1, 7)))))
        wr = [point(a) if rng.random() < 0.6
              else (k8(a), k8(a + int(rng.integers(1, 4))))
              for a in map(int, rng.integers(0, space, rng.integers(0, 4)))]
        out.append((VERSION - int(rng.integers(0, lag)), rr, wr))
    return out


def chain_raw(length: int):
    """txn i reads what txn i-1 writes: the fixed point settles one link
    per round, so statuses alternate (0, 1, 0, ...)."""
    return [(VERSION - 1, [point(i - 1)] if i else [], [point(i)])
            for i in range(length)]


def undershoot_raw():
    """txn 2 reads what txns 0 and 1 write, txn 3 reads what txn 2
    writes. With txn 0 aborted in phase 1, gpu.py's pointer-jumping seed
    follows txn 2's least potential writer (txn 0) and gets txns 2 and 3
    wrong; the verification loop repairs them in 3 rounds."""
    return [(VERSION - 1, [], [point(10)]),
            (VERSION - 1, [], [point(20)]),
            (VERSION - 1, [point(10), point(20)], [point(30)]),
            (VERSION - 1, [point(30)], [point(40)])]


def readonly_raw(rng, n: int):
    """Reads only: no valid write row."""
    return [(VERSION - 1, [point(int(a)) for a in rng.integers(0, 50, 2)],
             []) for _ in range(n)]


def before_every_write_raw():
    """Txn 1 reads key 1, which sorts before every write endpoint (keys
    5 and up): its rank-fed qb2 is 0, so it stabs nothing."""
    return [(VERSION - 1, [], [point(5), point(7)]),
            (VERSION - 1, [point(1), (k8(4), k8(9))], [point(8)]),
            (VERSION - 1, [point(7)], [])]


# ------------------------------------------------ block/dense kernels

def gpu_operands(raw, caps=None):
    """(arrays, statics) of gpu._phase2_fixed_point for one packed batch:
    arrays q_begin, q_end, s_begin, s_end, rtxn, wtxn, w_valid (torch, CPU,
    decoded from the port's fused buffer), statics T, Wr, P2."""
    pb = packing.pack_batch(txns(raw), 0, N_WORDS, caps=caps)
    lay = pb.layout
    dec = block.decode_fused(torch.from_numpy(pb.buf), lay=lay)
    names = ("q_begin", "q_end", "s_begin", "s_end", "rtxn", None, "wtxn",
             "w_valid")
    arrays = {n: dec[i + 1] for i, n in enumerate(names) if n}
    return arrays, dict(T=lay.T, Wr=lay.Wr, P2=lay.P2)


def gpu_synthetic(rng, T: int, R: int, Wr: int):
    """gpu._phase2_fixed_point operands drawn directly (no packer), for
    shapes the packer's buckets never give (T = 1): every endpoint a
    distinct sorted slot of P2 = 2(R + Wr), begins before ends, rows
    grouped by txn."""
    P2 = 2 * (R + Wr)
    key = rng.integers(0, 4 * P2, size=(R + Wr, 2))
    key.sort(axis=1)
    key[:, 1] += 1
    ends = np.concatenate([key[:, 0], key[:, 1]])
    pos = np.empty(P2, dtype=np.int32)
    pos[np.lexsort((np.arange(P2), ends))] = np.arange(P2, dtype=np.int32)
    qb, sb = pos[:R], pos[R:R + Wr]
    qe, se = pos[R + Wr:2 * R + Wr], pos[2 * R + Wr:]
    rtxn = np.sort(rng.integers(0, T, R)).astype(np.int32)
    wtxn = np.sort(rng.integers(0, T, Wr)).astype(np.int32)
    arrays = dict(q_begin=qb, q_end=qe, s_begin=sb, s_end=se, rtxn=rtxn,
                  wtxn=wtxn, w_valid=rng.random(Wr) < 0.8)
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in arrays.items()}
    return arrays, dict(T=T, Wr=Wr, P2=P2)


def gpu_chain(T: int, aborted=()):
    """gpu._phase2_fixed_point operands of an abort chain of T >= 2 txns
    drawn directly, for any T (the packer's buckets are powers of two):
    txn i writes key i and txn i >= 1 reads key i - 1; key k's four
    sorted slots hold txn k's write begin, txn k+1's read begin and end,
    and the write's end. base_conf is 1 at `aborted`."""
    w = np.arange(T, dtype=np.int32)
    r = np.arange(T - 1, dtype=np.int32)
    arrays = dict(q_begin=4 * r + 1, q_end=4 * r + 2, s_begin=4 * w,
                  s_end=4 * w + 3, rtxn=r + 1, wtxn=w,
                  w_valid=np.ones(T, dtype=bool))
    base = np.zeros(T, dtype=np.int32)
    base[list(aborted)] = 1
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            dict(T=T, Wr=T, P2=4 * T), base)


def chain_operands(T: int) -> dict:
    """phase2.phase2_rounds' index operands (no geometry step) of an abort
    chain of T txns in the rank-fed layout: write w = txn w covers leaf
    2w, read r of txn r stabs leaf 2(r - 1) (read 0 stabs nothing), no
    case-A range. Without a seed the loop settles one link a round: T
    rounds."""
    ar = torch.arange(T, dtype=torch.int32)
    zero = torch.zeros(T, dtype=torch.int32)
    return dict(perm=ar.clone(), lo=zero, hi=zero.clone(), seg_lo=2 * ar,
                seg_hi=2 * ar + 1, n_leaves=2 * T,
                leaf=torch.where(ar > 0, 2 * (ar - 1), -1).to(torch.int32),
                rtxn=ar.clone(), wtxn=ar.clone(),
                w_valid=torch.ones(T, dtype=torch.bool))


# ------------------------------------------------ the rank-fed set

RANK_FIELDS = ("wb2", "we2", "qb2", "loA", "hiA", "perm", "rtxn", "wtxn",
               "w_valid")  # qb2 goes to phase 2 as its stab leaf


def rank_operands(raw, history=(), bucket_min: int = 8):
    """(buf, hv, lay, base_conf, kwargs) of rankfed._phase2_fixed_point
    for one batch packed by a ConflictSetRankFed(device="cpu") after the
    `history` batches, its R, Wr and T rounded up to powers of two from
    `bucket_min` (the packer's own minimum is 8; 1 gives T = 1 for one
    txn): base_conf is phase 1 (history range max against the snapshot,
    tooOld) computed here in numpy from the same buffer."""
    cs = rankfed.ConflictSetRankFed(max_key_bytes=12, initial_capacity=64,
                                    device="cpu")
    v = VERSION - 150   # within the batch's snapshot lag: phase 1 conflicts
    for h in history:
        v += 10
        cs.resolve_packed(v, 0, cs.pack(txns(h)))
    real = rankfed.next_pow2
    rankfed.next_pow2 = lambda x: real(x, minimum=bucket_min)
    try:
        pb = cs.pack(txns(raw))
    finally:
        rankfed.next_pow2 = real
    pb.set_scalars(VERSION - cs.oldest_version, 0)
    pb.buf[pb.layout.off_scalars + 2] = cs.n
    lay, buf = pb.layout, pb.buf
    hv = cs.hv.numpy().copy()

    def sl(name, size):
        off = getattr(lay, "off_" + name)
        return buf[off:off + size]

    R, Wr, T = lay.R, lay.Wr, lay.T
    rank_b, rank_e = sl("rank_b", R), sl("rank_e", R)
    hist = np.array([hv[max(b - 1, 0):e].max() if e > b - 1 else 0
                     for b, e in zip(rank_b, rank_e)], dtype=np.int64)
    read_conf = (hist > sl("rsnap", R)).astype(np.int32)
    base = np.zeros(T, dtype=np.int32)
    np.maximum.at(base, sl("rtxn", R), read_conf)
    base = np.maximum(base, sl("too_old", T))
    sizes = dict(wb2=Wr, we2=Wr, qb2=R, loA=R, hiA=R, perm=Wr, rtxn=R,
                 wtxn=Wr, w_valid=Wr)
    kw = {n: torch.from_numpy(sl(n, sizes[n]).copy()) for n in RANK_FIELDS}
    kw["w_valid"] = kw["w_valid"] != 0
    kw["leaf"] = rankfed_ops.stab_leaf(kw.pop("qb2"), lay.M)
    return buf, hv, lay, torch.from_numpy(base), kw
