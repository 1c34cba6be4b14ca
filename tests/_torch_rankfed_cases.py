"""Operands of the rank-fed resolve's kernels (resolver/rankfed_ops.py
phase1 and phase3, around phase 2) made by the port's own packer: a
ConflictSetRankFed(device="cpu") of capacity C is filled by seeded
history batches, then one more batch is packed into its fused RankLayout
buffer. For tests/test_torch_rankfed_kernels.py (against the JAX
package's rankfed._rank_kernel_impl on the CPU) and
tests/test_torch_rankfed_card.py (each CUDA kernel against its plain
version). Nothing here imports JAX.
"""

import struct

import numpy as np
import torch

from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver import rankfed
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def raw_batch(rng, n: int, version: int, space: int, lag: int = 400):
    """n txns of 0-4 reads and 0-3 writes (points and spans of up to 40
    keys) over `space` keys, snapshots up to `lag` behind `version`."""
    out = []
    for _ in range(n):
        rr, wr = [], []
        for a in map(int, rng.integers(0, space, rng.integers(0, 5))):
            rr.append((k8(a), k8(a + int(rng.integers(1, 40)))))
        for a in map(int, rng.integers(0, space, rng.integers(0, 4))):
            wr.append((k8(a), k8(a + int(rng.integers(1, 4)))))
        out.append((version - int(rng.integers(1, lag)), rr, wr))
    return out


def txns(raw):
    return [TxnConflictInfo(s, [KeyRange(*r) for r in rr],
                            [KeyRange(*w) for w in wr]) for s, rr, wr in raw]


def rank_case(seed: int, C: int, n_txn: int = 48, history: int = 6):
    """(buf, hv, lay) of one batch: a ConflictSetRankFed of capacity C
    after `history` batches (its GC cadence left at the knob's), the
    batch's scalars set as resolve_async sets them. buf and hv are numpy
    copies."""
    rng = np.random.default_rng(seed)
    space = C // 2
    cs = rankfed.ConflictSetRankFed(max_key_bytes=8, initial_capacity=C,
                                    device="cpu")
    version = 1000
    for _ in range(history):
        raw = raw_batch(rng, n_txn, version, space)
        cs.prepare(txns(raw))
        cs.resolve_packed(version, max(0, version - 600),
                          cs.pack(txns(raw)))
        version += int(rng.integers(50, 200))
    raw = raw_batch(rng, n_txn, version, space)
    cs.prepare(txns(raw))
    pb = cs.pack(txns(raw))
    oldest = max(0, version - 600)
    pb.set_scalars(version - cs.oldest_version,
                   max(oldest, cs.oldest_version) - cs.oldest_version)
    pb.buf[pb.layout.off_scalars + 2] = cs.n
    return pb.buf.copy(), cs.hv.numpy().copy(), pb.layout


def slices(buf, lay) -> dict:
    """The fused buffer's segments by name (torch views of one tensor)."""
    t = torch.from_numpy(buf)
    sizes = dict(rank_b=lay.R, rank_e=lay.R, loA=lay.R, hiA=lay.R,
                 qb2=lay.R, rtxn=lay.R, rsnap=lay.R, perm=lay.Wr,
                 wb2=lay.Wr, we2=lay.Wr, wtxn=lay.Wr, w_valid=lay.Wr,
                 ub_c=lay.M, wsrc=lay.M, too_old=lay.T, scalars=3)
    return {n: t[getattr(lay, "off_" + n):getattr(lay, "off_" + n) + k]
            for n, k in sizes.items()}


def phase1_kw(s: dict, M: int) -> dict:
    return dict(rank_b=s["rank_b"], rank_e=s["rank_e"], rsnap=s["rsnap"],
                rtxn=s["rtxn"], too_old=s["too_old"], qb2=s["qb2"],
                w_valid=s["w_valid"], M=M)


def phase3_kw(s: dict) -> dict:
    return dict(wtxn=s["wtxn"], w_valid=s["w_valid"], ub_c=s["ub_c"],
                wsrc=s["wsrc"], too_old=s["too_old"], scalars=s["scalars"])


def edge_ranks(buf, lay, seed: int):
    """A copy of buf whose reads' history ranks take phase 1's edges:
    rank_b 0 (the window from -1 clips to 0), empty ranges (rank_e <
    rank_b - 1 and rank_e == rank_b - 1), a range over the whole vector
    [0, C] and windows touching C."""
    rng = np.random.default_rng(seed)
    buf = buf.copy()
    R, C = lay.R, lay.C
    rb = buf[lay.off_rank_b:lay.off_rank_b + R]
    re = buf[lay.off_rank_e:lay.off_rank_e + R]
    rb[:] = rng.integers(0, C + 1, R)
    re[:] = np.minimum(rb + rng.integers(-3, 3 * C // 4, R), C)
    k = R // 6
    rb[:k] = 0                                   # lo -1
    re[k:2 * k] = rb[k:2 * k] - 1                # empty: hi == lo
    re[2 * k:3 * k] = np.maximum(rb[2 * k:3 * k] - 5, 0)  # hi < lo
    rb[3 * k], re[3 * k] = 0, C                  # the whole vector
    rb[3 * k + 1], re[3 * k + 1] = C, C          # a window at C
    return buf


def phase2_conflict(base_conf, s: dict, leaf, valid, lay):
    """Phase 2's vector from phase 1's outputs (the port's plain rounds
    on the CPU, its kernel on the card)."""
    return rankfed._phase2_fixed_point(
        base_conf, wb2=s["wb2"], we2=s["we2"], leaf=leaf, loA=s["loA"],
        hiA=s["hiA"], perm=s["perm"], rtxn=s["rtxn"], wtxn=s["wtxn"],
        w_valid=valid, T=lay.T, M=lay.M)
