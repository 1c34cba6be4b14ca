"""The rank-fed resolve's CUDA kernels (csrc/rankfed.cu: phase 1 and
phase 3) against their plain versions in resolver/rankfed_ops.py, on a
card.

Each case packs a batch with a ConflictSetRankFed on the CPU at C = 2^12
to 2^14 (tests/_torch_rankfed_cases.py), moves the version vector and
the fused buffer to the card and holds each kernel against its plain
version on the same CUDA tensors, bit for bit, one launch counted: phase
1 as packed and with its edges (rank_b 0, empty ranges, the whole
vector, a window at C), phase 3 on phase 2's vector. Then random
operands at the [rankfed] phase's shape (C 2^23, R 524,288, Wr 131,072,
T 65,536, ub_c sorted into [0, n]); and a ConflictSetRankFed on the card
against one on the CPU over seeded batches: statuses and the version
vector equal, each of phase 1, phase 2 and phase 3 launched once a
batch. The kernels have no CPU mode: without a card every case skips.
Run on a machine with a card:

    python -m pytest tests/test_torch_rankfed_card.py -m cuda -q

This file imports no JAX (the JAX differential is
tests/test_torch_rankfed_kernels.py, on the CPU).
"""

import numpy as np
import pytest
import torch

from _torch_rankfed_cases import (
    edge_ranks,
    phase1_kw,
    phase2_conflict,
    phase3_kw,
    rank_case,
    raw_batch,
    slices,
    txns,
)
from foundationdb_tpu_torch.resolver import phase2, rankfed, rankfed_ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rank-fed kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def on(card, d: dict) -> dict:
    return {k: v.to(card) if torch.is_tensor(v) else v for k, v in d.items()}


def same(got, want):
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("seed,C", [(1, 1 << 12), (2, 1 << 13),
                                    (3, 1 << 14)])
def test_kernels_equal_plain_versions(card, seed, C, edges):
    buf, hv, lay = rank_case(seed, C)
    if edges:
        buf = edge_ranks(buf, lay, seed)
    s = on(card, slices(buf, lay))
    hv_t = torch.from_numpy(hv).to(card)
    kw1 = phase1_kw(s, lay.M)
    n0 = dict(rankfed_ops.LAUNCHES)
    got1 = rankfed_ops.phase1(hv_t, **kw1)
    torch.cuda.synchronize()
    assert rankfed_ops.LAUNCHES["phase1"] == n0["phase1"] + 1
    want1 = rankfed_ops.phase1_ref(hv_t, **kw1)
    same(got1, want1)
    conflict = phase2_conflict(got1[0], s, got1[1], got1[2], lay)
    got3 = rankfed_ops.phase3(hv_t, conflict, **phase3_kw(s))
    torch.cuda.synchronize()
    assert rankfed_ops.LAUNCHES["phase3"] == n0["phase3"] + 1
    want3 = rankfed_ops.phase3_ref(hv_t, conflict, **phase3_kw(s))
    same(got3, want3)
    assert torch.equal(hv_t.cpu(), torch.from_numpy(hv))  # hv only read


@pytest.mark.cuda
def test_kernels_equal_plain_versions_at_the_rankfed_shape(card):
    """Random operands at [rankfed]'s shape; ub_c sorted into [0, n] as
    the host builds it (phase 3's precondition)."""
    g = torch.Generator(device="cpu").manual_seed(11)
    C, R, Wr, T = 1 << 23, 524288, 131072, 65536
    M, n = 2 * Wr, (1 << 23) - 2 * 131072 - 7

    def rnd(size, lo, hi):
        return torch.randint(lo, hi, (size,), generator=g,
                             dtype=torch.int64).to(torch.int32)

    hv = rnd(C, 0, 1 << 20)
    rank_b = rnd(R, 0, n + 1)
    rank_e = torch.clamp(rank_b + rnd(R, -2, 200), 0, n)
    s = dict(rank_b=rank_b, rank_e=rank_e, rsnap=rnd(R, 0, 1 << 20),
             rtxn=torch.sort(rnd(R, 0, T))[0], too_old=rnd(T, 0, 2) * (
                 rnd(T, 0, 50) == 0), qb2=rnd(R, 0, M + 1),
             w_valid=(rnd(Wr, 0, 10) > 0).to(torch.int32))
    s = on(card, s)
    hv = hv.to(card)
    kw1 = dict(s, M=M)
    got1 = rankfed_ops.phase1(hv, **kw1)
    same(got1, rankfed_ops.phase1_ref(hv, **kw1))
    conflict = (rnd(T, 0, 3) == 0).to(torch.int32).to(card)
    wsrc = torch.arange(M, dtype=torch.int32)
    wsrc = ((wsrc % Wr) << 1) | (wsrc < Wr).to(torch.int32)
    kw3 = on(card, dict(wtxn=rnd(Wr, 0, T), w_valid=s["w_valid"].cpu(),
                        ub_c=torch.sort(rnd(M, 0, n + 1))[0], wsrc=wsrc,
                        too_old=s["too_old"].cpu(),
                        scalars=torch.tensor([1 << 21, 1 << 19, n],
                                             dtype=torch.int32)))
    got3 = rankfed_ops.phase3(hv, conflict, **kw3)
    same(got3, rankfed_ops.phase3_ref(hv, conflict, **kw3))


@pytest.mark.cuda
def test_set_on_the_card_equals_the_cpu_set(card):
    """Seeded batches through a ConflictSetRankFed on the card and one on
    the CPU: statuses and the version vector equal after every batch;
    phase 1, phase 2 and phase 3 each launch once a batch."""
    rng = np.random.default_rng(4)
    sets = [rankfed.ConflictSetRankFed(max_key_bytes=8,
                                       initial_capacity=1 << 13, device=d)
            for d in ("cpu", card)]
    version = 1000
    for b in range(6):
        raw = raw_batch(rng, 40, version, 4000)
        n1, n3 = rankfed_ops.LAUNCHES["phase1"], rankfed_ops.LAUNCHES[
            "phase3"]
        p0 = phase2.LAUNCHES
        got = [cs.resolve(version, max(0, version - 500), txns(raw)).statuses
               for cs in sets]
        assert got[0] == got[1], f"batch {b}"
        assert rankfed_ops.LAUNCHES["phase1"] - n1 == 1
        assert rankfed_ops.LAUNCHES["phase3"] - n3 == 1
        assert phase2.LAUNCHES - p0 == 1
        assert torch.equal(sets[0].hv, sets[1].hv.cpu())
        version += int(rng.integers(50, 200))
