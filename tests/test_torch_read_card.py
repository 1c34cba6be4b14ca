"""The storage read gather's CUDA kernel (csrc/read.cu) against its plain
version in storage_engine/read.py, on a card.

Each case takes a storage window's state (a KeyValueStoreGPU built on the
CPU, tests/_torch_read_cases.py), moves it to the card, runs the probe
kernel for bid and pos, and holds read.read_gather's kernel against
read_gather_ref on the same CUDA tensors, aux vector bit for bit, one
launch counted: the CPU test grid, an empty delta, points before the
first key, spans that fill S, key widths of 1 to 16 words and windows of
W2 9 and 17 rows cut from wider ones; then random operands at the
[storage] phase's shape (W2 10, NB 65,536, B 32, 128 ops, S 256, D
2,048). A KeyValueStoreGPU on the card launches the probe and the read
kernel once each a batch, and its trace holds no other kernel. The
kernel has no CPU mode: without a card every case skips. Run on a
machine with a card:

    python -m pytest tests/test_torch_read_card.py -m cuda -q

This file imports no JAX (the JAX differential is tests/test_torch_read.py,
on the CPU).
"""

import numpy as np
import pytest
import torch

from _torch_read_cases import GRID, key, read_operands
from foundationdb_tpu_torch.resolver import probe
from foundationdb_tpu_torch.storage_engine import read
from foundationdb_tpu_torch.storage_engine.gpu_engine import KeyValueStoreGPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the read kernel has no CPU mode")
    return torch.device("cuda")


def cpu_engine(**kw):
    return KeyValueStoreGPU(device="cpu", **kw)


def kernel_vs_plain(card, arrs, q, rv, meta, P, R, S, rows=None):
    """The read kernel against its plain version on the card (the window
    cut to `rows` word rows, the version row kept, when given)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    qall = torch.from_numpy(q)
    if rows is not None:
        keep = [*range(rows - 1), q.shape[0] - 1]
        t[0], t[3], t[4] = (x[keep].contiguous() for x in (t[0], t[3],
                                                             t[4]))
        qall = qall[keep].contiguous()
    hmat, slots, nextsame, fences, dmat, dslots, dnext = (x.to(card)
                                                          for x in t)
    qall, rvt = qall.to(card), torch.from_numpy(rv).to(card)
    bid, pos, _ = probe.probe_ranks(hmat, fences, qall, NB=meta["NB"],
                                    B=meta["B"])
    args = (hmat, slots, nextsame, dmat, dslots, dnext, qall, rvt, bid, pos)
    n0 = read.LAUNCHES["read_gather"]
    got = read.read_gather(*args, P=P, R=R, S=S, **meta)
    torch.cuda.synchronize()
    assert read.LAUNCHES["read_gather"] == n0 + 1
    want = read.read_gather_ref(*args, P=P, R=R, S=S, **meta)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want.cpu())
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("P,R,S,n_delta", GRID)
def test_kernel_equals_plain_version_on_the_grid(card, P, R, S, n_delta):
    arrs, q, rv, meta, _ = read_operands(cpu_engine, P * 7 + R, 2, 120,
                                         n_delta, P, R)
    kernel_vs_plain(card, arrs, q, rv, meta, P, R, S)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_delta", "before_first",
                                  "fill_spans", "wide_span"])
def test_kernel_equals_plain_version_at_the_edges(card, case):
    kw = {"empty_delta": dict(n_delta=0),
          "before_first": dict(n_delta=9, before_first=True),
          "fill_spans": dict(n_delta=30, fill_spans=True),
          "wide_span": dict(n_delta=30, fill_spans=True)}[case]
    S = 512 if case == "wide_span" else 16   # S over a block's threads
    P, R = (300, 5) if case == "wide_span" else (16, 4)
    arrs, q, rv, meta, _ = read_operands(cpu_engine, 31, 2, 400, P=P, R=R,
                                         **kw)
    kernel_vs_plain(card, arrs, q, rv, meta, P, R, S)


@pytest.mark.cuda
@pytest.mark.parametrize("n_words,rows", [(1, None), (2, None), (4, None),
                                          (8, None), (8, 9), (16, None),
                                          (16, 17)])
def test_kernel_equals_plain_version_at_every_key_width(card, n_words, rows):
    """W2 from 3 to 18 rows, and 9 and 17 rows cut from the 10- and
    18-row windows: the kernel's word loop takes any width."""
    arrs, q, rv, meta, _ = read_operands(cpu_engine, 40 + n_words, n_words,
                                         60, 7, 8, 4)
    kernel_vs_plain(card, arrs, q, rv, meta, 8, 4, 16, rows=rows)


@pytest.mark.cuda
def test_kernel_equals_plain_version_at_the_storage_shape(card):
    """Random operands at [storage]'s shape: the kernel's arithmetic does
    not need a sorted window to equal its plain version."""
    g = torch.Generator(device="cpu").manual_seed(7)
    W2, NB, B, D, P, R, S = 10, 65536, 32, 2048, 64, 32, 256

    def rnd(*shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int64).to(torch.int32).to(card)

    hmat, dmat = rnd(W2, NB * B), rnd(W2, D)
    slots, dslots = rnd(NB * B, lo=0, hi=10**6), rnd(D, lo=0, hi=10**6)
    nextsame, dnext = rnd(NB * B, lo=0, hi=2), rnd(D, lo=0, hi=2)
    qall, rv = rnd(W2, P + 2 * R), rnd(R)
    bid = rnd(P + 2 * R, lo=-1, hi=NB + 1)
    pos = rnd(P + 2 * R, lo=0, hi=B)
    args = (hmat, slots, nextsame, dmat, dslots, dnext, qall, rv, bid, pos)
    meta = dict(P=P, R=R, S=S, F=B // 2, NB=NB, B=B)
    got = read.read_gather(*args, **meta)
    want = read.read_gather_ref(*args, **meta)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_window_launches_the_probe_and_the_read_kernel_only(card):
    """A KeyValueStoreGPU on the card answers a batch with one probe and
    one read-kernel launch, and the batch's trace holds those two kernels
    and the copies, no other kernel; its replies equal a CPU window's."""
    from torch.profiler import ProfilerActivity, profile

    engines = [KeyValueStoreGPU(n_words=2, device=d) for d in ("cpu", card)]
    rng = np.random.default_rng(3)
    for v in range(100, 160):
        k = key(int(rng.integers(0, 90)), 2)
        for e in engines:
            e.set(k, b"v%d" % v, v)
    points = [(key(i, 2), 150) for i in range(0, 90, 7)]
    ranges = [(key(10, 2), key(60, 2), 155, 0, False)]
    want = engines[0].read_verdicts(engines[0].submit_reads(points, ranges))
    eng = engines[1]
    eng.read_verdicts(eng.submit_reads(points, ranges))  # warm, folds
    torch.cuda.synchronize()
    n0, r0 = probe.LAUNCHES, read.LAUNCHES["read_gather"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = eng.read_verdicts(eng.submit_reads(points, ranges))
        torch.cuda.synchronize()
    assert got == want
    assert probe.LAUNCHES - n0 == 1
    assert read.LAUNCHES["read_gather"] - r0 == 1
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if "emcpy" not in n and "emset" not in n]
    assert sorted(kernels) == sorted(
        [n for n in kernels if "probe_kernel" in n or "read_kernel" in n])
    assert any("probe_kernel" in n for n in kernels), names
    assert any("read_kernel" in n for n in kernels), names
