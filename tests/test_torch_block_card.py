"""The block kernels of csrc/block.cu (decode, phase 1, phase 3) against
their plain versions in resolver/block.py, on a card.

Every case runs a ConflictSetGPU (or its fast step directly) on the card
with block.py's three dispatchers wrapped: each call launches the kernel
and runs the plain version on copies of the same CUDA tensors, and every
output (the decoded arrays, base_conf, n', st_aux, and hmat, counts and
btree after the in-place merge) must agree bit for bit; the launches are
counted. Statuses and entries() are held against ConflictSetCPU too. The
cases: config-5-like traffic with range reads across many blocks, writes
to history keys and to each other, B of 8 to 64, wide keys, fast steps
with pad rows in the touched list and one at a lower version (a falling
leaf, which takes the level-by-level tree update), a block filled to B -
1, chains at B 512 and 1,024 (the compaction kernels held to their plain
versions too), each of _torch_block_cases.EDGE_CASES (the kernels'
edges: chunk edges, a txn owning many rows, explicit-end runs, covering
and spanning writes, no writes, K = 1, endpoints past the last touched
id, sibling leaves, B 8 to 1,024), the stage stamps, and the wrappers'
refusals. The kernels have no CPU mode: without a
card every case skips. Run on a machine with a card:

    python -m pytest tests/test_torch_block_card.py -m cuda -q

This file imports no JAX (the JAX differential is
tests/test_torch_block.py, on the CPU).
"""

import numpy as np
import pytest
import torch

from _torch_block_cases import (
    EDGE_CASES,
    edge_batch,
    edge_state,
    edge_step_buf,
    fast_buf,
    fill_raw,
    grown,
    history_keys,
    raw_batch,
    txns,
)
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver import block, gpu
from foundationdb_tpu_torch.resolver import packing as ppack
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo
from test_torch_compact_card import CheckedCompact


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block kernels have no CPU mode")
    return torch.device("cuda")


def same(got, want, what):
    assert got.dtype == want.dtype, what
    assert torch.equal(got.cpu(), want.cpu()), what


class Checked:
    """block.decode_fused/phase1/phase3 (what gpu.py calls) wrapped: on a
    CUDA tensor the kernel and the plain version both run (the plain
    version on copies of the in-place state) and must agree; the calls
    are counted by kernel."""

    def __init__(self):
        self.calls = {k: 0 for k in block.LAUNCHES}
        self.fell = 0

    def __enter__(self):
        self._real = (block.decode_fused, block.phase1, block.phase3)
        real_dec, real_p1, real_p3 = self._real

        def dec(fused, *, lay):
            got = real_dec(fused, lay=lay)
            if fused.is_cuda:
                want = block.decode_fused_ref(fused, lay=lay)
                for i, (g, w) in enumerate(zip(got, want)):
                    same(g, w, f"decode output {i}")
                self.calls["decode"] += 1
            return got

        def p1(*args, NB, B):
            got = real_p1(*args, NB=NB, B=B)
            if got.is_cuda:
                same(got, block.phase1_ref(*args, NB=NB, B=B), "base_conf")
                self.calls["phase1"] += 1
            return got

        def p3(hmat, counts, btree, n, **kw):
            if not hmat.is_cuda:
                return real_p3(hmat, counts, btree, n, **kw)
            state = [t.clone() for t in (hmat, counts, btree)]
            ng = kw["g_ids"][: int(kw["n_g"])].long() + kw["NB"]
            old = btree[ng].clone()
            want = block.phase3_ref(*state, n, **kw)
            got = real_p3(hmat, counts, btree, n, **kw)
            for g, w, what in zip((*got, hmat, counts, btree),
                                  (*want, *state),
                                  ("n'", "st_aux", "hmat", "counts",
                                   "btree")):
                same(g, w, what)
            self.fell += bool((btree[ng] < old).any())
            self.calls["phase3"] += 1
            return got

        block.decode_fused, block.phase1, block.phase3 = dec, p1, p3
        self.n0 = dict(block.LAUNCHES)
        return self

    def __exit__(self, *exc):
        block.decode_fused, block.phase1, block.phase3 = self._real

    def launches(self):
        return {k: block.LAUNCHES[k] - self.n0[k] for k in block.LAUNCHES}


def port_txns(raw):
    return txns(raw, TxnConflictInfo, KeyRange)


@pytest.mark.cuda
@pytest.mark.parametrize("B,wide,seed", [(32, 0, 0), (32, 0, 1), (8, 0, 2),
                                         (16, 0, 3), (64, 0, 4),
                                         (32, 24, 5)])
def test_resolver_chain_kernels_equal_plain(card, B, wide, seed):
    """Batches through ConflictSetGPU on the card, fast steps and
    compactions mixed: every kernel call equals its plain version; one
    decode per dispatch, one phase 1 and one phase 3 per fast step."""
    rng = np.random.default_rng(seed)
    most = {8: 6, 16: 16}.get(B, 48)   # small blocks: headroom for the fast path
    old = SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 6
    try:
        cs = gpu.ConflictSetGPU(max_key_bytes=9, initial_capacity=4096,
                                block_slots=B, device=card)
        ora = ConflictSetCPU()
        v = 1000
        with Checked() as chk:
            for i in range(16):
                v += 60
                hot = history_keys(ora) if i else None
                raw = raw_batch(rng, int(rng.integers(2, most)), v, space=2000,
                                lag=150, wide=wide, span=400, hot=hot)
                got = cs.resolve(v, v - 300, port_txns(raw)).statuses
                want = ora.resolve(v, v - 300, port_txns(raw)).statuses
                assert list(got) == list(want), i
        assert cs.entries() == ora.entries()
    finally:
        SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = old
    n = chk.launches()
    assert cs.fast_resolves > 0
    assert n == chk.calls
    assert n["decode"] == cs.fast_resolves + cs.compactions
    assert n["phase1"] == n["phase3"] == cs.fast_resolves


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_steps_with_pad_rows_and_a_falling_leaf(card, seed):
    """The fast step called directly, with pad rows past n_g in the
    touched list, and once at a version below the last one, which lowers
    a touched block's maximum: the kernel then recomputes the tree level
    by level, still equal to the plain version."""
    cs, rng, v = grown(seed, capacity=4096, space=2000, device=card)
    x = [(b"\x00" * 7 + b"\x07\x01", b"\x00" * 7 + b"\x07\x02")]
    one = [(0, [], x)]   # a lone write: its block's maximum, then lowered
    steps = [(50, 3, None), (50, 0, one), (-40, 2, one), (50, 5, None),
             (50, 1, None)]
    with Checked() as chk:
        for dv, extra, raw in steps:
            v += dv
            raw = raw or raw_batch(rng, 12, v, space=2000, lag=100,
                                   hot=history_keys(cs))
            pb = cs.pack(port_txns([(v - 1 if s == 0 else s, r, w)
                                    for s, r, w in raw]))
            buf, K, n_t = fast_buf(cs, pb, v, v - 300, extra_k=extra)
            assert K > n_t or not extra
            fused = torch.from_numpy(buf).to(card)
            cs.n = gpu._resolve_block_kernel_impl(
                cs.hmat, cs.counts, cs.btree, cs.fences, cs.n, fused,
                lay=pb.layout, K=K, NB=cs.NB, B=cs.B)[3]
    assert chk.calls["phase3"] == len(steps)
    assert chk.fell == 1


@pytest.mark.cuda
def test_block_filled_to_b_minus_1(card):
    """A batch that takes one block from fill B/2 to exactly B - 1 takes
    the fast path and leaves the overflow byte clear."""
    cs, rng, v = grown(7, capacity=4096, space=2000, device=card)
    ora_raw = fill_raw(cs, 1, v + 50)
    with Checked() as chk:
        st = cs.resolve(v + 50, v - 300, port_txns(ora_raw)).statuses
    assert list(st) == [0]
    assert chk.calls["phase3"] == 1
    assert int(cs.counts[1]) == cs.B - 1


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    cs, rng, v = grown(3, device=card)
    pb = cs.pack(port_txns(raw_batch(rng, 8, v + 50, space=2000)))
    fused = torch.from_numpy(pb.buf)
    with pytest.raises(ValueError, match="CUDA"):
        block.decode_fused_launch(fused, lay=pb.layout)
    with pytest.raises(TypeError):
        block.decode_fused(fused.to(card).to(torch.int64), lay=pb.layout)
    dec = block.decode_fused(fused.to(card), lay=pb.layout)
    z = torch.zeros((), dtype=torch.int32, device=card)
    kw = dict(smat=dec[0], s_begin=dec[3], s_end=dec[4], wtxn=dec[7],
              w_valid=dec[8], nw=dec[13], conflict=dec[5][:0], too_old=dec[9],
              p2_iters=z, bid=z, lb_loc=z, eq_loc=z, g_ids=z, n_g=z,
              version=z)
    with pytest.raises(ValueError, match="shape"):
        block.phase3(cs.hmat, cs.counts, cs.btree, cs.n, K=1, NB=cs.NB,
                     B=cs.B, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B,seed", [(512, 8), (1024, 9)])
def test_large_blocks_chain_kernels_equal_plain(card, B, seed):
    """Blocks past 256 slots (phase 3 keeps their merge rows in its
    scratch, not in shared memory): a chain of fast steps and compactions
    through ConflictSetGPU on the card, every block and compaction kernel
    call equal to its plain version, statuses and entries() equal to
    ConflictSetCPU's."""
    rng = np.random.default_rng(seed)
    old = SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 4
    try:
        cs = gpu.ConflictSetGPU(max_key_bytes=9, initial_capacity=8 * B,
                                block_slots=B, device=card)
        ora = ConflictSetCPU()
        v = 1000
        with Checked() as chk, CheckedCompact() as cchk:
            for i in range(10):
                v += 60
                hot = history_keys(ora) if i else None
                raw = raw_batch(rng, int(rng.integers(2, 60)), v, space=4000,
                                lag=150, span=600, hot=hot)
                got = cs.resolve(v, v - 300, port_txns(raw)).statuses
                want = ora.resolve(v, v - 300, port_txns(raw)).statuses
                assert list(got) == list(want), i
        assert cs.entries() == ora.entries()
    finally:
        SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = old
    assert cs.fast_resolves > 0 and cs.compactions >= 2
    assert chk.launches() == chk.calls
    assert chk.calls["phase3"] == cs.fast_resolves
    assert cchk.launches() == cchk.calls == {
        k: cs.compactions for k in cchk.calls}


def edge_step(card, case, seed=0):
    """One fast step of an edge case on the card (its state grown there),
    every kernel call held to its plain version; returns the Checked
    block and the step's operands by kernel (decode's fused buffer and
    layout, phase 3's state before the call and keywords)."""
    cs, rng, v = edge_state(case, seed, device=card)
    v += 50
    raw, caps, K, drop_last = edge_batch(case, cs, rng, v)
    pb = ppack.pack_batch(port_txns(raw), cs.oldest_version, cs.n_words,
                          caps=caps)
    buf, K, _ = edge_step_buf(cs, pb, v, v - 300, K, drop_last)
    kept = {}
    with Checked() as chk:
        real_p3 = block.phase3

        def p3(hmat, counts, btree, n, **kw):
            kept["phase3"] = (hmat.clone(), counts.clone(), btree.clone(), n,
                              kw)
            return real_p3(hmat, counts, btree, n, **kw)

        block.phase3 = p3
        fused = torch.from_numpy(buf).to(card)
        out = gpu._resolve_block_kernel_impl(
            cs.hmat, cs.counts, cs.btree, cs.fences, cs.n, fused,
            lay=pb.layout, K=K, NB=cs.NB, B=cs.B)
    kept["decode"] = (fused, pb.layout)
    assert int(out[4][-2]) == 0   # no block overflowed
    return chk, kept


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases_equal_plain(card, case):
    """Each edge case's fast step on the card (both seeds): decode, phase
    1 and phase 3 equal to their plain versions, one launch each."""
    for seed in (0, 1):
        chk, _ = edge_step(card, case, seed)
        assert chk.calls == {"decode": 1, "phase1": 1, "phase3": 1}
        assert chk.launches() == chk.calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["many_writes", "spanning_write", "b512"])
def test_stage_stamps(card, case):
    """decode and phase 3 with a stamp buffer: one stamp at the start and
    one after each stage (block.DECODE_STAGES, PHASE3_STAGES), never
    falling, outputs equal to the plain versions'; a buffer of the wrong
    length is refused."""
    _, kept = edge_step(card, case)
    fused, lay = kept["decode"]
    hmat, counts, btree, n, kw = kept["phase3"]

    def p3(st):
        state = (hmat.clone(), counts.clone(), btree.clone())
        ts = dict(zip(block.PHASE3_OPERANDS, (*state, n, *(
            kw[k] for k in block.PHASE3_OPERANDS[4:]))))
        return (*block.phase3_launch(ts, K=kw["K"], NB=kw["NB"], B=kw["B"],
                                     stamps=st), *state)

    def p3_plain():
        state = (hmat.clone(), counts.clone(), btree.clone())
        return (*block.phase3_ref(*state, n, **kw), *state)

    for stages, run, plain in (
            (block.DECODE_STAGES,
             lambda st: block.decode_fused_launch(fused, lay=lay, stamps=st),
             lambda: block.decode_fused_ref(fused, lay=lay)),
            (block.PHASE3_STAGES, p3, p3_plain)):
        st = torch.full((len(stages) + 1,), -1, dtype=torch.int64,
                        device=card)
        for i, (g, w) in enumerate(zip(run(st), plain())):
            same(g, w, f"{stages[0]} output {i}")
        t = st.cpu()
        assert (t > 0).all() and (t[1:] >= t[:-1]).all(), t
        with pytest.raises(ValueError, match="stamps"):
            run(st[:-1])
