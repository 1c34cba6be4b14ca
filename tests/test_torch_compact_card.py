"""The compaction kernels of csrc/compact.cu (densify, ranks, dense phase 3,
redistribute) against their plain versions in resolver/compact.py, on a
card.

Every case runs gpu.py's dense or compaction kernel (or a whole
ConflictSetGPU) on the card with compact.py's four dispatchers wrapped:
each call launches the kernel and runs the plain version on the same
CUDA tensors (redistribute's in-place st_aux on a copy), and every output
must agree bit for bit; the launches are counted, one of each kernel per
compaction. The whole result is held against the same function on CPU
tensors too. The cases are tests/_torch_compact_cases.py's: an empty
history, a full dense state (the rank walk's saturation, phase 3's
overflow), reads with rank_b = 0, pad queries, wide keys, equal-key runs
across block boundaries, growing and shrinking compactions, a fill layout
too small for the set, B of 8, 32 and 512, n = C - 1, a batch of pad
write endpoints only, n + 2 Wr at a chunk boundary of phase 3's grid, a
block past B entries, an empty state and an equal-key run over blocks
with empty blocks between; a chain through ConflictSetGPU against
ConflictSetCPU; ranks on states of 2^16 columns (wide brackets, one
history gap, endpoints above the last key, n = 0, C - 1 and C, reads over
most of n) with the tier each run took, both tiers seen; redistribute at
the edges of new_n for B 8, 32, 512 and NB_out 8, 2^16; and every
kernel's stage stamps. The kernels have no CPU mode:
without a card every case skips. Run on a machine with a card:

    python -m pytest tests/test_torch_compact_card.py -m cuda -q

This file imports no JAX (the JAX differential is
tests/test_torch_compact.py, on the CPU).
"""

import numpy as np
import pytest
import torch

from _torch_block_cases import history_keys, raw_batch
from _torch_compact_cases import (
    BLOCK_CASES,
    DENSE_CASES,
    RANKS_CASE_TIER,
    RANKS_CASES,
    REDIST_NEW_N,
    block_case,
    dense_case,
    port_txns,
    ranks_case,
    redist_case,
)
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.resolver import compact, gpu
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the compaction kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def same(got, want, what):
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert torch.equal(got.cpu(), want.cpu()), what


class CheckedCompact:
    """compact.densify/ranks/dense_phase3/redistribute (what gpu.py calls)
    wrapped: on a CUDA tensor the kernel and the plain version both run
    and must agree; the calls are counted by kernel."""

    KERNELS = ("densify", "ranks", "dense_phase3", "redistribute")

    def __init__(self):
        self.calls = {k: 0 for k in compact.LAUNCHES}

    def __enter__(self):
        self._real = tuple(getattr(compact, k) for k in self.KERNELS)
        dens, ranks, p3, red = self._real

        def d(hmat, counts, *, B):
            got = dens(hmat, counts, B=B)
            if hmat.is_cuda:
                want = compact.densify_ref(hmat, counts, B=B)
                for i, (g, w) in enumerate(zip(got, want)):
                    same(g, w, f"densify output {i}")
                self.calls["densify"] += 1
            return got

        def r(*args):
            got = ranks(*args)
            if args[0].is_cuda:
                want = compact.ranks_ref(*args)
                for g, w, what in zip(got, want, ("ub", "eq", "base_conf")):
                    same(g, w, what)
                self.calls["ranks"] += 1
            return got

        def p(hmat, n, **kw):
            got = p3(hmat, n, **kw)
            if hmat.is_cuda:
                want = compact.dense_phase3_ref(hmat, n, **kw)
                for g, w, what in zip(got, want, ("hmat_out", "new_n",
                                                  "st_aux")):
                    same(g, w, what)
                self.calls["dense_phase3"] += 1
            return got

        def rd(hmat_d, new_n, st_aux, *, NB_out, B):
            if not hmat_d.is_cuda:
                return red(hmat_d, new_n, st_aux, NB_out=NB_out, B=B)
            st2 = st_aux.clone()
            want = compact.redistribute_ref(hmat_d, new_n, st2,
                                            NB_out=NB_out, B=B)
            got = red(hmat_d, new_n, st_aux, NB_out=NB_out, B=B)
            for g, w, what in zip((*got, st_aux), (*want, st2),
                                  ("hmat", "counts", "btree", "fences",
                                   "st_aux")):
                same(g, w, what)
            self.calls["redistribute"] += 1
            return got

        for k, f in zip(self.KERNELS, (d, r, p, rd)):
            setattr(compact, k, f)
        self.n0 = dict(compact.LAUNCHES)
        return self

    def __exit__(self, *exc):
        for k, f in zip(self.KERNELS, self._real):
            setattr(compact, k, f)

    def launches(self):
        return {k: compact.LAUNCHES[k] - self.n0[k] for k in compact.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_cases_equal_plain(card, case):
    hm, n, pb = dense_case(case)
    args = (torch.from_numpy(hm), torch.tensor(n, dtype=torch.int32),
            torch.from_numpy(pb.buf))
    want = gpu._resolve_kernel_impl(*args, lay=pb.layout)
    with CheckedCompact() as chk:
        got = gpu._resolve_kernel_impl(*(a.to(card) for a in args),
                                       lay=pb.layout)
    for g, w, what in zip(got, want, ("hmat", "new_n", "st_aux")):
        same(g, w, what)
    assert chk.launches() == chk.calls == {
        "densify": 0, "ranks": 1, "dense_phase3": 1, "redistribute": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_cases_equal_plain(card, case):
    hm, counts, pb, NB, NB_out, B = block_case(case, device=card)
    args = (torch.from_numpy(hm), torch.from_numpy(counts),
            torch.from_numpy(pb.buf))
    kw = dict(lay=pb.layout, NB=NB, NB_out=NB_out, B=B)
    want = gpu._compact_resolve_impl(*args, **kw)
    with CheckedCompact() as chk:
        got = gpu._compact_resolve_impl(*(a.to(card) for a in args), **kw)
    for g, w, what in zip(got, want, ("hmat", "counts", "btree", "fences",
                                      "new_n", "st_aux")):
        same(g, w, what)
    assert chk.launches() == chk.calls == {k: 1 for k in compact.LAUNCHES}
    assert int(got[5][pb.layout.T + 4]) == (case == "overflow")


@pytest.mark.cuda
@pytest.mark.parametrize("B,seed", [(8, 0), (32, 1), (512, 2)])
def test_chain_kernels_equal_plain(card, B, seed):
    """Batches through ConflictSetGPU on the card, fast steps and
    compactions mixed: every compaction kernel call equals its plain
    version, one of each per compaction; statuses and entries() equal
    ConflictSetCPU's."""
    rng = np.random.default_rng(seed)
    most = {8: 6}.get(B, 40)
    old = SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 4
    try:
        cs = gpu.ConflictSetGPU(max_key_bytes=9,
                                initial_capacity=max(4096, 8 * B),
                                block_slots=B, device=card)
        ora = ConflictSetCPU()
        v = 1000
        with CheckedCompact() as chk:
            for i in range(12):
                v += 60
                raw = raw_batch(rng, int(rng.integers(2, most)), v,
                                space=3000, lag=150, span=400,
                                hot=history_keys(ora) if i else None)
                got = cs.resolve(v, v - 300, port_txns(raw)).statuses
                want = ora.resolve(v, v - 300, port_txns(raw)).statuses
                assert list(got) == list(want), i
        assert cs.entries() == ora.entries()
    finally:
        SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = old
    assert cs.compactions >= 2 and cs.fast_resolves >= 1
    n = chk.launches()
    assert n == chk.calls == {k: cs.compactions for k in compact.LAUNCHES}


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANKS_CASES)
def test_ranks_cases_equal_plain(card, case):
    """ranks' kernel on a state of 2^16 columns against its plain version
    on the card: wide brackets, endpoints in one history gap or above the
    last key, n = 0, C - 1 and C, reads over most of n; the tier each run
    took, from the kernel's scratch, includes the one the case is built
    for, and no endpoint is out of sorted order."""
    ops = [torch.from_numpy(np.asarray(a)).to(card)
           for a in ranks_case(case)]
    want = compact.ranks_ref(*ops)
    ts = dict(zip(compact.RANKS_OPERANDS, ops))
    C, P2 = ops[0].shape[1], ops[2].shape[1]
    scratch = compact.ranks_scratch(C, P2, card)
    n0 = compact.LAUNCHES["ranks"]
    got = compact.ranks_launch(ts, scratch=scratch)
    for g, w, what in zip(got, want, ("ub", "eq", "base_conf")):
        same(g, w, what)
    assert compact.LAUNCHES["ranks"] == n0 + 1
    tiers = {t.split("+")[0] for t in compact.ranks_tiers(
        compact.ranks_tier_words(scratch, P2).tolist())}
    assert tiers <= {"tile", "wide"}, tiers
    if case in RANKS_CASE_TIER:
        assert RANKS_CASE_TIER[case] in tiers, tiers


@pytest.mark.cuda
def test_ranks_takes_both_tiers(card):
    """Over the ranks cases, runs take the shared tile and device memory
    both."""
    seen = set()
    for case in RANKS_CASES:
        ops = [torch.from_numpy(np.asarray(a)).to(card)
               for a in ranks_case(case)]
        C, P2 = ops[0].shape[1], ops[2].shape[1]
        scratch = compact.ranks_scratch(C, P2, card)
        compact.ranks_launch(dict(zip(compact.RANKS_OPERANDS, ops)),
                             scratch=scratch)
        seen |= {t.split("+")[0] for t in compact.ranks_tiers(
            compact.ranks_tier_words(scratch, P2).tolist())}
    assert {"tile", "wide"} <= seen, seen


@pytest.mark.cuda
@pytest.mark.parametrize("new_n", REDIST_NEW_N)
@pytest.mark.parametrize("NB_out", [8, 1 << 16])
@pytest.mark.parametrize("B", [8, 32, 512])
def test_redistribute_cases_equal_plain(card, B, NB_out, new_n):
    """redistribute's kernel against its plain version on the card at
    new_n 0, 1, F - 1, F, the fill NB_out F less one, the fill and past
    it (the overflow byte), for B 8, 32, 512 and NB_out 8, 2^16."""
    hm, nn, st = (torch.from_numpy(np.asarray(a)).to(card)
                  for a in redist_case(new_n, B, NB_out))
    st2 = st.clone()
    want = compact.redistribute_ref(hm, nn, st2, NB_out=NB_out, B=B)
    got = compact.redistribute(hm, nn, st, NB_out=NB_out, B=B)
    for g, w, what in zip((*got, st), (*want, st2),
                          ("hmat", "counts", "btree", "fences", "st_aux")):
        same(g, w, what)
    assert int(st[-2]) == (new_n == "fill_plus_three")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b32", "over_full", "empty_state"])
def test_stage_stamps(card, case):
    """Each compaction kernel with a stamp buffer: one stamp at the start
    and one after each stage (compact.DENSIFY_STAGES, RANKS_STAGES,
    PHASE3_STAGES, REDIST_STAGES), never falling, and outputs equal to the
    plain versions'; a buffer of the wrong length is refused."""
    hm, counts, pb, NB, NB_out, B = block_case(case)
    kept = {}
    real = (compact.ranks, compact.dense_phase3, compact.redistribute)

    def rk(*args):
        kept["ranks"] = args
        return real[0](*args)

    def p3(hmat, n, **kw):
        kept.update(hmat=hmat, n=n, kw=kw)
        return real[1](hmat, n, **kw)

    def rd(hmat_d, new_n, st_aux, **kw):
        kept["redistribute"] = (hmat_d, new_n, st_aux.clone())
        return real[2](hmat_d, new_n, st_aux, **kw)

    compact.ranks, compact.dense_phase3, compact.redistribute = rk, p3, rd
    try:
        gpu._compact_resolve_impl(
            *(torch.from_numpy(a).to(card) for a in (hm, counts, pb.buf)),
            lay=pb.layout, NB=NB, NB_out=NB_out, B=B)
    finally:
        compact.ranks, compact.dense_phase3, compact.redistribute = real
    h, c = torch.from_numpy(hm).to(card), torch.from_numpy(counts).to(card)
    hd, nn, st_aux = kept["redistribute"]

    def redist(st):
        s2 = st_aux.clone()
        return (*compact.redistribute_launch(hd, nn, s2, NB_out=NB_out, B=B,
                                             stamps=st), s2)

    def redist_plain():
        s2 = st_aux.clone()
        return (*compact.redistribute_ref(hd, nn, s2, NB_out=NB_out, B=B),
                s2)

    for stages, run, plain in (
            (compact.RANKS_STAGES,
             lambda st: compact.ranks_launch(
                 dict(zip(compact.RANKS_OPERANDS, kept["ranks"])),
                 stamps=st),
             lambda: compact.ranks_ref(*kept["ranks"])),
            (compact.REDIST_STAGES, redist, redist_plain),
            (compact.DENSIFY_STAGES,
             lambda st: compact.densify_launch(h, c, B=B, stamps=st),
             lambda: compact.densify_ref(h, c, B=B)),
            (compact.PHASE3_STAGES,
             lambda st: compact.dense_phase3_launch(dict(zip(
                 compact.DENSE_PHASE3_OPERANDS,
                 (kept["hmat"], kept["n"], *(
                     kept["kw"][k]
                     for k in compact.DENSE_PHASE3_OPERANDS[2:])))),
                 stamps=st),
             lambda: compact.dense_phase3_ref(kept["hmat"], kept["n"],
                                              **kept["kw"]))):
        st = torch.full((len(stages) + 1,), -1, dtype=torch.int64,
                        device=card)
        got = run(st)
        for i, (g, w) in enumerate(zip(got, plain())):
            same(g, w, f"{stages[0]} output {i}")
        t = st.cpu()
        assert (t > 0).all() and (t[1:] >= t[:-1]).all(), t
        with pytest.raises(ValueError, match="stamps"):
            run(st[:-1])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    hm, counts, pb, NB, NB_out, B = block_case("b32")
    h = torch.from_numpy(hm)
    with pytest.raises(ValueError, match="CUDA"):
        compact.densify_launch(h, torch.from_numpy(counts), B=B)
    with pytest.raises(TypeError):
        compact.densify(h.to(card).to(torch.int64),
                        torch.from_numpy(counts).to(card), B=B)
    with pytest.raises(ValueError, match="shape"):
        compact.densify(h.to(card), torch.from_numpy(counts).to(card),
                        B=2 * B)
    z = torch.zeros((), dtype=torch.int32, device=card)
    st = torch.zeros(pb.layout.T + 6, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="powers of two"):
        compact.redistribute(h.to(card), z, st, NB_out=3, B=B)
    with pytest.raises(ValueError, match="powers of two"):
        compact.redistribute(h.to(card), z, st, NB_out=8, B=4)
