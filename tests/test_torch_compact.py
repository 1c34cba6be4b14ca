"""resolver/compact.py (the compaction's densify, ranks + phase 1, dense
phase 3 and redistribution) and gpu.py's dense and compaction kernels on
the CPU against the JAX package, exactly.

On CPU tensors compact.py runs its plain versions, the ones
csrc/compact.cu's kernels are held to on a card
(tests/test_torch_compact_card.py). Here, on the cases of
tests/_torch_compact_cases.py (an empty history, a full dense state whose
rank walk saturates and whose phase 3 overflows, reads with rank_b = 0,
pad queries, wide keys, n = C - 1, pad write endpoints only, n + 2 Wr at
a chunk boundary of phase 3's grid; equal-key runs across block
boundaries and over blocks with empty blocks between, a block past B
entries, an empty state, growing and shrinking compactions, a fill
layout too small for the set, B of 8, 32 and 512):

- gpu._resolve_kernel_impl (decode, compact.ranks, phase 2,
  compact.dense_phase3) against tpu._resolve_kernel_impl;
- compact.ranks against tpu.py's own rank and table functions composed as
  tpu.py:457-472 composes them, and, on states whose columns past n are
  pads, against the same ranks computed from the live columns alone (what
  the kernel reads);
- gpu._compact_resolve_impl against tpu._compact_resolve_impl, and
  compact.densify and compact.redistribute around tpu.py's dense kernel
  against the same;
- a chain of fast steps and compactions through ConflictSetGPU
  (device="cpu") and ConflictSetTPU at B 8, 32 and 512: statuses, and
  after every compaction btree and fences, and entries() at the end;
- csrc/compact.cu's C signatures against compact.py's ctypes types, and
  the stage-stamp argument against the stages compact.py names.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_block_cases import history_keys, raw_batch, txns
from _torch_compact_cases import (
    BLOCK_CASES,
    DENSE_CASES,
    PLAIN_ONLY_DENSE_CASES,
    RANKS_CASES,
    block_case,
    dense_case,
    ranks_case,
)
from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver import packing as jpack
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as PKNOBS
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import block, compact, gpu
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn
from test_torch_block import c_signature


def eq(port, ref, what=""):
    """Exact equality, dtype included, of a torch output and a JAX one."""
    ref = np.asarray(ref)
    got = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_dense(lay_key):
    lay = jpack.FusedLayout(*lay_key)
    return jax.jit(lambda h, n, f: jtpu._resolve_kernel_impl(h, n, f,
                                                             lay=lay))


@functools.lru_cache(maxsize=None)
def jax_compact(lay_key, NB, NB_out, B):
    lay = jpack.FusedLayout(*lay_key)
    return jax.jit(lambda h, c, f: jtpu._compact_resolve_impl(
        h, c, f, lay=lay, NB=NB, NB_out=NB_out, B=B))


@jax.jit
def jax_ranks(hmat, smat, q_begin, q_end, rsnap, rtxn, too_old):
    """tpu.py:457-472: the ranks and phase 1 of _resolve_kernel_impl, from
    tpu.py's own helpers."""
    W = smat.shape[0] - 1
    C = hmat.shape[1]
    hkeys, hv = hmat[: W + 1], hmat[W + 1]
    lb = jtpu._lower_rank(hkeys, smat)
    _, e = jtpu._lex_lt_eq(hkeys[:, jnp.clip(lb, 0, C - 1)], smat)
    ub = jnp.where(smat[W] == jpack.INT32_MAX, C, lb + e)
    vtab = jtpu._build_table(hv, jnp.maximum, 0)
    hist_max = jtpu._table_range_query(vtab, ub[q_begin] - 1, lb[q_end],
                                       jnp.maximum, 0)
    read_conf = (hist_max > rsnap).astype(jnp.int32)
    hist_conf = jnp.zeros(too_old.shape[0], jnp.int32).at[rtxn].max(
        read_conf)
    return ub, e, jnp.maximum(hist_conf, too_old.astype(jnp.int32))


@pytest.mark.parametrize("case", DENSE_CASES + PLAIN_ONLY_DENSE_CASES)
def test_dense_resolve_matches_jax(case):
    hm, n, pb = dense_case(case)
    want = jax_dense(pb.layout.key())(jnp.asarray(hm), jnp.int32(n),
                                      jnp.asarray(pb.buf))
    got = gpu._resolve_kernel_impl(
        torch.from_numpy(hm), torch.tensor(n, dtype=torch.int32),
        torch.from_numpy(pb.buf), lay=pb.layout)
    for g, w, what in zip(got, want, ("hmat", "new_n", "st_aux")):
        eq(g, w, what)
    T, C = pb.layout.T, hm.shape[1]
    if case == "full":   # more entries than columns: the overflow byte
        assert int(got[1]) > C and int(got[2][T + 4]) == 1
    elif case in DENSE_CASES:
        assert int(got[2][T + 4]) == 0


@pytest.mark.parametrize("case", DENSE_CASES + PLAIN_ONLY_DENSE_CASES)
def test_ranks_match_jax(case):
    hm, n, pb = dense_case(case)
    dec = block.decode_fused(torch.from_numpy(pb.buf), lay=pb.layout)
    smat, q_begin, q_end, rtxn, rsnap, too_old = (dec[i] for i in
                                                  (0, 1, 2, 5, 6, 9))
    h = torch.from_numpy(hm)
    got = compact.ranks(h, torch.tensor(n, dtype=torch.int32), smat, q_begin,
                        q_end, rsnap, rtxn, too_old)
    want = jax_ranks(*(jnp.asarray(t.numpy()) for t in (
        h, smat, q_begin, q_end, rsnap, rtxn, too_old)))
    for g, w, what in zip(got, want, ("ub", "eq", "base_conf")):
        eq(g, w, what)
    C = hm.shape[1]
    ub = got[0]
    nr = int(dec[12])
    if case in ("empty", "rank0"):   # reads whose begin ranks 0
        assert (ub[q_begin[:nr].long()] == 0).any()
    if case == "full":   # a key above the full state: the walk's C - 1
        assert int(ub[: 2 * pb.n_writes].max()) == C - 1
    if case == "pad_queries":
        assert (ub == C).sum() > 2 * (pb.layout.R - nr)
    if case == "full_collide":   # the write endpoints' ranks fall once
        nw = int(dec[13])
        pos = torch.cat([dec[3][:nw], dec[4][:nw]]).sort().values
        w_ub = ub[pos.long()]
        assert (w_ub[1:] < w_ub[:-1]).any()


def key_bytes(rows: np.ndarray) -> np.ndarray:
    """Columns of (W + 1) signed int32 rows as byte strings that sort as
    the kernels compare keys (signed words, then the length row)."""
    u = (rows.astype(np.int64).T + (1 << 31)).astype(">u4")
    return np.ascontiguousarray(u).view(f"V{4 * rows.shape[0]}").ravel()


def ranks_live(hmat, n, smat, q_begin, q_end, rsnap, rtxn, too_old):
    """ranks from the live columns alone, as csrc/compact.cu's kernel
    reads them: each endpoint's count of live history keys below it, from
    which tpu.py's halving walk over C follows (it adds a step while pos +
    step <= count); each read's maximum over the live versions, from the
    slots past the kernel's built extent E = min(1,024 ceil(n / 1,024),
    C) only the identity 0 (they are pads or past C)."""
    hmat, smat = hmat.numpy(), smat.numpy()
    n, C, W = int(n), hmat.shape[1], smat.shape[0] - 1
    k = np.searchsorted(key_bytes(hmat[: W + 1, :n]), key_bytes(smat),
                        side="left")
    lb = np.zeros_like(k)
    step = C >> 1
    while step >= 1:
        lb += np.where(lb + step <= k, step, 0)
        step >>= 1
    eq = (hmat[: W + 1, lb] == smat).all(axis=0)
    ub = np.where(smat[W] == 2**31 - 1, C, lb + eq).astype(np.int32)
    hv = hmat[W + 1]
    E = min(-(-n // 1024) * 1024, C)
    conf = too_old.numpy().astype(np.int32)
    for qb, qe, snap, t in zip(q_begin.numpy(), q_end.numpy(),
                               rsnap.numpy(), rtxn.numpy()):
        lo, hi = int(ub[qb]) - 1, int(lb[qe])
        hist = 0
        if hi > lo:
            w = 1 << (hi - lo).bit_length() - 1
            hist = max(max([*hv[i: min(i + w, E)], *([0] * (i + w > E))])
                       for i in (min(max(lo, 0), C - 1),
                                 min(max(hi - w, 0), C - 1)))
        if hist > snap:
            conf[t] = 1
    return ub, eq, conf


def dense_or_ranks_case(case):
    if case in RANKS_CASES:
        return [torch.from_numpy(np.asarray(a)) for a in ranks_case(case)]
    hm, n, pb = dense_case(case)
    dec = block.decode_fused(torch.from_numpy(pb.buf), lay=pb.layout)
    return [torch.from_numpy(hm), torch.tensor(n, dtype=torch.int32),
            *(dec[i] for i in (0, 1, 2, 6, 5, 9))]


@pytest.mark.parametrize("case", RANKS_CASES + DENSE_CASES)
def test_ranks_from_the_live_columns(case):
    """On states whose columns past n are pads (ranks' precondition),
    compact.ranks' plain version, tpu.py's walk and table over all C
    columns, gives what the live columns alone give: the kernel's counts
    and walks over [0, n) and its maxima over the live extent."""
    ops = dense_or_ranks_case(case)
    hm, n, W = ops[0], int(ops[1]), ops[2].shape[0] - 1
    assert (hm[: W + 1, n:] == 2**31 - 1).all() and (hm[W + 1, n:] == 0).all()
    got = compact.ranks(*ops)
    for g, w, what in zip(got, ranks_live(*ops), ("ub", "eq", "base_conf")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_compaction_matches_jax(case):
    hm, counts, pb, NB, NB_out, B = block_case(case)
    want = jax_compact(pb.layout.key(), NB, NB_out, B)(
        jnp.asarray(hm), jnp.asarray(counts), jnp.asarray(pb.buf))
    got = gpu._compact_resolve_impl(
        torch.from_numpy(hm), torch.from_numpy(counts),
        torch.from_numpy(pb.buf), lay=pb.layout, NB=NB, NB_out=NB_out, B=B)
    assert len(got) == 6
    for g, w, what in zip(got, want, ("hmat", "counts", "btree", "fences",
                                      "new_n", "st_aux")):
        eq(g, w, what)
    overflow = int(got[5][pb.layout.T + 4])
    assert overflow == (case == "overflow")
    if case == "runs_across_blocks":   # the duplicates went
        dense, m2 = compact.densify(torch.from_numpy(hm),
                                    torch.from_numpy(counts), B=B)
        assert int(m2) < int(counts.sum())


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_densify_and_redistribute_around_the_jax_dense_kernel(case):
    """compact.densify, then tpu.py's dense kernel, then
    compact.redistribute: equal to tpu._compact_resolve_impl."""
    hm, counts, pb, NB, NB_out, B = block_case(case)
    want = jax_compact(pb.layout.key(), NB, NB_out, B)(
        jnp.asarray(hm), jnp.asarray(counts), jnp.asarray(pb.buf))
    dense, m2 = compact.densify(torch.from_numpy(hm),
                                torch.from_numpy(counts), B=B)
    hd, nn, st = jax_dense(pb.layout.key())(
        jnp.asarray(dense.numpy()), jnp.int32(int(m2)), jnp.asarray(pb.buf))
    st = torch.from_numpy(np.array(st))
    got = compact.redistribute(torch.from_numpy(np.array(hd)),
                               torch.from_numpy(np.array(nn)), st,
                               NB_out=NB_out, B=B)
    for g, w, what in zip((*got, st), (*want[:4], want[5]),
                          ("hmat", "counts", "btree", "fences", "st_aux")):
        eq(g, w, what)


@pytest.mark.parametrize("B", [8, 32, 512])
def test_chain_matches_jax(B, monkeypatch):
    """Fast steps and compactions carried on both sides (ConflictSetGPU on
    the CPU, ConflictSetTPU) at block_slots B: statuses after every batch,
    btree and fences after every compaction, entries() at the end. B 512
    is past the 256 slots phase 3's CUDA kernel once took."""
    monkeypatch.setattr(JKNOBS, "TPU_COMPACT_EVERY_BATCHES", 3)
    monkeypatch.setattr(PKNOBS, "TPU_COMPACT_EVERY_BATCHES", 3)
    rng = np.random.default_rng(B)
    cap = max(1024, 8 * B)
    cs = gpu.ConflictSetGPU(max_key_bytes=9, initial_capacity=cap,
                            block_slots=B, device="cpu")
    jc = jtpu.ConflictSetTPU(max_key_bytes=9, initial_capacity=cap,
                             block_slots=B)
    v = 1000
    most = {8: 6}.get(B, 30)   # small blocks: headroom for the fast path
    for i in range(7):
        v += 60
        raw = raw_batch(rng, int(rng.integers(2, most)), v, space=2000,
                        lag=150, span=300, hot=history_keys(cs) if i else None)
        got = cs.resolve(v, v - 300, txns(raw, PTxn, PKeyRange)).statuses
        want = jc.resolve(v, v - 300, txns(raw, JTxn, JKeyRange)).statuses
        assert list(got) == list(want), i
        if cs._since_compact == 0:
            eq(cs.btree, jc.btree, f"btree after batch {i}")
            eq(cs.fences, jc.fences, f"fences after batch {i}")
    assert cs.compactions >= 2 and cs.fast_resolves >= 1
    assert cs.entries() == jc.entries()


def test_kernel_entry_points_match_the_wrapper():
    """csrc/compact.cu's C entry points take exactly the argtypes
    compact.py gives ctypes and return its restypes; the pointer arrays
    hold as many pointers as the wrappers pass; _build.SOURCES builds
    that source."""
    src = (Path(compact.__file__).parents[1] / "csrc"
           / "compact.cu").read_text()
    assert _build.SOURCES["compact"].read_text() == src
    assert set(re.findall(r'extern "C" [\w *]+?\b(fdb_\w+)\(', src)) == set(
        compact.ENTRY_POINTS)
    for name, (restype, argtypes) in compact.ENTRY_POINTS.items():
        assert c_signature(src, name) == (restype, argtypes), name
    n_ptrs_p3 = len(compact.DENSE_PHASE3_OPERANDS) + 5
    bodies = re.split(r'extern "C"', src)
    for fname, n_ptrs in (("fdb_compact_ranks", len(compact.RANKS_OPERANDS)
                           + 5),
                          ("fdb_compact_phase3",
                           len(compact.DENSE_PHASE3_OPERANDS) + 5),
                          ("fdb_compact_redistribute", 8)):
        (body,) = [b for b in bodies if f" {fname}(" in b]
        idx = sorted(int(i) for i in re.findall(r"\)ptrs\[(\d+)\]", body))
        assert idx == list(range(n_ptrs)), fname
    # the stamp buffer: the last pointer of ranks, phase 3 and
    # redistribute, densify's sixth argument; each kernel stamps at its
    # start, after each barrier and at its end, once for every stage the
    # wrapper names
    for fname, n_ptrs in (("fdb_compact_ranks",
                           len(compact.RANKS_OPERANDS) + 5),
                          ("fdb_compact_phase3", n_ptrs_p3),
                          ("fdb_compact_redistribute", 8)):
        (body,) = [b for b in bodies if f" {fname}(" in b]
        assert f"a.stamps = (int64_t*)ptrs[{n_ptrs - 1}];" in body, fname
    (body,) = [b for b in bodies if " fdb_compact_densify(" in b]
    assert re.search(r"void\* scratch,\s*void\* stamps,", body)
    assert "a.stamps = (int64_t*)stamps;" in body
    for kernel, stages in (("densify_kernel", compact.DENSIFY_STAGES),
                           ("ranks_kernel", compact.RANKS_STAGES),
                           ("phase3_kernel", compact.PHASE3_STAGES),
                           ("redist_kernel", compact.REDIST_STAGES)):
        start = src.index(f" {kernel}(")
        body = src[start:src.index("\n}\n", start)]
        assert "Stamps st(a.stamps);" in body and "g.finish(st);" in body
        assert body.count("sync(st)") == len(stages) - 1, kernel
