"""resolver/block.py (decode, phase 1 and phase 3 of the block kernel) on
the CPU against the JAX package, exactly.

On CPU tensors block.py runs its plain versions, the ones csrc/block.cu's
kernels are held to on a card (tests/test_torch_block_card.py). Here:

- block.decode_fused against tpu._decode_fused on buffers from both
  packers (asserted equal): keyAfter, increment and explicit end modes,
  pad rows, narrow and wide keys, sorted slots past the rows' and rows'
  positions out of range;
- gpu._resolve_block_kernel_impl, which runs block.phase1 and
  block.phase3 around the probe and phase 2, against
  tpu._resolve_block_kernel_impl on one fast step: every output (hmat,
  counts, btree updated in place, n', st_aux), for reads inside one block
  and across many (the block-max tree's climb), writes equal to history
  keys and to each other (duplicate endpoints), uncommitted writes, pad
  rows past n_g, a block filled to B - 1 and wide keys;
- a chain of fast steps carried on both sides, btree included, one at a
  lower version (a block's maximum falls: the kernel's ancestor walk by
  atomicMax holds only while maxima never fall, and takes the level loop
  when one does).

Layouts and K are pinned per case so that each JAX function compiles
once.
"""

import ctypes
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_block_cases import (
    EDGE_CASES,
    edge_batch,
    edge_state,
    edge_step_buf,
    fill_raw,
    grown,
    history_keys,
    k8,
    positions_out_of_range,
    raw_batch,
    txns,
)
from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver import packing as jpack
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import block, gpu
from foundationdb_tpu_torch.resolver import packing as ppack
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn


def packed(raw, oldest, n_words, caps):
    """The batch packed by both packers (asserted equal): the port's."""
    j = jpack.pack_batch(txns(raw, JTxn, JKeyRange), oldest, n_words,
                         caps=caps)
    p = ppack.pack_batch(txns(raw, PTxn, PKeyRange), oldest, n_words,
                         caps=caps)
    np.testing.assert_array_equal(j.buf, p.buf)
    return p


def eq(port, ref, what=""):
    """Exact equality, dtype included, of a torch output and a JAX one."""
    ref = np.asarray(ref)
    got = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_decode(lay_key):
    lay = jpack.FusedLayout(*lay_key)
    return jax.jit(lambda f: jtpu._decode_fused(f, lay=lay))


@functools.lru_cache(maxsize=None)
def jax_block(lay_key, K, NB, B):
    lay = jpack.FusedLayout(*lay_key)
    return jax.jit(lambda *a: jtpu._resolve_block_kernel_impl(
        *a, lay=lay, K=K, NB=NB, B=B))


DECODE_CASES = {
    # name: (n_words, max_key_bytes of the wide suffix, caps)
    "narrow": (3, 0, (96, 64, 64, 32, 32)),
    "narrow_no_explicit_slots": (3, 0, (96, 64, 64)),
    "wide": (10, 28, (80, 48, 48, 24, 24)),
    # P2 352 past the rows' 336 slots, and rows' positions out of range
    # (positions_out_of_range)
    "pad_slots_positions_out": (3, 0, (100, 64, 64, 32, 32)),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_fused_matches_jax(case, seed):
    n_words, wide, caps = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    raw = raw_batch(rng, 40, 5000, space=300, wide=wide, span=60)
    raw += increments(rng, n_words, 5000)
    if case == "narrow_no_explicit_slots":  # no side table: Er = Ew = 0
        def derivable(r):
            b, e = r
            return e == b + b"\x00" or len(b) == 4 * n_words
        raw = [(s, [r for r in rr if derivable(r)],
                [w for w in wr if derivable(w)]) for s, rr, wr in raw]
    pb = packed(raw, 4000, n_words, caps)
    pb.set_scalars(1234, 45)
    buf = pb.buf
    if case == "pad_slots_positions_out":
        buf = positions_out_of_range(buf, pb.layout)
    want = jax_decode(pb.layout.key())(jnp.asarray(buf))
    got = block.decode_fused(torch.from_numpy(buf), lay=pb.layout)
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        eq(g, w, f"output {i}")
    # the modes all ran: increment and explicit ends, pad rows
    lay = pb.layout
    modes = set((pb.buf[lay.off_rb + n_words * lay.R:][: pb.n_reads] >> 14)
                .tolist())
    assert modes == ({0, 1} if case == "narrow_no_explicit_slots"
                     else {0, 1, 2})
    assert pb.n_reads < lay.R
    assert (lay.Er == 0) == (case == "narrow_no_explicit_slots")


def increments(rng, n_words, version):
    """Txns whose ranges end at begin + 1 in the integer key space (the
    packer's increment mode: keys filling the width), with carries across
    all-ones words."""
    out = []
    for _ in range(6):
        head = bytes(rng.integers(0, 256, 4 * n_words - 4, dtype=np.uint8))
        tail = int(rng.choice([5, 0xFFFFFFFF, 0xFFFFFFFE]))
        b = head + tail.to_bytes(4, "big")
        e = (int.from_bytes(b, "big") + 1).to_bytes(4 * n_words, "big")
        out.append((version - 3, [(b, e)], [(b, e)]))
    ones = b"\x07" + b"\xff" * (4 * n_words - 1)
    carry = (int.from_bytes(ones, "big") + 1).to_bytes(4 * n_words, "big")
    out.append((version - 3, [(ones, carry)], [(ones, carry)]))
    return out


def state_arrays(cs):
    return (cs.hmat.numpy().copy(), cs.counts.numpy().copy(),
            cs.btree.numpy().copy(), cs.fences.numpy().copy(), int(cs.n))


def step_both(cs, raw, version, oldest, caps, K, jstate=None,
              drop_last=False):
    """One fast step on the port's state (in place) and on a JAX copy
    (`jstate`, carried by the caller; fresh from the port's state
    otherwise), K touched rows (None: the fast path's own), the touched
    list without its last block where drop_last. Returns (port outputs,
    JAX outputs, n_touched, the fused buffer, its layout)."""
    pb = ppack.pack_batch(txns(raw, PTxn, PKeyRange), cs.oldest_version,
                          cs.n_words, caps=caps)
    buf, K, n_t = edge_step_buf(cs, pb, version, oldest, K, drop_last)
    hmat, counts, btree, fences, n = state_arrays(cs)
    if jstate is None:
        jstate = (jnp.asarray(hmat), jnp.asarray(counts),
                  jnp.asarray(btree), jnp.int32(n))
    jh, jc, jb, jn = jstate
    want = jax_block(pb.layout.key(), K, cs.NB, cs.B)(
        jh, jc, jb, jnp.asarray(fences), jn, jnp.asarray(buf))
    got = gpu._resolve_block_kernel_impl(
        cs.hmat, cs.counts, cs.btree, cs.fences, cs.n, torch.from_numpy(buf),
        lay=pb.layout, K=K, NB=cs.NB, B=cs.B)
    cs.n = got[3]
    return got, want, n_t, buf, pb.layout


def check(got, want):
    for g, w, what in zip(got, want, ("hmat", "counts", "btree", "n'",
                                      "st_aux")):
        eq(g, w, what)


CAPS = (96, 64, 64, 32, 32)


def case_raw(case, cs, rng, v):
    hot = history_keys(cs)
    if case == "one_block_reads":
        return raw_batch(rng, 30, v, space=2000, lag=150)
    if case == "spanning_reads":
        return raw_batch(rng, 30, v, space=2000, lag=150, span=1500)
    if case == "history_and_sibling_writes":
        raw = raw_batch(rng, 24, v, space=2000, lag=150, hot=hot[:6])
        # duplicate endpoints: three txns write the same range
        k = int(hot[3])
        same = [(v - 1, [], [(k8(k), k8(k + 2))])] * 3
        return raw + same
    if case == "uncommitted_writes":
        # every txn reads what the others write at an old snapshot
        raw = raw_batch(rng, 24, v, space=2000, lag=2, hot=hot)
        return [(v - 300, rr + wr, wr) for _, rr, wr in raw]
    raise KeyError(case)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["one_block_reads", "spanning_reads",
                                  "history_and_sibling_writes",
                                  "uncommitted_writes", *EDGE_CASES])
def test_block_kernel_matches_jax(case, seed):
    if case in EDGE_CASES:   # _torch_block_cases.EDGE_CASES
        cs, rng, v = edge_state(case, seed)
        v += 50
        raw, caps, K, drop_last = edge_batch(case, cs, rng, v)
        got, want, _, _, _ = step_both(cs, raw, v, v - 300, caps, K,
                                       drop_last=drop_last)
        check(got, want)
        assert int(got[4][-2]) == 0   # no block overflowed
        return
    cs, rng, v = grown(seed, capacity=4096, space=2000)
    v += 50
    raw = case_raw(case, cs, rng, v)
    fences = cs.fences.clone()   # a fast step leaves the fences as they are
    got, want, n_t, buf, lay = step_both(cs, raw, v, v - 300, CAPS, K=64)
    assert n_t < 64  # pad rows past n_g
    check(got, want)
    st = got[4][: len(raw)].numpy()
    dec = block.decode_fused(torch.from_numpy(buf), lay=lay)
    bid = gpu._fence_rank(fences, dec[0])
    nr = int(dec[12])
    blocks_spanned = (bid[dec[2]] - bid[dec[1]])[:nr]
    if case == "one_block_reads":
        assert (blocks_spanned == 0).sum() > nr // 2
    if case == "spanning_reads":   # whole interior blocks: the tree's climb
        assert int(blocks_spanned.max()) >= 4
    if case == "uncommitted_writes":
        assert (st == 1).sum() >= 4


def test_block_filled_to_b_minus_1_matches_jax():
    cs, rng, v = grown(7, capacity=4096, space=2000)
    raw = fill_raw(cs, 1, v + 50)
    got, want, _, _, _ = step_both(cs, raw, v + 50, v - 300, (16, 32, 16),
                                   K=8)
    check(got, want)
    assert int(got[1][1]) == cs.B - 1
    assert int(got[4][-2]) == 0  # overflow byte


def test_wide_keys_block_kernel_matches_jax():
    cs, rng, v = grown(4, max_key_bytes=40, capacity=4096, space=2000,
                       wide=28)
    assert cs.n_words == 10
    v += 50
    raw = raw_batch(rng, 30, v, space=2000, lag=150, wide=28, span=300)
    got, want, _, _, _ = step_both(cs, raw, v, v - 300, CAPS, K=64)
    check(got, want)


def test_fast_step_chain_keeps_btree_equal_to_jax():
    """Five fast steps carried on both sides; the third at a version below
    the second, rewriting the second's lone write (its block's maximum
    falls)."""
    cs, rng, v = grown(2, capacity=4096, space=2000)
    x = [(b"\x00" * 7 + b"\x07\x01", b"\x00" * 7 + b"\x07\x02")]
    steps = [(50, None), (50, x), (-40, x), (50, None), (50, None)]
    jstate = None
    fell = 0
    for dv, wr in steps:
        v += dv
        raw = ([(v - 1, [], wr)] if wr else
               raw_batch(rng, 20, v, space=2000, lag=100,
                         hot=history_keys(cs)))
        before = cs.btree.clone()
        got, want, _, _, _ = step_both(cs, raw, v, v - 300, CAPS, K=64,
                                       jstate=jstate)
        check(got, want)
        fell += bool((cs.btree[cs.NB:] < before[cs.NB:]).any())
        jstate = (want[0], want[1], want[2], want[3])
    assert fell == 1
    # the port's state equals the JAX chain's end state
    eq(cs.btree, jstate[2], "btree")
    eq(cs.hmat, jstate[0], "hmat")


# ------------------------------------------------ the kernels' interface

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "const long long*": ctypes.POINTER(ctypes.c_longlong),
           "void* const*": ctypes.POINTER(ctypes.c_void_p),
           "const char*": ctypes.c_char_p}


def c_signature(src: str, name: str):
    """(restype, argtypes) of one extern "C" function of a CUDA source."""
    m = re.search(r'extern "C" ([\w *]+?)\s*' + name + r"\((.*?)\)\s*\{",
                  src, re.S)
    assert m, name
    params = [" ".join(p.split()) for p in m.group(2).split(",")]
    return (C_TYPES[m.group(1).strip().replace(" *", "*")],
            [C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params if p])


def test_kernel_entry_points_match_the_wrapper():
    """csrc/block.cu's C entry points take exactly the argtypes block.py
    gives ctypes (a pointer passed as c_int would be cut to 32 bits) and
    return its restypes; the operand lists agree in length; _build.SOURCES
    builds that source."""
    src = (Path(block.__file__).parents[1] / "csrc" / "block.cu").read_text()
    assert _build.SOURCES["block"].read_text() == src
    assert set(re.findall(r'extern "C" [\w *]+?\b(fdb_\w+)\(', src)) == set(
        block.ENTRY_POINTS)
    for name, (restype, argtypes) in block.ENTRY_POINTS.items():
        assert c_signature(src, name) == (restype, argtypes), name
    # phase 3's pointer array: the operands, then n_out, st_aux, scratch,
    # stamps
    n_ptrs = len(block.PHASE3_OPERANDS) + 4
    idx = sorted(int(i) for i in re.findall(r"\)ptrs\[(\d+)\]", src))
    assert idx == list(range(n_ptrs))
    # the stamp buffer: phase 3's last pointer, decode's ninth argument;
    # each kernel stamps at its start, after each barrier and at its end,
    # once for every stage the wrapper names
    assert f"a.stamps = (int64_t*)ptrs[{n_ptrs - 1}];" in src
    body = src[src.index(" fdb_block_decode("):]
    assert re.search(r"void\* scratch,\s*void\* stamps,", body)
    assert "a.stamps = (int64_t*)stamps;" in body
    for kernel, stages in (("decode_kernel", block.DECODE_STAGES),
                           ("phase3_kernel", block.PHASE3_STAGES)):
        start = src.index(f" {kernel}(")
        body = src[start:src.index("\n}\n", start)]
        assert "Stamps st(a.stamps);" in body and "g.finish(st);" in body
        assert body.count("sync(st)") == len(stages) - 1, kernel
    # decode's layout words
    assert len(block.layout_words(
        ppack.FusedLayout(3, 64, 16, 8, 8, 2, 2))) == 18
