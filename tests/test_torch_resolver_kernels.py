"""Each tensor function of the port's resolver (gpu.py) against its JAX
twin in foundationdb_tpu/resolver/tpu.py.

Inputs are the same for both sides: fused batch buffers packed by each
package's own packer (asserted equal) from numpy-seeded batches, against
block states grown by the port's host class on the CPU. Every output array
is compared exactly, dtype included (everything is integer). The block
kernel is held against the JAX side under both of its probes, "xla" and
"pallas" (the Pallas kernel in interpret mode on the CPU).
"""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver import packing as jpack
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import block
from foundationdb_tpu_torch.resolver import gpu
from foundationdb_tpu_torch.resolver import packing as ppack
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn

N_WORDS = 3            # 9-byte keyAfter ends of 8-byte keys
CAPS = (96, 64, 64, 32, 32)  # pinned layout: one JAX compile per kernel
B = 32


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def raw_batch(rng, n, version, space=160, lag=250, chain=0):
    """Random point/increment/explicit ranges plus an abort chain of
    `chain` txns (t reads what t-1 writes), the phase-2 worst case."""
    out = []
    keys = [3 + i * (space // (chain + 1)) for i in range(chain + 1)]
    for i in range(chain):
        a, b = keys[i], keys[i + 1]
        out.append((version - 1, [(k8(a), k8(a) + b"\x00")],
                    [(k8(b), k8(b) + b"\x00")]))
    for _ in range(n):
        rr = []
        for a in map(int, rng.integers(0, space, rng.integers(0, 4))):
            kind = int(rng.integers(0, 3))
            end = (k8(a) + b"\x00", k8(a + 1),
                   k8(a + int(rng.integers(2, 7))))[kind]
            rr.append((k8(a), end))
        wr = [(k8(a), k8(a) + b"\x00") if rng.random() < 0.7
              else (k8(a), k8(a + int(rng.integers(1, 4))))
              for a in map(int, rng.integers(0, space, rng.integers(0, 3)))]
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def txns(raw, jax_side: bool):
    T, KR = (JTxn, JKeyRange) if jax_side else (PTxn, PKeyRange)
    return [T(s, [KR(*r) for r in rr], [KR(*w) for w in wr])
            for s, rr, wr in raw]


def grown_state(seed, n_batches=4):
    """A port conflict set (CPU) after a few random batches, the last one a
    compaction (every block at fill B/2, so a small batch has headroom for
    the fast path), mirror fresh."""
    from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS

    rng = np.random.default_rng(seed)
    old = SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES
    SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = 3
    try:
        cs = gpu.ConflictSetGPU(max_key_bytes=9, initial_capacity=1024,
                                block_slots=B, device="cpu")
        v = 1000
        for i in range(n_batches):
            v += 100
            if i == n_batches - 1:
                cs._since_compact = 10**9
            cs.resolve(v, v - 400, txns(raw_batch(rng, 30, v), False))
    finally:
        SERVER_KNOBS.TPU_COMPACT_EVERY_BATCHES = old
    cs._refresh_mirror()
    return cs, rng, v


def packed(raw, oldest):
    j = jpack.pack_batch(txns(raw, True), oldest, N_WORDS, caps=CAPS)
    p = ppack.pack_batch(txns(raw, False), oldest, N_WORDS, caps=CAPS)
    np.testing.assert_array_equal(j.buf, p.buf)
    return p


def eq(port, ref):
    """Exact equality, dtype included, of a torch output and a JAX one."""
    ref = np.asarray(ref)
    got = port.cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


def state_arrays(cs):
    return (cs.hmat.numpy().copy(), cs.counts.numpy().copy(),
            cs.btree.numpy().copy(), cs.fences.numpy().copy(), int(cs.n))


def fast_buffer(cs, pb, version, oldest_eff, extra_k=8):
    """The fast path's fused buffer exactly as resolve_async builds it, with
    `extra_k` pad rows in the touched-block list."""
    touched, inc = gpu._touched_blocks(cs._fences_enc, pb.wb_enc, pb.we_enc,
                                       pb.n_writes)
    nbl = len(cs._fences_enc)
    assert not np.any(cs._fills[:nbl] + inc > cs.B - 1), "no headroom"
    K = min(ppack.next_bucket(max(len(touched), 1)) + extra_k, cs.NB)
    g = np.full(K, cs.NB, dtype=np.int32)
    g[: len(touched)] = touched
    buf = np.concatenate([pb.buf, g, np.array([len(touched)], np.int32)])
    lay = pb.layout
    buf[lay.off_scalars] = version - cs._base
    buf[lay.off_scalars + 1] = oldest_eff - cs._base
    buf[lay.off_tsnap: lay.off_tsnap + lay.T] += pb.base - cs._base
    return buf, K


def dense_state(cs):
    """The compaction's densified, deduplicated (last wins) matrix of a
    block state, at the block state's capacity."""
    hmat, counts, *_ = state_arrays(cs)
    W = cs.n_words
    k = np.arange(cs.NB).repeat(cs.B)
    j = np.tile(np.arange(cs.B), cs.NB)
    cols = np.nonzero(j < counts[k])[0]
    enc = ppack.encode_packed_words(hmat[:W, cols].T, hmat[W, cols])
    cols = cols[np.concatenate([enc[1:] != enc[:-1], [True]])]
    dense = ppack.state_pad_block(W, hmat.shape[1])
    dense[:, : len(cols)] = hmat[:, cols]
    return dense, len(cols)


@functools.lru_cache(maxsize=None)
def jax_decode(lay_key):
    lay = jpack.FusedLayout(*lay_key)
    return jax.jit(lambda f: jtpu._decode_fused(f, lay=lay))


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_fused(seed):
    cs, rng, v = grown_state(seed)
    pb = packed(raw_batch(rng, 40, v + 100), cs.oldest_version)
    pb.set_scalars(123, 45)
    want = jax_decode(pb.layout.key())(jnp.asarray(pb.buf))
    got = block.decode_fused(torch.from_numpy(pb.buf), lay=pb.layout)
    assert len(got) == len(want) == 14
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_phase2_fixed_point(seed):
    cs, rng, v = grown_state(seed)
    pb = packed(raw_batch(rng, 25, v + 100, chain=12), cs.oldest_version)
    lay = pb.layout
    dec = block.decode_fused(torch.from_numpy(pb.buf), lay=lay)
    base = (rng.random(lay.T) < 0.1).astype(np.int32)
    kw = dict(q_begin=1, q_end=2, s_begin=3, s_end=4, rtxn=5, wtxn=7,
              w_valid=8)
    statics = dict(T=lay.T, Wr=lay.Wr, P2=lay.P2)

    def jfn(base, *arrs):
        return jtpu._phase2_fixed_point(
            base, smat=arrs[0], **{k: arrs[i] for k, i in kw.items()},
            **statics)

    arrs = [jnp.asarray(d.numpy()) for d in dec[:9]]
    want = jax.jit(jfn)(jnp.asarray(base), *arrs)
    got = gpu._phase2_fixed_point(
        torch.from_numpy(base), smat=dec[0],
        **{k: dec[i] for k, i in kw.items()}, **statics)
    eq(got[0], want[0])
    eq(got[1], want[1])
    assert int(got[1]) > max((lay.T - 1).bit_length(), 1)  # rounds ran


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_resolve_kernel(seed):
    cs, rng, v = grown_state(seed)
    dense, m = dense_state(cs)
    pb = packed(raw_batch(rng, 40, v + 100, chain=6), cs.oldest_version)
    pb.set_scalars(v + 100 - cs._base, v - 300 - cs._base)
    lay = pb.layout
    want = jax.jit(lambda h, n, f: jtpu._resolve_kernel_impl(h, n, f, lay=lay))(
        jnp.asarray(dense), jnp.int32(m), jnp.asarray(pb.buf))
    got = gpu._resolve_kernel_impl(
        torch.from_numpy(dense), torch.tensor(m, dtype=torch.int32),
        torch.from_numpy(pb.buf), lay=lay)
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("probe", ["xla", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_block_resolve_kernel(seed, probe):
    cs, rng, v = grown_state(seed)
    raw = raw_batch(rng, 12, v + 100, chain=4)
    pb = packed(raw, cs.oldest_version)
    buf, K = fast_buffer(cs, pb, v + 100, v - 300)
    hmat, counts, btree, fences, n = state_arrays(cs)
    lay, NB = pb.layout, cs.NB
    want = jax.jit(lambda *a: jtpu._resolve_block_kernel_impl(
        *a, lay=lay, K=K, NB=NB, B=B, probe=probe))(
        jnp.asarray(hmat), jnp.asarray(counts), jnp.asarray(btree),
        jnp.asarray(fences), jnp.int32(n), jnp.asarray(buf))
    t_h, t_c, t_b = (torch.from_numpy(a.copy()) for a in (hmat, counts, btree))
    got = gpu._resolve_block_kernel_impl(
        t_h, t_c, t_b, torch.from_numpy(fences),
        torch.tensor(n, dtype=torch.int32), torch.from_numpy(buf),
        lay=lay, K=K, NB=NB, B=B)
    assert got[0] is t_h and got[1] is t_c and got[2] is t_b  # in place
    for g, w in zip(got, want):
        eq(g, w)
    assert not np.array_equal(t_h.numpy(), hmat)  # the merge wrote


@pytest.mark.parametrize("grow", [False, True])
def test_compact_resolve_kernel(grow):
    cs, rng, v = grown_state(3)
    pb = packed(raw_batch(rng, 40, v + 100, chain=5), cs.oldest_version)
    pb.set_scalars(v + 100 - cs._base, v - 300 - cs._base)
    hmat, counts, *_ = state_arrays(cs)
    lay, NB = pb.layout, cs.NB
    NB_out = 2 * NB if grow else NB
    if grow:  # _grow_blocks precedes a growing compaction
        hmat = np.concatenate(
            [hmat, ppack.state_pad_block(N_WORDS, NB * B)], axis=1)
        counts = np.concatenate([counts, np.zeros(NB, np.int32)])
        NB = NB_out
    want = jax.jit(lambda h, c, f: jtpu._compact_resolve_impl(
        h, c, f, lay=lay, NB=NB, NB_out=NB_out, B=B))(
        jnp.asarray(hmat), jnp.asarray(counts), jnp.asarray(pb.buf))
    got = gpu._compact_resolve_impl(
        torch.from_numpy(hmat), torch.from_numpy(counts),
        torch.from_numpy(pb.buf), lay=lay, NB=NB, NB_out=NB_out, B=B)
    assert len(got) == 6
    for g, w in zip(got, want):
        eq(g, w)


def test_rank_and_table_helpers():
    cs, rng, v = grown_state(5)
    dense, m = dense_state(cs)
    pb = packed(raw_batch(rng, 30, v + 100), cs.oldest_version)
    smat = block.decode_fused(torch.from_numpy(pb.buf), lay=pb.layout)[0]
    W1 = N_WORDS + 1
    hk, q = dense[:W1], smat.numpy()
    eq(gpu._lower_rank(torch.from_numpy(hk), smat),
       jtpu._lower_rank(jnp.asarray(hk), jnp.asarray(q)))
    hcols = hk[:, rng.integers(0, hk.shape[1], q.shape[1])]
    for or_equal in (False, True):
        for g, w in zip(
            gpu._lex_lt_eq(torch.from_numpy(hcols), smat, or_equal),
            jtpu._lex_lt_eq(jnp.asarray(hcols), jnp.asarray(q), or_equal),
        ):
            eq(g, w)
    _, _, _, fences, _ = state_arrays(cs)
    eq(gpu._fence_rank(torch.from_numpy(fences), smat),
       jtpu._fence_rank(jnp.asarray(fences), jnp.asarray(q)))
    hmat = cs.hmat.numpy()
    start = rng.integers(-3, cs.NB * B + 3, q.shape[1]).astype(np.int32)
    for g, w in zip(
        gpu._block_probe(torch.from_numpy(hmat[:W1]), smat,
                         torch.from_numpy(start), B),
        jtpu._block_probe(jnp.asarray(hmat[:W1]), jnp.asarray(q),
                          jnp.asarray(start), B),
    ):
        eq(g, w)

    for n in (1, 7, 64, 100):
        vals = rng.integers(-50, 2**31 - 1, n).astype(np.int32)
        lo = rng.integers(-2, n + 2, 300).astype(np.int32)
        hi = lo + rng.integers(-3, n + 1, 300).astype(np.int32)
        for top, jop, ident in ((torch.maximum, jnp.maximum, 0),
                                (torch.minimum, jnp.minimum, 2**31 - 1)):
            ttab = gpu._build_table(torch.from_numpy(vals), top, ident)
            jtab = jtpu._build_table(jnp.asarray(vals), jop, ident)
            eq(ttab, jtab)
            eq(gpu._table_range_query(ttab, torch.from_numpy(lo),
                                      torch.from_numpy(hi), top, ident),
               jtpu._table_range_query(jtab, jnp.asarray(lo),
                                       jnp.asarray(hi), jop, ident))

    for n_leaves in (16, 20, 917504):
        lo = rng.integers(0, n_leaves, 200).astype(np.int32)
        hi = np.minimum(lo + rng.integers(0, 40, 200), n_leaves).astype(np.int32)
        got, gs = gpu._canonical_nodes_flat(
            torch.from_numpy(lo), torch.from_numpy(hi), n_leaves)
        want, ws = jtpu._canonical_nodes_flat(
            jnp.asarray(lo), jnp.asarray(hi), n_leaves)
        assert gs == ws
        eq(got, want)


def test_ops_hazard_helpers():
    from foundationdb_tpu_torch.resolver import _ops

    x = torch.tensor([1, 2, 3, 4, 5, 6, 7, 8, 255, 256, 2**20, 2**31 - 1],
                     dtype=torch.int32)
    assert _ops.floor_log2(x).tolist() == [
        int(v).bit_length() - 1 for v in x.tolist()]
    imax = torch.tensor([2**31 - 1, 5, -1], dtype=torch.int32)
    assert _ops.add_wrap_i32(imax, torch.ones(3, dtype=torch.int32)).tolist() \
        == [-(2**31), 6, 0]
    assert _ops.int8_twos(torch.tensor([0, 127, 128, 255])).tolist() == [
        0, 127, -128, -1]
    assert _ops.le_bytes(torch.tensor(0x01FF80, dtype=torch.int32)).tolist() \
        == [-128, -1, 1, 0]
    assert _ops.cumsum32(torch.ones(4, dtype=torch.bool)).dtype == torch.int32
    # JAX drops out-of-range scatter updates and wraps a negative index once.
    idx = torch.tensor([0, 5, -1, 9, -9], dtype=torch.int32)
    got = _ops.scatter_new(5, 0, idx, torch.tensor([1, 2, 3, 4, 5]), "add")
    want = jnp.zeros(5, jnp.int32).at[jnp.asarray(idx.numpy())].add(
        jnp.asarray([1, 2, 3, 4, 5], jnp.int32))
    eq(got, want)
