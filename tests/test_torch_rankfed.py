"""The port's rank-fed conflict set, ConflictSetRankFed(device="cpu"),
against the JAX package's ConflictSetRankFed and the oracle.

- every case of tests/test_conflict_rankfed.py, run from that file with
  its ConflictSetRankFed swapped for the port's (the reference file is
  loaded under another module name and left as it is);
- a same-seed differential over 8 seeds: numpy-seeded batches into both
  packages' sets and the JAX oracle, with GC rounds on a short cadence,
  capacity growth, a width growth and horizon advances; statuses,
  entries(), the raw version vector, the mirror and n equal after every
  batch;
- `_rank_kernel_impl` on the same fused RankLayout buffer (pad rows, a
  nearly full capacity) against the JAX kernel, and the phase-3 merge
  positions checked disjoint in numpy;
- an abort chain (txn i reads what txn i-1 writes) whose fixed point
  needs about T rounds: every round group and the T + 2 cap's last,
  shortened group;
- the host encoding byte for byte, the pipelined pack/resolve_async
  path, and the entry point without a card.
"""

import importlib.util
import struct
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver import rankfed as jrf
from foundationdb_tpu.resolver.cpu import ConflictSetCPU
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as PKNOBS
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import rankfed as prf
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn

REF = Path(__file__).with_name("test_conflict_rankfed.py")


def _load_reference():
    spec = importlib.util.spec_from_file_location("_ref_conflict_rankfed",
                                                  REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


def _reference_cases():
    cases = [f"TestRankFedBasics.{n}" for n in dir(ref.TestRankFedBasics)
             if n.startswith("test_")]
    cases += [f"test_differential_randomized[{s}]" for s in range(8)]
    return cases + ["test_sliding_window_steady_state"]


@pytest.mark.parametrize("case", _reference_cases())
def test_reference_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(ref, "ConflictSetRankFed",
                        partial(prf.ConflictSetRankFed, device="cpu"))
    if case.startswith("TestRankFedBasics."):
        getattr(ref.TestRankFedBasics(), case.split(".")[1])()
    elif case.startswith("test_differential_randomized["):
        ref.test_differential_randomized(int(case[-2]))
    else:
        getattr(ref, case)()


# ------------------------------------------------ same-seed differential


def key(a: int, wide: bool = False) -> bytes:
    k = struct.pack(">Q", int(a))
    return b"wide/" * 4 + k if wide else k


def raw_batch(rng, n, version, space=300, lag=400, wide=False):
    out = []
    for _ in range(n):
        rr = [(key(a, wide), key(a + int(rng.integers(1, 6)), wide))
              for a in map(int, rng.integers(0, space, rng.integers(0, 4)))]
        wr = [(key(a, wide), key(a + int(rng.integers(1, 3)), wide))
              for a in map(int, rng.integers(0, space, rng.integers(0, 3)))]
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def txns(raw, jax_side: bool):
    T, KR = (JTxn, JKeyRange) if jax_side else (PTxn, PKeyRange)
    return [T(s, [KR(*r) for r in rr], [KR(*w) for w in wr])
            for s, rr, wr in raw]


def same_state(j, p):
    assert p.n == j.n and p.capacity == j.capacity
    assert p.n_words == j.n_words and p.oldest_version == j.oldest_version
    assert p.mirror.dtype == j.mirror.dtype
    assert np.array_equal(p.mirror, j.mirror)
    assert np.array_equal(p.hv.numpy(), np.asarray(j.hv))


@pytest.fixture
def short_gc(monkeypatch):
    monkeypatch.setattr(JKNOBS, "TPU_COMPACT_EVERY_BATCHES", 4)
    monkeypatch.setattr(PKNOBS, "TPU_COMPACT_EVERY_BATCHES", 4)


@pytest.mark.parametrize("seed", range(8))
def test_same_seed_differential_against_jax(seed, short_gc):
    rng = np.random.default_rng(seed)
    ora = ConflictSetCPU()
    jset = jrf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=64)
    pset = prf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=64,
                                  device="cpu")
    version, gc0 = 1000, pset.gc_rounds
    for b in range(12):
        raw = raw_batch(rng, int(rng.integers(1, 24)), version,
                        wide=(b == 6))
        oldest = version - 300 if b % 3 else 0
        want = ora.resolve(version, oldest, txns(raw, True)).statuses
        got_j = jset.resolve(version, oldest, txns(raw, True)).statuses
        got_p = pset.resolve(version, oldest, txns(raw, False)).statuses
        assert got_j == want
        assert got_p == got_j, f"seed {seed} batch {b}"
        same_state(jset, pset)
        assert pset.entries() == jset.entries() == ora.entries()
        version += int(rng.integers(20, 120))
    assert pset.gc_rounds - gc0 >= 2          # the cadence ran
    assert pset.capacity > 64                 # capacity grew
    assert pset.n_words > 2                   # the width grew


# ------------------------------------------------ the kernel on one buffer


def _fused(pset, raw, version, oldest):
    pb = pset.pack(txns(raw, False))
    pb.set_scalars(version - pset.oldest_version,
                   max(oldest, pset.oldest_version) - pset.oldest_version)
    pb.buf[pb.layout.off_scalars + 2] = pset.n
    return pb


def merge_positions(buf, lay):
    """Phase 3's merge positions recomputed in numpy from the buffer."""
    ub = buf[lay.off_ub_c:lay.off_ub_c + lay.M].astype(np.int64)
    cnt = np.bincount(np.minimum(ub, lay.C), minlength=lay.C + 1)
    pos_a = np.arange(lay.C) + np.cumsum(cnt[:lay.C])
    pos_b = np.arange(lay.M) + ub
    return pos_a, pos_b


@pytest.mark.parametrize("fill", ["sparse", "nearly_full"])
def test_rank_kernel_matches_jax_on_one_buffer(fill):
    rng = np.random.default_rng(5)
    pset = prf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=128,
                                  device="cpu")
    version = 100
    # Reads and writes under their padded sizes: pad rows in every segment.
    raw = raw_batch(rng, 5, version + 5000, space=5000)
    n_w = sum(len(w) for _, _, w in raw)
    # Fill the history with superset inserts (2 entries per write, no GC
    # round) until this batch's endpoints leave at most one slot free.
    while fill == "nearly_full" and pset.n + 2 + 2 * n_w <= pset.capacity - 1:
        one = [(version - 10, [], [(key(version), key(version + 1))])]
        pset.resolve_packed(version, 0, pset.pack(txns(one, False)))
        version += 50
    version += 5000
    pb = _fused(pset, raw, version, version - 120)
    lay = pb.layout
    assert pb.n_reads < lay.R and pb.n_writes < lay.Wr and pb.n_txns < lay.T
    assert pset.n + 2 * pb.n_writes <= lay.C - 1
    if fill == "nearly_full":
        assert pset.n + 2 * pb.n_writes >= lay.C - 2
    pos_a, pos_b = merge_positions(pb.buf, lay)
    assert len(np.unique(pos_a)) == lay.C and len(np.unique(pos_b)) == lay.M
    assert not np.intersect1d(pos_a, pos_b).size
    assert max(pos_a.max(), pos_b.max()) < lay.C + lay.M

    hv = pset.hv.numpy().copy()
    want_hv, want_st = jrf._rank_kernel_impl(jnp.asarray(hv),
                                             jnp.asarray(pb.buf), lay=lay)
    got_hv, got_st = prf._rank_kernel_impl(torch.from_numpy(hv),
                                           torch.from_numpy(pb.buf),
                                           lay=lay)
    assert got_hv.dtype == torch.int32 and got_st.dtype == torch.int32
    assert np.array_equal(got_hv.numpy(), np.asarray(want_hv))
    assert np.array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("length,groups", [(15, 4), (16, 5)])
def test_abort_chain_runs_every_round_group(length, groups):
    """txn i reads what txn i-1 writes: the fixed point settles one txn
    per round, so phase 2 runs `length` rounds in T = 16: groups 1, 2, 4,
    8 for 15, and for 16 a fifth one the T + 2 cap cuts from 8 rounds to
    3. Statuses alternate, as the JAX kernel's."""
    raw = [(9, [(key(i - 1), key(i - 1) + b"\x00")] if i else [],
            [(key(i), key(i) + b"\x00")]) for i in range(length)]
    jset = jrf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=64)
    pset = prf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=64,
                                  device="cpu")
    p0 = prf.P2_SYNCS
    got = pset.resolve(10, 0, txns(raw, False)).statuses
    assert prf.P2_SYNCS - p0 == groups
    assert got == jset.resolve(10, 0, txns(raw, True)).statuses
    assert got == [i % 2 for i in range(length)]
    same_state(jset, pset)


def test_pipelined_pack_after_dispatch_equals_the_oracle(short_gc):
    """pack(k + 1) after resolve_async(k), results read four behind, with
    prepare() (the width, capacity and GC rule) before each pack."""
    rng = np.random.default_rng(11)
    ora = ConflictSetCPU()
    pset = prf.ConflictSetRankFed(max_key_bytes=8, initial_capacity=64,
                                  device="cpu")
    version, want, got, pending = 500, [], [], []
    for b in range(14):
        raw = raw_batch(rng, 12, version, wide=(b == 9))
        oldest = max(0, version - 250)
        want.append(ora.resolve(version, oldest, txns(raw, True)).statuses)
        batch = txns(raw, False)
        pset.prepare(batch)
        pending.append(pset.resolve_async(version, oldest,
                                          pset.pack(batch)))
        if len(pending) > 4:
            got.append([int(s) for s in pending.pop(0).result()])
        version += 60
    got += [[int(s) for s in h.result()] for h in pending]
    assert got == want
    assert pset.entries() == ora.entries()
    assert pset.gc_rounds >= 3


# ------------------------------------------------ host helpers and entry


def test_encoding_is_byte_equal():
    rng = np.random.default_rng(3)
    keys = [bytes(rng.integers(0, 256, int(rng.integers(0, 13)),
                               dtype=np.uint8)) for _ in range(300)]
    keys += [b"", b"\x00", b"\xff" * 12]
    for w in (1, 3, 4):
        short = [k[:4 * w] for k in keys]
        a, b = prf.encode_keys(short, w), jrf.encode_keys(short, w)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        wa, wb = prf.widen_encoded(a, w, 2 * w), jrf.widen_encoded(b, w, 2 * w)
        assert wa.dtype == wb.dtype and np.array_equal(wa, wb)
        assert np.array_equal(wa, prf.encode_keys(short, 2 * w))
        for tag in (1, 2):
            assert np.array_equal(prf._tagged(a, tag), jrf._tagged(b, tag))


def test_layout_matches_the_jax_layout():
    for shape in [(1, 1, 1, 64), (8, 4, 2, 1024), (512, 128, 64, 1 << 16)]:
        a, b = prf.RankLayout(*shape), jrf.RankLayout(*shape)
        assert vars(a) == vars(b)


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prf.ConflictSetRankFed()
    assert prf.ConflictSetRankFed(device="cpu").hv.device.type == "cpu"
