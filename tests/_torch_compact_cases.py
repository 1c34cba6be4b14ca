"""Inputs for the compaction kernels' tests (tests/test_torch_compact.py on
the CPU against the JAX package, tests/test_torch_compact_card.py on a card
against the plain versions). Imports no JAX.

Dense cases feed the dense resolve (gpu._resolve_kernel_impl) directly;
block cases feed the whole compaction (gpu._compact_resolve_impl). States
and batches are made from numpy seeds; batches are raw tuples (snapshot,
read ranges, write ranges) of byte keys, packed by the port's packer with
pinned caps so that each JAX function compiles once per case.
"""

import numpy as np

from _torch_block_cases import grown, k8, raw_batch, txns
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver import packing as ppack
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

CAPS = (64, 32, 32, 16, 16)   # reads, writes, txns, explicit read/write ends


def port_txns(raw):
    return txns(raw, TxnConflictInfo, KeyRange)


def pack(raw, oldest, n_words, version_off, oldest_off, caps=CAPS):
    """The port's packed batch with the step's scalars set."""
    pb = ppack.pack_batch(port_txns(raw), oldest, n_words, caps=caps)
    pb.set_scalars(version_off, oldest_off)
    return pb


def sorted_keys(rng, n, space=100_000):
    return np.sort(rng.choice(space, n, replace=False))


def dense_matrix(keys, versions, n_words, C):
    """A dense (n_words + 2, C) state: the sorted 8-byte keys with their
    versions, pads after them."""
    hm = ppack.state_pad_block(n_words, C)
    n = len(keys)
    if n:
        w, ln = ppack.pack_keys([k8(int(k)) for k in keys], n_words)
        hm[:n_words, :n] = w.T
        hm[n_words, :n] = ln
        hm[n_words + 1, :n] = versions
    return hm


DENSE_CASES = ("empty", "full", "rank0", "pad_queries", "wide",
               "full_less_one", "no_writes", "chunk_edge")
# Inputs outside the kernels' precondition (compact.dense_phase3): the CPU
# tests hold the plain versions to tpu.py there, the card tests skip them.
PLAIN_ONLY_DENSE_CASES = ("full_collide",)


def dense_case(name, seed=0):
    """(hmat, n, packed batch) for the dense resolve:

    - empty: no history at all (every rank 0, reads with rank_b = 0);
    - full: n = C with distinct versions and committed writes above every
      key: the rank walk saturates at C - 1 and new_n passes C (phase 3's
      overflow byte);
    - rank0: reads that begin at the empty key, which the history lacks
      (rank_b = 0, tpu.py's window at lo = -1);
    - pad_queries: a handful of txns in a layout of many slots (pad
      endpoints rank C);
    - wide: 40-byte keys (n_words 10) against history keys that share
      their first words;
    - full_collide: n = C with a committed write that begins at the last
      key and ends past it: its begin ranks C and its end, by the
      saturated walk, C - 1, so tpu.py's merge positions collide (outside
      the kernel's precondition);
    - full_less_one: n = C - 1 (one history pad), committed writes over
      history ranges and one from the last key to just past it, so that
      new_n reaches C;
    - no_writes: reads only, every write endpoint a pad;
    - chunk_edge: n + 2 Wr (the merged slots phase 3 scans) a multiple of
      the blocks of its launched grid, ceil((C + 2 Wr) / 256) on a card
      with at least that many SMs: the last chunk ends exactly there.
    """
    rng = np.random.default_rng(seed)
    C, W = 256, 3
    if name == "empty":
        hm = dense_matrix([], [], W, C)
        return hm, 0, pack(raw_batch(rng, 20, 500, space=300, lag=50), 0, W,
                           500, 100)
    if name == "full":
        keys = sorted_keys(rng, C)
        hm = dense_matrix(keys, 1000 + np.arange(C), W, C)
        raw = [(4000, [], [(k8(200_000 + 10 * i), k8(200_005 + 10 * i))])
               for i in range(12)]
        raw += [(900, [(k8(int(keys[3])), k8(int(keys[9])))], [])]
        return hm, C, pack(raw, 0, W, 5000, 100)
    if name == "full_collide":
        keys = sorted_keys(rng, C)
        hm = dense_matrix(keys, 1000 + np.arange(C), W, C)
        last = int(keys[-1])
        raw = [(4000, [], [(k8(last), k8(last + 5))]),
               (4000, [], [(k8(int(keys[40])), k8(int(keys[40]) + 1))]),
               (900, [(k8(int(keys[3])), k8(int(keys[9])))], [])]
        return hm, C, pack(raw, 0, W, 5000, 100)
    if name == "rank0":
        keys = sorted_keys(rng, 100)
        hm = dense_matrix(keys, rng.integers(1, 400, 100), W, C)
        raw = [(300, [(b"", k8(int(keys[7 * i])))],
                [(k8(int(keys[i])), k8(int(keys[i])) + b"\x00")])
               for i in range(10)]
        return hm, 100, pack(raw, 0, W, 500, 100)
    if name == "pad_queries":
        keys = sorted_keys(rng, 150)
        hm = dense_matrix(keys, rng.integers(1, 400, 150), W, C)
        raw = raw_batch(rng, 3, 500, space=100_000, lag=300)
        pb = pack(raw, 0, W, 500, 100)
        assert pb.n_reads < pb.layout.R and pb.n_writes < pb.layout.Wr
        return hm, 150, pb
    if name == "full_less_one":
        keys = sorted_keys(rng, C - 1)
        hm = dense_matrix(keys, 1000 + np.arange(C - 1), W, C)
        last = int(keys[-1])
        raw = [(4000, [], [(k8(int(keys[10 * i])), k8(int(keys[10 * i + 4])))])
               for i in range(8)]
        raw += [(4000, [], [(k8(last), k8(last) + b"\x00")]),
                (900, [(k8(int(keys[3])), k8(int(keys[9])))], [])]
        return hm, C - 1, pack(raw, 0, W, 5000, 100)
    if name == "no_writes":
        keys = sorted_keys(rng, 150)
        hm = dense_matrix(keys, rng.integers(1, 400, 150), W, C)
        raw = [(int(rng.integers(100, 450)),
                [(k8(int(keys[i])), k8(int(keys[i + 7])))], [])
               for i in range(0, 140, 9)]
        pb = pack(raw, 0, W, 500, 100)
        assert pb.n_writes == 0 and pb.layout.Wr > 0
        return hm, 150, pb
    if name == "chunk_edge":
        C = 1024
        keys = sorted_keys(rng, C)
        raw = raw_batch(rng, 20, 500, space=100_000, lag=300,
                        hot=keys[:600])
        pb = pack(raw, 0, W, 500, 100)
        M = 2 * pb.layout.Wr
        blocks = -(-(C + M) // 256)
        n = C - 100 - (C - 100 + M) % blocks
        hm = dense_matrix(keys[:n], rng.integers(1, 400, n), W, C)
        return hm, n, pb
    if name == "wide":
        W = 10
        head = bytes(rng.integers(0, 256, 24, dtype=np.uint8))
        ks = sorted({head + bytes(rng.integers(0, 256, int(rng.integers(
            1, 17)), dtype=np.uint8)) for _ in range(120)})
        hm = ppack.state_pad_block(W, C)
        w, ln = ppack.pack_keys(ks, W)
        n = len(ks)
        hm[:W, :n] = w.T
        hm[W, :n] = ln
        hm[W + 1, :n] = rng.integers(1, 400, n)
        raw = []
        for i in range(20):
            a, b = sorted((ks[int(rng.integers(0, n))],
                           head + bytes(rng.integers(0, 256, 8,
                                                     dtype=np.uint8))))
            raw.append((int(rng.integers(100, 450)), [(a, b + b"\x00")],
                        [(b, b + b"\x00")] if i % 2 else []))
        return hm, n, pack(raw, 0, W, 500, 100, caps=(48, 24, 24, 24, 24))
    raise KeyError(name)


BLOCK_CASES = ("runs_across_blocks", "grow", "shrink", "overflow", "wide",
               "b8", "b32", "b512", "over_full", "empty_state", "long_run")

# Made-up block states (B 8, 16 blocks): each block's contents as indexes
# into 20 sorted keys (repeats are duplicates); blocks not listed are
# empty.
MADE_UP = {
    "runs_across_blocks": [[0, 1, 2, 3], [3, 4, 4, 5], [], [5, 6, 7, 8, 9, 10,
                                                           11],
                           [11], [], [12, 13, 13, 13], [14, 15]],
    "over_full": [[0, 1, 2], [3, 4], [], [5, 6, 7, 8],
                  [9, 10, 11, 12, 13, 14, 15, 16], [], [17, 18]],
    "empty_state": [],
    "long_run": [[0, 1, 2], [2], [], [], [2], [], [2, 2, 3], [3], [], [],
                 [3, 4, 5], [6]],
}


def made_up_state(rng, blocks, B=8, NB=16, W=3):
    """(hmat, counts, keys) of a block state with the given contents."""
    keys = sorted_keys(rng, 20)
    hm = ppack.state_pad_block(W, NB * B)
    counts = np.zeros(NB, np.int32)
    for b, idx in enumerate(blocks):
        counts[b] = len(idx)
        if not idx:
            continue
        w, ln = ppack.pack_keys([k8(int(keys[i])) for i in idx], W)
        cols = slice(b * B, b * B + len(idx))
        hm[:W, cols] = w.T
        hm[W, cols] = ln
        hm[W + 1, cols] = 100 + np.arange(len(idx)) + 10 * b
    return hm, counts, keys


def block_case(name, seed=0, device="cpu"):
    """(hmat, counts, packed batch, NB, NB_out, B) for the compaction:

    - runs_across_blocks: a made-up block state whose equal-key runs
      cross block boundaries (a block's last key is the next block's
      first) and sit inside blocks, with empty blocks between;
    - grow: a grown state padded to twice its blocks, as _grow_blocks
      leaves it before a growing compaction (NB = NB_out);
    - shrink: a grown state padded to eight times its blocks, NB_out well
      under NB, as compacted_blocks picks it for a state that emptied;
    - overflow: NB_out too small for the set (new_n > NB_out * B/2: the
      overflow byte);
    - wide: 40-byte keys;
    - b8, b32, b512: grown states at those block sizes;
    - over_full: a block whose count (11) exceeds B (8): densify scatters
      its first B entries, and the positions after them are pads inside
      the live range that dedup to one;
    - empty_state: no entry at all (densify's m and phase 3's n are 0);
    - long_run: an equal-key run over four blocks with empty blocks
      between them, and another over three.
    """
    rng = np.random.default_rng(seed)
    if name in MADE_UP:
        B, NB, W = 8, 16, 3
        hm, counts, keys = made_up_state(rng, MADE_UP[name], B, NB, W)
        if name == "over_full":
            counts[4] = 11
        raw = raw_batch(rng, 6, 600, space=100_000, lag=400)
        raw += [(550, [], [(k8(int(keys[3])), k8(int(keys[5])))])]
        return hm, counts, pack(raw, 0, W, 600, 50), NB, NB, B
    B = {"b8": 8, "b512": 512}.get(name, 32)
    wide = 28 if name == "wide" else 0
    cs, rng, v = grown(seed, B=B, max_key_bytes=40 if wide else 9,
                       capacity=max(1024, 8 * B), space=2000, wide=wide,
                       device=device)
    hm = cs.hmat.cpu().numpy()
    counts = cs.counts.cpu().numpy()
    NB = NB_out = cs.NB
    if name in ("grow", "shrink"):   # empty blocks after the live ones
        more = NB if name == "grow" else 7 * NB
        hm = np.concatenate(
            [hm, ppack.state_pad_block(cs.n_words, more * B)], axis=1)
        counts = np.concatenate([counts, np.zeros(more, np.int32)])
        NB = NB_out = NB + more
    if name == "shrink":   # room for every entry and every endpoint
        room = -(-(int(counts.sum()) + 2 * CAPS[1]) // (B // 2))
        NB_out = ppack.next_pow2(room + 1)
        assert NB_out < NB
    elif name == "overflow":  # room for a quarter of the entries
        NB_out = ppack.next_pow2(int(counts.sum()) // (2 * B)) // 2
    raw = raw_batch(rng, 24, v + 50, space=2000, lag=150, span=300, wide=wide)
    caps = (48, 24, 24, 24, 24) if wide else CAPS
    pb = pack(raw, cs.oldest_version, cs.n_words, v + 50 - cs._base,
              v - 300 - cs._base, caps=caps)
    return hm, counts, pb, NB, NB_out, B


# ---------------------------------------------------------------- ranks

RANKS_CASES = ("clustered", "wide_bracket", "one_gap", "above_last", "n0",
               "n_c_less_one", "n_c", "long_reads")
# A tier (compact.RANKS_TIERS) some run of the kernel takes on the case:
# the tile where a run's walks stay within a few thousand columns, each
# thread in device memory where a run's 256 endpoints spread over the
# history.
RANKS_CASE_TIER = {"wide_bracket": "wide", "clustered": "tile",
                   "one_gap": "tile", "above_last": "tile", "n0": "tile",
                   "long_reads": "wide"}
PAD = 2**31 - 1


def word_keys(rng, n, W, lo, hi):
    """n distinct sorted keys of W signed words and a length row,
    (n, W + 1) int64, word 0 drawn from [lo, hi)."""
    k = np.zeros((3 * n + 8, W + 1), np.int64)
    k[:, 0] = rng.integers(lo, hi, len(k))
    k[:, 1:W] = rng.integers(-3, 3, (len(k), W - 1))
    k[:, W] = rng.integers(0, 4 * W, len(k))
    k = np.unique(k, axis=0)
    return k[np.sort(rng.choice(len(k), min(n, len(k)), replace=False))]


def ranks_case(name, seed=0):
    """ranks' operands (hmat, n, smat, q_begin, q_end, rsnap, rtxn,
    too_old, all numpy) on a dense state of C = 2^16 columns, W = 3, whose
    columns past n are pads:

    - clustered: endpoints among a few hundred history keys (every run's
      walks in the tile);
    - wide_bracket: 512 endpoints spread over a history of C - 64 keys (a
      run spans some 32,000 columns: each thread walks device memory);
    - one_gap: every endpoint between the same two history keys;
    - above_last: every endpoint above the last history key;
    - n0, n_c_less_one, n_c: n = 0, C - 1 and C (the walk's saturation at
      C - 1, endpoints above the last key among them);
    - long_reads: reads whose ranges span most of n, which reach the
      maxima's every level.
    """
    rng = np.random.default_rng(seed)
    C, W, P2, R, T = 1 << 16, 3, 2048, 512, 64
    n = {"n0": 0, "n_c_less_one": C - 1, "n_c": C,
         "wide_bracket": C - 64}.get(name, 60_000)
    if name == "one_gap":
        hist = np.zeros((n, W + 1), np.int64)
        hist[:, 0] = 2 * np.arange(n) - n
        hist[:, W] = 1
    else:
        hist = word_keys(rng, n, W, -(1 << 30), 1 << 30)
        n = len(hist)
    hm = np.zeros((W + 2, C), np.int32)
    hm[: W + 1] = PAD
    hm[: W + 1, :n] = hist.T
    hm[W + 1, :n] = rng.integers(0, 1 << 20, n)
    n_real = {"wide_bracket": 512}.get(name, P2 - 40)
    if name == "clustered":
        at = int(hist[n // 2, 0])
        ends = word_keys(rng, n_real, W, at, at + (1 << 30) // 40)
    elif name == "one_gap":
        g = int(hist[n // 3, 0])
        ends = np.zeros((n_real, W + 1), np.int64)
        ends[:, 0] = g + 1
        ends[:, 1] = np.arange(n_real) - n_real // 2
    elif name == "above_last":
        ends = word_keys(rng, n_real, W, 1 << 30, (1 << 31) - 1)
    else:
        ends = word_keys(rng, n_real, W, -(1 << 30) - 5, (1 << 30) + 5)
        if n:   # some endpoints equal history keys
            same = rng.choice(n, min(n, 64), replace=False)
            ends = np.unique(np.concatenate([ends[: n_real - 64],
                                             hist[same]]), axis=0)
    smat = np.full((W + 1, P2), PAD, np.int32)
    smat[:, : len(ends)] = ends.T
    if name == "long_reads":
        q_begin = rng.integers(0, P2 // 16, R)
        q_end = rng.integers(P2 - P2 // 8, P2, R)
    else:
        q_begin = rng.integers(0, P2 - 8, R)
        q_end = q_begin + rng.integers(0, 8, R)
    return (hm, np.int32(n), smat, q_begin.astype(np.int32),
            q_end.astype(np.int32),
            rng.integers(0, 1 << 20, R).astype(np.int32),
            rng.integers(0, T, R).astype(np.int32), rng.random(T) < 0.1)


# --------------------------------------------------------- redistribute

REDIST_NEW_N = ("zero", "one", "F_less_one", "F", "fill_less_one", "fill",
                "fill_plus_three")


def redist_case(new_n, B, NB_out, seed=0):
    """redistribute's operands (hmat_d, new_n, st_aux, all numpy) for
    NB_out blocks of B slots: a dense state of NB_out B / 2 + 8 columns
    (W = 3) holding new_n live entries, new_n named by REDIST_NEW_N (the
    fill NB_out B / 2 and past it: the overflow byte)."""
    rng = np.random.default_rng(seed)
    W, F = 3, B // 2
    C = NB_out * F + 8
    nn = {"zero": 0, "one": 1, "F_less_one": F - 1, "F": F,
          "fill_less_one": NB_out * F - 1, "fill": NB_out * F,
          "fill_plus_three": NB_out * F + 3}[new_n]
    hm = np.zeros((W + 2, C), np.int32)
    hm[: W + 1] = PAD
    hm[:W, :nn] = rng.integers(-(1 << 30), 1 << 30, (W, nn))
    hm[W, :nn] = rng.integers(0, 12, nn)
    hm[W + 1, :nn] = rng.integers(-5, 1 << 20, nn)
    st_aux = rng.integers(0, 3, 16 + 6).astype(np.int8)
    st_aux[16 + 4] = 0
    return hm, np.int32(nn), st_aux
