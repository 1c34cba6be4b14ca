"""Operands of the storage read dispatch (gpu_engine._read_kernel_impl: the
probe, then storage_engine/read.read_gather) made from a storage engine's
own state, for tests/test_torch_read.py (the JAX package's
KeyValueStoreTPU, against tpu_engine._read_kernel_impl on the CPU) and
tests/test_torch_read_card.py (the port's KeyValueStoreGPU, the CUDA
kernel against its plain version). Nothing here imports JAX: the engine
class is the caller's.
"""

import numpy as np

I32MAX = 2**31 - 1
I32MIN = -2**31


def key(i: int, n_words: int) -> bytes:
    """Key i, long enough to need all n_words packed words."""
    base = b"%04d" % i if n_words == 1 else b"r%04d" % i
    return base + b"k" * max(0, 4 * (n_words - 1) + 1 - len(base))


def fill(eng, rng, n_words: int, n_keys: int, n_delta: int) -> int:
    """Random sets and clears (the base compacted), then n_delta writes
    left in the delta. Returns the next version."""
    v = 100
    for _ in range(n_keys):
        k = key(int(rng.integers(0, 3 * n_keys)), n_words)
        if rng.random() < 0.2:
            eng.clear(k, v)
        else:
            eng.set(k, b"v", v)
        v += int(rng.integers(0, 3))
    eng._compact()
    for _ in range(n_delta):
        eng.set(key(int(rng.integers(0, 3 * n_keys)), n_words), b"d", v)
        v += 1
    eng._fold_pending()
    return v


def read_operands(engine_cls, seed: int, n_words: int, n_keys: int,
                  n_delta: int, P: int, R: int, before_first: bool = False,
                  fill_spans: bool = False, **engine_kw):
    """(arrays, qall, rv, meta, eng) of one read dispatch: the engine's
    seven device arrays (hmat, slots, nextsame, fences, dmat, dslots,
    dnext) as numpy, a (W2, P+2R) query matrix whose columns copy stored
    entries and fences with the version row at -1, the stored version, +1
    or I32MAX, plus random keys and a +inf pad column; range endpoints at
    version -1. before_first: a quarter of the points get key words below
    every stored key. fill_spans: every range runs from the smallest
    stored key to the +inf pad, wider than any span."""
    rng = np.random.default_rng(seed)
    eng = engine_cls(n_words=n_words, block_slots=8, **engine_kw)
    v = fill(eng, rng, n_words, n_keys, n_delta)
    arrs = [np.array(a) for a in (eng._d_hmat, eng._d_slots, eng._d_next,
                                  eng._d_fences, eng._d_dmat, eng._d_dslots,
                                  eng._d_dnext)]
    hmat, fences = arrs[0], arrs[3]
    W2, n = hmat.shape[0], P + 2 * R
    cols = np.concatenate([hmat, fences], axis=1)
    live = cols[:, cols[W2 - 2] != I32MAX]
    q = live[:, rng.integers(0, live.shape[1], n)].copy()
    vers = q[W2 - 1].astype(np.int64) + rng.integers(-1, 2, n)
    edge = rng.random(n) < 0.4
    vers[edge] = rng.choice(np.array([-1, 0, I32MAX], np.int64), edge.sum())
    q[W2 - 1] = np.clip(vers, -1, I32MAX)
    rand = rng.integers(0, n, n // 5)
    q[:W2 - 2, rand] = rng.integers(I32MIN, I32MAX, (W2 - 2, rand.size))
    if before_first and P:
        low = rng.choice(P, max(1, P // 4), replace=False)
        q[:W2 - 2, low] = I32MIN
    q[:, -1] = hmat[:, -1]  # a +inf pad column
    if fill_spans and R:
        first = int(np.argmax(hmat[W2 - 2] != I32MAX))
        q[:, P:P + R] = hmat[:, first][:, None]
        q[:, P + R:] = hmat[:, -1][:, None]
    q[W2 - 1, P:] = -1  # range endpoints ignore versions
    rv = rng.integers(0, v - eng._vbase + 2, R).astype(np.int32)
    meta = dict(F=eng.F, NB=eng.NB, B=eng.B)
    return arrs, q.astype(np.int32), rv, meta, eng


# (P, R, S, n_delta): test_torch_storage_engine.py's
# test_read_kernel_matches_jax grid.
GRID = [(8, 0, 8, 0), (8, 8, 8, 5), (16, 8, 16, 0), (24, 16, 32, 30),
        (8, 9, 16, 12)]
