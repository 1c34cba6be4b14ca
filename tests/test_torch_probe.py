"""The port's rank probe against the JAX package's two probes.

`foundationdb_tpu_torch.resolver.probe.probe_ranks` on CPU tensors runs its
plain torch version (the hand-written CUDA kernel runs only on the card,
where chip_smoke.py holds it against this same plain version). Here the
plain version must equal, exactly and in dtype, both JAX references on the
same inputs: `tpu._fence_rank` + `tpu._block_probe` (the XLA probe) and
`pallas_probe.probe_ranks` under jax.jit (the Pallas kernel, in interpret
mode on the CPU). The cases come from chip_smoke.probe_case, the same
generator the card's kernel-vs-plain check uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import probe_case
from foundationdb_tpu.resolver import pallas_probe
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu_torch.resolver import probe


@pytest.mark.parametrize("P2", [8, 700, 1024])
@pytest.mark.parametrize("W1", [2, 4, 5])
@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("NB", [8, 64])
def test_plain_probe_equals_both_jax_probes(NB, B, W1, P2):
    rng = np.random.default_rng(NB * 1000 + B * 100 + W1 * 10 + P2)
    h, f, q = probe_case(rng, W1, NB, B, P2)
    before = probe.LAUNCHES
    got = probe.probe_ranks(torch.from_numpy(h), torch.from_numpy(f),
                            torch.from_numpy(q), NB=NB, B=B)
    assert probe.LAUNCHES == before  # CPU tensors: the plain version
    assert all(g.dtype == torch.int32 and g.shape == (P2,) for g in got)
    got = [g.numpy() for g in got]

    bid = jtpu._fence_rank(jnp.asarray(f), jnp.asarray(q))
    lb, eq = jtpu._block_probe(
        jnp.asarray(h), jnp.asarray(q), jnp.clip(bid, 0, NB - 1) * B, B
    )
    pallas = jax.jit(
        lambda h, f, q: pallas_probe.probe_ranks(h, f, q, NB=NB, B=B)
    )(jnp.asarray(h), jnp.asarray(f), jnp.asarray(q))
    for ref in ((bid, lb, eq), pallas):
        for g, r in zip(got, ref):
            r = np.asarray(r)
            assert r.dtype == np.int32
            np.testing.assert_array_equal(g, r)
    # The case reaches every branch: a query below fence 0, exact hits.
    assert (got[0] == -1).any() and got[2].any()


def _lex(h, q):
    """Lexicographic h < q and h == q of (W1, n) int32 word columns."""
    lt = np.zeros(q.shape[1], dtype=bool)
    eq = np.ones(q.shape[1], dtype=bool)
    for w in range(q.shape[0]):
        lt |= eq & (h[w] < q[w])
        eq &= h[w] == q[w]
    return lt, eq


def _window(h, q, base, win):
    """Replay the last log2(win) halving steps and the equality step on the
    lt/eq bit masks of the win columns at base (a multiple of win)."""
    assert (base % win == 0).all()
    ltm = np.zeros(q.shape[1], dtype=np.int64)
    eqm = np.zeros(q.shape[1], dtype=np.int64)
    for j in range(win):
        lt, eq = _lex(h[:, base + j], q)
        ltm |= lt.astype(np.int64) << j
        eqm |= eq.astype(np.int64) << j
    b = np.zeros(q.shape[1], dtype=np.int64)
    s = win >> 1
    while s >= 1:
        b += ((ltm >> (b + s - 1)) & 1) * s
        s >>= 1
    return b, ((eqm >> b) & 1).astype(bool)


def kernel_model(h, f, q, NB, B, L, win=4):
    """numpy model of csrc/probe.cu's index arithmetic with L staged levels
    (kLevels = 6 in the kernel) and its kWin = 4 closing window: the fence
    walk's top levels from the staged directory (fence j*g - 1 at slot
    j - 1; the step at (pos, s) reads slot (pos + s)/g - 1), then single
    steps down to s = win, then the window's bit-mask replay where the
    launch applies it (NB a power of two >= win; B >= win), likewise in
    the block."""
    n = q.shape[1]
    log_nb = NB.bit_length() - 1
    pow2 = NB == 1 << log_nb
    win_f = pow2 and NB >= win
    win_b = B >= win
    L = min(L, log_nb - (win.bit_length() - 1 if win_f else 0)) if pow2 else 0
    g = NB >> L
    staged = f[:, np.arange(1, 1 << L) * g - 1]
    pos = np.zeros(n, dtype=np.int64)
    s = NB >> 1
    for _ in range(L):
        lt, _ = _lex(staged[:, (pos + s) // g - 1], q)
        pos += lt * s
        s >>= 1

    def steps(h, base, pos, s, until):
        while s >= until:
            lt, _ = _lex(h[:, base + pos + s - 1], q)
            pos = pos + lt * s
            s >>= 1
        return pos

    zero = np.zeros(n, dtype=np.int64)
    if win_f:
        pos = steps(f, zero, pos, s, win)
        b, eq = _window(f, q, pos, win)
        pos = pos + b
    else:
        pos = steps(f, zero, pos, s, 1)
        _, eq = _lex(f[:, np.clip(pos, 0, NB - 1)], q)
    bid = pos + eq - 1

    start = np.clip(bid, 0, NB - 1) * B
    assert (start + B - 1 < h.shape[1]).all()
    if win_b:
        off = steps(h, start, zero, B >> 1, win)
        assert (off + win <= B).all()
        b, eq = _window(h, q, start + off, win)
        off = off + b
    else:
        off = steps(h, start, zero, B >> 1, 1)
        _, eq = _lex(h[:, start + off], q)
    return [a.astype(np.int32) for a in (bid, off, eq)]


_JAX_REF = {}


def _jax_ref(key, h, f, q, NB, B):
    if key not in _JAX_REF:
        bid = jtpu._fence_rank(jnp.asarray(f), jnp.asarray(q))
        lb, eq = jtpu._block_probe(
            jnp.asarray(h), jnp.asarray(q), jnp.clip(bid, 0, NB - 1) * B, B
        )
        _JAX_REF[key] = [np.asarray(a) for a in (bid, lb, eq)]
    return _JAX_REF[key]


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("sorted_q", [False, True])
@pytest.mark.parametrize("L", [0, 2, 6, 8])
@pytest.mark.parametrize("W1", [2, 9])
@pytest.mark.parametrize("B", [4, 8, 32, 64])
@pytest.mark.parametrize("NB", [4, 24, 1024])
def test_kernel_index_model_equals_the_walk(NB, B, W1, L, sorted_q,
                                            permuted):
    rng = np.random.default_rng(NB * 7 + B * 5 + W1 * 3 + permuted)
    h, f, q = probe_case(rng, W1, NB, B, 200, permute=permuted)
    if sorted_q:  # the resolver's order: lexicographic key columns
        q = np.ascontiguousarray(q[:, np.lexsort(q[::-1])])
    got = kernel_model(h, f, q, NB, B, L)
    plain = probe.probe_ranks_ref(torch.from_numpy(h), torch.from_numpy(f),
                                  torch.from_numpy(q), NB=NB, B=B)
    jref = _jax_ref((NB, B, W1, permuted, sorted_q), h, f, q, NB, B)
    for g, p, j in zip(got, plain, jref):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, j)
    if permuted:  # the walk, not a count of smaller slots, is what holds
        start = np.clip(got[0], 0, NB - 1) * B
        cols = start[:, None] + np.arange(B)
        smaller = np.zeros_like(cols, dtype=bool)
        eqs = np.ones_like(cols, dtype=bool)
        for w in range(W1):
            a, b = h[w][cols], q[w][:, None]
            smaller |= eqs & (a < b)
            eqs &= a == b
        assert (smaller.sum(1) != got[1]).any()


def test_probe_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(0)
    h, f, q = (torch.from_numpy(a) for a in probe_case(rng, 3, 8, 8, 16))
    with pytest.raises(TypeError):
        probe.probe_ranks(h.to(torch.int64), f, q, NB=8, B=8)
    with pytest.raises(ValueError):
        probe.probe_ranks(h, f, q[:, ::2], NB=8, B=8)  # not contiguous
    with pytest.raises(ValueError):
        probe.probe_ranks(h, f, q, NB=16, B=8)         # fences shape
    with pytest.raises(ValueError):
        probe.probe_ranks(h[:, :32].contiguous(), f, q, NB=8, B=8)


def test_probe_launch_takes_only_cuda_tensors():
    """probe_ranks_into is the kernel's launch: a CPU tensor raises (no
    plain fallback) and the count stays."""
    rng = np.random.default_rng(1)
    h, f, q = (torch.from_numpy(a) for a in probe_case(rng, 3, 8, 8, 16))
    out = torch.empty((3, 16), dtype=torch.int32)
    before = probe.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        probe.probe_ranks_into(out, h, f, q, NB=8, B=8)
    assert probe.LAUNCHES == before
