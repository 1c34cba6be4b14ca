"""Phase 2's verification loop (resolver/phase2.py) against the JAX package.

On CPU tensors `phase2.phase2_rounds` runs its plain version,
`phase2_rounds_ref`; here it is reached through both of its callers and
held exactly equal, on the same numpy-made inputs, to `jax.jit` of the
JAX functions whose `lax.while_loop` the kernel replaces:

- gpu._phase2_fixed_point against tpu._phase2_fixed_point: the conflict
  vector and the round count;
- rankfed._phase2_fixed_point against rankfed._rank_kernel_impl: its
  statuses carry the conflict vector (TOO_OLD only where phase 1 already
  conflicts), so `where(too_old, 2, conflict)` must equal them.

The cases: random batches whose reads have several potential writers, a
pure abort chain of 15 and of 16 txns in T = 16 (crossing the plain
version's round groups; without a seed the rank-fed loop runs 16 to its
T + 2 cap), a batch on which gpu.py's pointer-jumping seed undershoots
(3 verification rounds), a batch with no valid write, T = 1, and a read
whose rank-fed qb2 is 0. A static test holds the kernel's C entry point
to the wrapper's ctypes argtypes. The kernel itself runs only on a card:
tests/test_torch_phase2_card.py.
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

from _torch_phase2_cases import (
    before_every_write_raw,
    chain_raw,
    gpu_operands,
    gpu_synthetic,
    random_raw,
    rank_operands,
    readonly_raw,
    undershoot_raw,
)
from foundationdb_tpu.resolver import rankfed as jrf
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.resolver import gpu, phase2
from foundationdb_tpu_torch.resolver import rankfed as prf

GPU_ARGS = ("q_begin", "q_end", "s_begin", "s_end", "rtxn", "wtxn",
            "w_valid")
RANDOM_CAPS = (64, 64, 16)   # one layout for every random gpu case
SMALL_CAPS = (16, 16, 16)    # T = 16 for the chains and the small cases


@functools.lru_cache(maxsize=None)
def jax_gpu_phase2(T, Wr, P2):
    def fn(base, *arrs):
        return jtpu._phase2_fixed_point(
            base, smat=None, **dict(zip(GPU_ARGS, arrs)), T=T, Wr=Wr, P2=P2)
    return jax.jit(fn)


def gpu_check(arrays, statics, base):
    """The port's phase 2 (plain version) against the JAX one: conflict
    vector and round count exactly; returns (conflict, rounds, reads)."""
    base = np.asarray(base, dtype=np.int32)
    want = jax_gpu_phase2(**statics)(
        jnp.asarray(base), *(jnp.asarray(arrays[k].numpy()) for k in GPU_ARGS))
    before, reads0 = phase2.LAUNCHES, gpu.P2_SYNCS
    got = gpu._phase2_fixed_point(torch.from_numpy(base), smat=None,
                                  **arrays, **statics)
    assert phase2.LAUNCHES == before  # CPU tensors: the plain version
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)
    return got[0].numpy(), int(got[1]), gpu.P2_SYNCS - reads0


def n_jump(T):
    return max((T - 1).bit_length(), 1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gpu_phase2_random_batches(seed):
    rng = np.random.default_rng(seed)
    arrays, statics = gpu_operands(random_raw(rng, 14), caps=RANDOM_CAPS)
    base = (rng.random(statics["T"]) < 0.15).astype(np.int32)
    conflict, rounds, reads = gpu_check(arrays, statics, base)
    assert rounds > n_jump(statics["T"]) and reads >= 1
    assert (conflict >= base).all() and (conflict > base).any()


@pytest.mark.parametrize("length,groups", [(15, 1), (16, 1)])
def test_gpu_phase2_abort_chain(length, groups):
    """The seed resolves a pure chain exactly: one verification round."""
    arrays, statics = gpu_operands(chain_raw(length), caps=SMALL_CAPS)
    assert statics["T"] == 16
    conflict, rounds, reads = gpu_check(arrays, statics,
                                        np.zeros(16, np.int32))
    assert list(conflict[:length]) == [i % 2 for i in range(length)]
    assert rounds == n_jump(16) + 1 and reads == groups


def test_gpu_phase2_seed_undershoots():
    arrays, statics = gpu_operands(undershoot_raw(), caps=SMALL_CAPS)
    base = np.zeros(statics["T"], np.int32)
    base[0] = 1
    conflict, rounds, reads = gpu_check(arrays, statics, base)
    assert list(conflict[:4]) == [1, 0, 1, 0]
    assert rounds == n_jump(statics["T"]) + 3 and reads == 2  # groups 1, 2


def test_gpu_phase2_no_valid_writes():
    rng = np.random.default_rng(7)
    arrays, statics = gpu_operands(readonly_raw(rng, 9), caps=SMALL_CAPS)
    assert not arrays["w_valid"].any()
    base = (rng.random(statics["T"]) < 0.3).astype(np.int32)
    conflict, rounds, _ = gpu_check(arrays, statics, base)
    np.testing.assert_array_equal(conflict, base)
    assert rounds == n_jump(statics["T"]) + 1


@pytest.mark.parametrize("base0", [0, 1])
def test_gpu_phase2_one_txn(base0):
    arrays, statics = gpu_synthetic(np.random.default_rng(3), T=1, R=3, Wr=2)
    conflict, rounds, _ = gpu_check(arrays, statics, [base0])
    assert list(conflict) == [base0] and rounds == n_jump(1) + 1


# ------------------------------------------------ the rank-fed set

@functools.lru_cache(maxsize=None)
def jax_rank_kernel(R, Wr, T, C):
    lay = jrf.RankLayout(R, Wr, T, C)
    return jax.jit(lambda hv, buf: jrf._rank_kernel_impl(hv, buf, lay=lay))


def rank_check(raw, history=(), bucket_min=8):
    """The port's rank-fed phase 2 (plain version) against the JAX
    kernel's statuses; returns (conflict, reads, operands, base_conf)."""
    buf, hv, lay, base, kw = rank_operands(raw, history, bucket_min)
    _, want = jax_rank_kernel(*lay.key())(jnp.asarray(hv), jnp.asarray(buf))
    before, reads0 = phase2.LAUNCHES, prf.P2_SYNCS
    got = prf._phase2_fixed_point(base, **kw, T=lay.T, M=lay.M)
    assert phase2.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (lay.T,)
    too_old = buf[lay.off_too_old:lay.off_too_old + lay.T]
    assert (got.numpy() >= too_old).all()
    np.testing.assert_array_equal(np.where(too_old != 0, 2, got.numpy()),
                                  np.asarray(want))
    return got.numpy(), prf.P2_SYNCS - reads0, kw, base


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rankfed_phase2_random_batches(seed):
    rng = np.random.default_rng(100 + seed)
    history = [random_raw(rng, 6) for _ in range(2)]
    conflict, reads, _, base = rank_check(random_raw(rng, 14), history)
    assert reads >= 1 and base.numpy().any()
    assert (conflict >= base.numpy()).all() and (conflict > base.numpy()).any()


@pytest.mark.parametrize("length,groups", [(15, 4), (16, 5)])
def test_rankfed_phase2_abort_chain(length, groups):
    """No seed: `length` rounds in T = 16, groups 1, 2, 4, 8 for 15; for
    16 the T + 2 cap cuts a fifth group from 8 rounds to 3."""
    conflict, reads, _, _ = rank_check(chain_raw(length))
    assert list(conflict[:length]) == [i % 2 for i in range(length)]
    assert reads == groups


def test_rankfed_phase2_no_valid_writes():
    rng = np.random.default_rng(8)
    conflict, reads, kw, base = rank_check(readonly_raw(rng, 5))
    assert not kw["w_valid"].any() and reads == 1
    np.testing.assert_array_equal(conflict, base.numpy())


def test_rankfed_phase2_one_txn():
    conflict, reads, kw, _ = rank_check(
        [(999, [(b"a", b"b")], [(b"c", b"d")])], bucket_min=1)
    assert conflict.shape == (1,) and kw["rtxn"].shape == (1,)
    assert list(conflict) == [0] and reads == 1


def test_rankfed_phase2_read_before_every_write():
    raw = before_every_write_raw()
    conflict, _, kw, _ = rank_check(raw)
    n_reads = sum(len(rr) for _, rr, _ in raw)
    assert (kw["qb2"][:n_reads] == 0).any()
    assert list(conflict[:3]) == [0, 1, 1]


# ------------------------------------------------ the kernel's interface

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "int*": ctypes.POINTER(ctypes.c_int),
           "long long": ctypes.c_longlong, "const char*": ctypes.c_char_p}


def c_signature(src: str, name: str):
    """(restype, argtypes) of one extern "C" function of a CUDA source."""
    m = re.search(r'extern "C" ([\w *]+?)\s*' + name + r"\((.*?)\)\s*\{",
                  src, re.S)
    assert m, name
    params = [" ".join(p.split()) for p in m.group(2).split(",")]
    return (C_TYPES[m.group(1).strip().replace(" *", "*")],
            [C_TYPES[re.sub(r"\s*\w+$", "", p).replace(" *", "*")]
             for p in params if p])


def test_kernel_entry_point_matches_the_wrapper():
    """csrc/phase2.cu's C entry points take exactly the argtypes the
    wrapper gives ctypes (a pointer passed as c_int would be cut to 32
    bits) and return its restypes; _build.SOURCES builds that source."""
    src = (Path(phase2.__file__).parents[1] / "csrc" / "phase2.cu"
           ).read_text()
    assert _build.SOURCES["phase2"].read_text() == src
    assert set(re.findall(r'extern "C" [\w *]+?\b(fdb_\w+)\(', src)) == set(
        phase2.ENTRY_POINTS)
    for name, (restype, argtypes) in phase2.ENTRY_POINTS.items():
        assert c_signature(src, name) == (restype, argtypes), name
    assert len(phase2.ENTRY_POINTS["fdb_phase2_rounds"][1]) == 22


def test_launch_takes_only_cuda_tensors():
    """phase2_rounds_launch is the kernel's launch: a CPU tensor raises
    (no plain fallback) and the count stays; bad operands raise before."""
    arrays, statics = gpu_synthetic(np.random.default_rng(1), T=4, R=3, Wr=2)
    T, P2 = statics["T"], statics["P2"]
    kw = dict(perm=torch.arange(2, dtype=torch.int32),
              lo=torch.zeros(3, dtype=torch.int32),
              hi=torch.ones(3, dtype=torch.int32), seg_lo=arrays["s_begin"],
              seg_hi=arrays["s_end"], n_leaves=P2, leaf=arrays["q_begin"],
              rtxn=arrays["rtxn"], wtxn=arrays["wtxn"],
              w_valid=arrays["w_valid"])
    base = torch.zeros(T, dtype=torch.int32)
    before = phase2.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        phase2.phase2_rounds_launch(base, base, 0, T + 2, **kw)
    with pytest.raises(TypeError):
        phase2.phase2_rounds(base.long(), base, 0, T + 2, **kw)
    with pytest.raises(ValueError):
        phase2.phase2_rounds(base, base[:2], 0, T + 2, **kw)
    strided = torch.zeros(6, dtype=torch.int32)[::2]
    with pytest.raises(ValueError):
        phase2.phase2_rounds(base, base, 0, T + 2, **dict(kw, lo=strided))
    with pytest.raises(ValueError):
        phase2.phase2_rounds(base, base, 5, 2, **kw)
    assert phase2.LAUNCHES == before
    conflict, rounds, reads = phase2.phase2_rounds(base, base, 0, T + 2, **kw)
    assert int(rounds) >= 1 and reads >= 1 and conflict.shape == (T,)
