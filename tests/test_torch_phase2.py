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
whose rank-fed qb2 is 0. gpu.py's one call runs the seed too (seed=True):
abort chains of T = 1, 2^k and 2^k + 1 txns (the edges of its n_jump
doublings) hold it to the JAX package's seed and loop. The tier rule
(phase2.choose_tier) is checked as the pure function it is. A static
test holds the kernel's C entry points to the wrapper's ctypes
argtypes. The kernel itself runs only on a card:
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
    chain_operands,
    chain_raw,
    gpu_chain,
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


class SeedTap:
    """phase2.phase2_rounds while open, its calls' seed, it0 and cap kept."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = phase2.phase2_rounds

        def rounds(base_conf, conflict0, it0, cap, **kw):
            self.calls.append((kw.get("seed", False), it0, cap))
            return real(base_conf, conflict0, it0, cap, **kw)

        monkeypatch.setattr(phase2, "phase2_rounds", rounds)


@pytest.mark.parametrize("T", [1, 2, 4, 5, 8, 9, 16, 17, 32, 33])
def test_gpu_phase2_seeded_at_the_n_jump_edges(T, monkeypatch):
    """gpu.py's one phase-2 call asks for the seed, from it0 = n_jump with
    cap n_jump + T + 2; the plain version's seed and rounds equal the JAX
    package's on an abort chain of T txns (a base conflict mid-chain),
    which the seed resolves exactly: one verification round."""
    tap = SeedTap(monkeypatch)
    if T == 1:
        arrays, statics = gpu_synthetic(np.random.default_rng(5), T=1, R=3,
                                        Wr=2)
        base = np.zeros(1, np.int32)
    else:
        arrays, statics, base = gpu_chain(T, aborted=[T // 2] if T > 2
                                          else [])
    conflict, rounds, reads = gpu_check(arrays, statics, base)
    assert tap.calls == [(True, n_jump(T), n_jump(T) + T + 2)]
    assert rounds == n_jump(T) + 1 and reads == 1
    if T > 2:
        m = T // 2
        want = [i % 2 for i in range(m)] + [
            1 - (i - m) % 2 for i in range(m, T)]
        assert list(conflict) == want


def test_gpu_phase2_launches_only_the_geometry_around_its_call(monkeypatch):
    """gpu._phase2_fixed_point hands the geometry, the seed and the rounds
    to one phase2.phase2_rounds call in its geometry form (q_end; one
    kernel launch on the card): with that call stubbed, no op remains
    around it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops.append(func.name())
            return func(*args, **(kwargs or {}))

    arrays, statics = gpu_operands(random_raw(np.random.default_rng(0), 14),
                                   caps=RANDOM_CAPS)
    base = torch.zeros(statics["T"], dtype=torch.int32)
    calls = []
    monkeypatch.setattr(phase2, "phase2_rounds", lambda b, c0, it0, cap,
                        **kw: calls.append(kw) or (b, it0, 0))
    with Ops() as seen:
        gpu._phase2_fixed_point(base, smat=None, **arrays, **statics)
    assert [kw["seed"] for kw in calls] == [True]
    assert calls[0]["q_end"] is arrays["q_end"]
    assert not {"perm", "lo", "hi"} & set(calls[0])
    assert seen.ops == []


def test_seed_undershoots_and_the_rounds_repair_it():
    """On the undershoot batch the seed (phase2.seed_ref, the plain
    version's seed stage) is wrong at txns 2 and 3: the verification
    rounds, 3 of them, repair it to the JAX package's fixed point."""
    arrays, statics = gpu_operands(undershoot_raw(), caps=SMALL_CAPS)
    base = np.zeros(statics["T"], np.int32)
    base[0] = 1
    captured = {}
    real = phase2.phase2_rounds

    def tap(base_conf, conflict0, it0, cap, **kw):
        captured.update(kw, base_conf=base_conf)
        return real(base_conf, conflict0, it0, cap, **kw)

    phase2.phase2_rounds = tap
    try:
        conflict, rounds, _ = gpu_check(arrays, statics, base)
    finally:
        phase2.phase2_rounds = real
    assert "perm" not in captured   # gpu.py asks for the geometry form
    perm, lo, hi = phase2.geometry_ref(captured["seg_lo"], captured["leaf"],
                                       captured["q_end"],
                                       captured["n_leaves"])
    geom = dict(perm=perm, lo=lo, hi=hi,
                **{k: captured[k] for k in ("seg_lo", "seg_hi", "n_leaves",
                                            "leaf")})
    seed = phase2.seed_ref(
        captured["base_conf"], phase2.min_writer_fn(**geom),
        rtxn=captured["rtxn"], wtxn=captured["wtxn"],
        w_valid=captured["w_valid"]).numpy()
    assert list(conflict[:4]) == [1, 0, 1, 0]
    assert list(seed[:4]) != list(conflict[:4])
    assert rounds == n_jump(statics["T"]) + 3


@pytest.mark.parametrize("T", [16, 17])
def test_plain_version_chain_one_link_a_round(T):
    """Without the seed the plain version settles an abort chain one link
    a round (T rounds); with it, in one round, to the same vector."""
    kw = chain_operands(T)
    base = torch.zeros(T, dtype=torch.int32)
    c, it, _ = phase2.phase2_rounds(base, base, 0, T + 2, **kw)
    assert c.tolist() == [i % 2 for i in range(T)] and int(it) == T
    j = n_jump(T)
    c2, it2, reads = phase2.phase2_rounds(base, base, j, j + T + 2,
                                          seed=True, **kw)
    assert torch.equal(c, c2) and int(it2) == j + 1 and reads == 1


# ------------------------------------------------ the geometry


def jax_geometry(s_begin, q_begin, q_end, P2: int, Wr: int):
    """tpu.py:358-365's five lines, run by JAX on the CPU."""
    is_wb = jnp.zeros(P2, dtype=jnp.int32).at[s_begin].set(1)
    wb_excl = jnp.cumsum(is_wb) - is_wb
    lh = wb_excl[jnp.stack([q_begin, q_end])]
    rank_w = wb_excl[s_begin]
    perm = jnp.zeros(Wr, dtype=jnp.int32).at[rank_w].set(
        jnp.arange(Wr, dtype=jnp.int32))
    return perm, lh[0], lh[1]


GEOMETRY_CASES = [("random", s, RANDOM_CAPS) for s in range(4)] + [
    ("chain", 16, SMALL_CAPS), ("undershoot", 0, SMALL_CAPS),
    ("readonly", 7, SMALL_CAPS)]


def geometry_case(kind, seed, caps):
    raw = {"random": lambda: random_raw(np.random.default_rng(seed), 14),
           "chain": lambda: chain_raw(seed),
           "undershoot": undershoot_raw,
           "readonly": lambda: readonly_raw(np.random.default_rng(seed), 9),
           }[kind]()
    return gpu_operands(raw, caps=caps)


@pytest.mark.parametrize("kind,seed,caps", GEOMETRY_CASES)
def test_packed_write_begins_are_distinct_slots(kind, seed, caps):
    """The geometry's inverse permutation is a scatter-set, deterministic
    only because every write row, pads included, owns a distinct begin
    slot among the P2 endpoint slots (packing.py): so the write ranks are
    a permutation of 0..Wr-1."""
    arrays, statics = geometry_case(kind, seed, caps)
    sb = arrays["s_begin"].numpy()
    assert sb.shape == (statics["Wr"],)
    assert len(np.unique(sb)) == statics["Wr"]
    assert sb.min() >= 0 and sb.max() < statics["P2"]
    perm, _, _ = phase2.geometry_ref(arrays["s_begin"], arrays["q_begin"],
                                     arrays["q_end"], statics["P2"])
    assert sorted(perm.tolist()) == list(range(statics["Wr"]))


@pytest.mark.parametrize("kind,seed,caps", GEOMETRY_CASES)
def test_geometry_ref_matches_jax(kind, seed, caps):
    """phase2.geometry_ref (the plain version of the kernel's prologue)
    equals tpu.py's five lines on packed batches, pads included."""
    arrays, statics = geometry_case(kind, seed, caps)
    got = phase2.geometry_ref(arrays["s_begin"], arrays["q_begin"],
                              arrays["q_end"], statics["P2"])
    want = jax_geometry(*(jnp.asarray(arrays[k].numpy()) for k in (
        "s_begin", "q_begin", "q_end")), statics["P2"], statics["Wr"])
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_geometry_form_equals_the_operand_form(seed):
    """phase2_rounds given q_end (the geometry form gpu.py calls) returns
    what it returns given geometry_ref's perm, lo and hi, seeded or not."""
    arrays, statics = gpu_operands(random_raw(np.random.default_rng(seed),
                                              14), caps=RANDOM_CAPS)
    T, P2 = statics["T"], statics["P2"]
    base = torch.from_numpy(
        (np.random.default_rng(seed).random(T) < 0.15).astype(np.int32))
    perm, lo, hi = phase2.geometry_ref(arrays["s_begin"], arrays["q_begin"],
                                       arrays["q_end"], P2)
    common = dict(seg_lo=arrays["s_begin"], seg_hi=arrays["s_end"],
                  n_leaves=P2, leaf=arrays["q_begin"], rtxn=arrays["rtxn"],
                  wtxn=arrays["wtxn"], w_valid=arrays["w_valid"])
    for seeded in (False, True):
        it0 = n_jump(T) if seeded else 0
        a = phase2.phase2_rounds(base, base, it0, it0 + T + 2, seed=seeded,
                                 q_end=arrays["q_end"], **common)
        b = phase2.phase2_rounds(base, base, it0, it0 + T + 2, seed=seeded,
                                 perm=perm, lo=lo, hi=hi, **common)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


def test_geometry_form_takes_q_end_or_the_operands_not_both():
    arrays, statics = gpu_synthetic(np.random.default_rng(1), T=4, R=3, Wr=2)
    T, P2 = statics["T"], statics["P2"]
    base = torch.zeros(T, dtype=torch.int32)
    kw = dict(seg_lo=arrays["s_begin"], seg_hi=arrays["s_end"], n_leaves=P2,
              leaf=arrays["q_begin"], rtxn=arrays["rtxn"],
              wtxn=arrays["wtxn"], w_valid=arrays["w_valid"])
    perm = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="q_end"):
        phase2.phase2_rounds(base, base, 0, T + 2, perm=perm,
                             q_end=arrays["q_end"], **kw)
    with pytest.raises(ValueError, match="q_end"):
        phase2.phase2_rounds(base, base, 0, T + 2, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        phase2.phase2_rounds_launch(base, base, 0, T + 2,
                                    q_end=arrays["q_end"], **kw)
    conflict, _, _ = phase2.phase2_rounds(base, base, 0, T + 2,
                                          q_end=arrays["q_end"], **kw)
    assert conflict.shape == (T,)


# ------------------------------------------------ the tier rule

H100 = dict(sms=132, smem_per_block=232_448, grid_blocks_per_sm=8)
FULL = (8192, 40960, 16384, 114688)        # [full]'s chunk: T, R, Wr, L
SHARDED = (65536, 90112, 36864, 262144)    # [sharded]'s shard step
RANKFED = (65536, 524288, 131072, 262144)  # [rankfed]'s batch


def test_tier_rule_puts_each_path_where_it_ran_faster():
    """One block holding the state and copies of the operands (4 bytes
    each of 4 T + 6 Wr + 2 L + 4 R and 4 words) runs the block tier where
    each of its 1,024 threads takes at most four items (config 1's
    largest batch on the card: T 832, R 4,096, Wr 1,664, 12,288 leaves);
    anything larger the grid, sized to the work: a batch one block holds
    with 4,608 reads, 1,024 config-5 txns (one block does not hold them),
    [full]'s chunk, [sharded]'s step, [rankfed]'s batch. Forced, the
    block tier runs wherever it fits."""
    edge = (832, 4096, 1664, 12288)
    smem = phase2.block_bytes(*edge)
    assert smem == 4 * (4 * 832 + 6 * 1664 + 2 * 12288 + 4 * 4096 + 4)
    assert smem <= H100["smem_per_block"]
    assert phase2.choose_tier(*edge, H100) == ("block", 1, smem)
    assert phase2.choose_tier(256, 1280, 512, 3584, H100)[:2] == ("block", 1)
    assert phase2.choose_tier(16, 80, 32, 224, H100)[:2] == ("block", 1)
    held = (512, 4608, 512, 2048)
    assert phase2.block_bytes(*held) <= H100["smem_per_block"]
    assert phase2.choose_tier(*held, H100) == ("grid", 18, 0)
    assert phase2.choose_tier(*held, H100, "block") == (
        "block", 1, phase2.block_bytes(*held))
    big = (1024, 5120, 2048, 14336)
    assert phase2.block_bytes(*big) > H100["smem_per_block"]
    assert phase2.choose_tier(*big, H100) == ("grid", 20, 0)
    assert phase2.choose_tier(*FULL, H100) == ("grid", 160, 0)
    assert phase2.choose_tier(*SHARDED, H100) == ("grid", 352, 0)
    assert phase2.choose_tier(*RANKFED, H100) == ("grid", 132 * 8, 0)
    assert phase2.choose_tier(1, 0, 0, 1, H100, "grid") == ("grid", 1, 0)


def test_tier_rule_counts_the_geometry_words():
    """In the geometry form the block tier also holds the P2 / 32 bit
    words, their prefix and 32 scan words; the rule counts them, so a
    shape that fits only without them goes to the grid."""
    edge = (832, 4096, 1664, 12288)
    smem = phase2.block_bytes(*edge, geo=True)
    assert smem == phase2.block_bytes(*edge) + 4 * (2 * 12288 // 32 + 32)
    assert phase2.choose_tier(*edge, H100, geo=True) == ("block", 1, smem)
    lim = dict(H100, smem_per_block=phase2.block_bytes(*edge))
    assert phase2.choose_tier(*edge, lim)[0] == "block"
    assert phase2.choose_tier(*edge, lim, geo=True)[0] == "grid"
    with pytest.raises(ValueError, match="block tier"):
        phase2.choose_tier(*edge, lim, "block", geo=True)
    assert phase2.geo_words(1) == 1 and phase2.geo_words(33) == 2
    assert phase2.choose_tier(*FULL, H100, geo=True) == ("grid", 160, 0)
    assert phase2.choose_tier(*SHARDED, H100, geo=True) == ("grid", 352, 0)


@pytest.mark.parametrize("shape,tier", [(FULL, "block"), (RANKFED, "block"),
                                        (SHARDED, "bogus")])
def test_forced_tier_that_does_not_fit_raises(shape, tier):
    with pytest.raises(ValueError, match="block|bogus") as e:
        phase2.choose_tier(*shape, H100, tier)
    if tier == "block":
        T, R, Wr, L = shape
        assert f"T={T} R={R} Wr={Wr} n_leaves={L}" in str(e.value)


def test_tier_rule_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="T="):
        phase2.choose_tier(phase2.MAX_T, 1, 1, 1, H100)
    with pytest.raises(ValueError, match="T="):
        phase2.choose_tier(0, 1, 1, 1, H100, "grid")


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
    assert (kw["leaf"][:n_reads] == -1).any()   # qb2 0: no stab
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
    assert len(phase2.ENTRY_POINTS["fdb_phase2_rounds"][1]) == 27


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
