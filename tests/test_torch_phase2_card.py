"""Phase 2's CUDA kernel (csrc/phase2.cu) against its plain version, on a
card: through both callers, gpu._phase2_fixed_point and
rankfed._phase2_fixed_point, on the cases of tests/test_torch_phase2.py
(the same numpy-made operands, moved to the card), the conflict vector
and gpu.py's round count bit for bit, and the kernel's launch counted
(gpu.py's one call, geometry and seed included, is one launch). Then
each case's operands through each tier (block and grid, forced), with
and without the seed (gpu.py's in the geometry form, the rank-fed set's
with its host's perm, lo and hi); the geometry form against the operand
form at edge shapes (P2 not a power of two, under one bit word, over a
grid block's words); an abort chain of 65,536 txns, whose 65,536 rounds
spend the trees' tags twice over, on both tiers; the shared-memory and
scratch formulas of the tier rule against the kernel's; and a forced
tier that does not fit.
The kernel has no CPU mode: without a card every case skips. Run on a
machine with a card:

    python -m pytest tests/test_torch_phase2_card.py -m cuda -q

This file imports no JAX (the JAX differential is
tests/test_torch_phase2.py, on the CPU).
"""

import numpy as np
import pytest
import torch

from _torch_phase2_cases import (
    before_every_write_raw,
    chain_operands,
    chain_raw,
    gpu_operands,
    gpu_synthetic,
    random_raw,
    rank_operands,
    readonly_raw,
    undershoot_raw,
)
from foundationdb_tpu_torch.resolver import gpu, phase2
from foundationdb_tpu_torch.resolver import rankfed as prf


def gpu_case(name):
    rng = np.random.default_rng(len(name))
    if name == "one_txn":
        arrays, statics = gpu_synthetic(rng, T=1, R=3, Wr=2)
        return arrays, statics, np.ones(1, np.int32)
    raw, caps = {
        "random": (random_raw(rng, 14), (64, 64, 16)),
        "chain15": (chain_raw(15), (16, 16, 16)),
        "chain16": (chain_raw(16), (16, 16, 16)),
        "undershoot": (undershoot_raw(), (16, 16, 16)),
        "no_writes": (readonly_raw(rng, 9), (16, 16, 16)),
    }[name]
    arrays, statics = gpu_operands(raw, caps=caps)
    base = (rng.random(statics["T"]) < 0.15).astype(np.int32)
    if name == "undershoot":
        base[:] = 0
        base[0] = 1
    return arrays, statics, base


def rank_case(name):
    rng = np.random.default_rng(len(name))
    return {
        "random": lambda: rank_operands(random_raw(rng, 14),
                                        [random_raw(rng, 6)]),
        "chain15": lambda: rank_operands(chain_raw(15)),
        "chain16": lambda: rank_operands(chain_raw(16)),
        "no_writes": lambda: rank_operands(readonly_raw(rng, 5)),
        "one_txn": lambda: rank_operands(
            [(999, [(b"a", b"b")], [(b"c", b"d")])], bucket_min=1),
        "before_every_write": lambda: rank_operands(before_every_write_raw()),
    }[name]()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the phase-2 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "gpu:random", "gpu:chain15", "gpu:chain16", "gpu:undershoot",
    "gpu:no_writes", "gpu:one_txn", "rankfed:random", "rankfed:chain15",
    "rankfed:chain16", "rankfed:no_writes", "rankfed:one_txn",
    "rankfed:before_every_write",
])
def test_kernel_equals_plain_version(card, case):
    caller, name = case.split(":")
    n0 = phase2.LAUNCHES
    if caller == "gpu":
        arrays, statics, base = gpu_case(name)
        base = torch.from_numpy(base)
        want = gpu._phase2_fixed_point(base, smat=None, **arrays, **statics)
        got = gpu._phase2_fixed_point(
            base.to(card), smat=None,
            **{k: v.to(card) for k, v in arrays.items()}, **statics)
    else:
        _, _, lay, base, kw = rank_case(name)
        want = (prf._phase2_fixed_point(base, **kw, T=lay.T, M=lay.M),)
        got = (prf._phase2_fixed_point(
            base.to(card), **{k: v.to(card) for k, v in kw.items()},
            T=lay.T, M=lay.M),)
    torch.cuda.synchronize()
    assert phase2.LAUNCHES == n0 + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.int32
        assert torch.equal(g.cpu(), w)


CASES = ["gpu:random", "gpu:chain15", "gpu:chain16", "gpu:undershoot",
         "gpu:no_writes", "gpu:one_txn", "rankfed:random", "rankfed:chain15",
         "rankfed:chain16", "rankfed:no_writes", "rankfed:one_txn",
         "rankfed:before_every_write"]


def captured(card, case):
    """The operands the caller hands phase2.phase2_rounds on the card."""
    caller, name = case.split(":")
    got = {}
    real = phase2.phase2_rounds

    def tap(base_conf, conflict0, it0, cap, **kw):
        got.update(kw, base_conf=base_conf, conflict0=conflict0, it0=it0,
                   cap=cap)
        got.pop("groups", None)
        return real(base_conf, conflict0, it0, cap, **kw)

    phase2.phase2_rounds = tap
    try:
        if caller == "gpu":
            arrays, statics, base = gpu_case(name)
            gpu._phase2_fixed_point(
                torch.from_numpy(base).to(card), smat=None,
                **{k: v.to(card) for k, v in arrays.items()}, **statics)
        else:
            _, _, lay, base, kw = rank_case(name)
            prf._phase2_fixed_point(
                base.to(card), **{k: v.to(card) for k, v in kw.items()},
                T=lay.T, M=lay.M)
    finally:
        phase2.phase2_rounds = real
    return got


def launch_vs_plain(op, tier):
    args = [op.pop(k) for k in ("base_conf", "conflict0", "it0", "cap")]
    n0 = phase2.LAUNCHES
    got = phase2.phase2_rounds_launch(*args, tier=tier, **op)
    torch.cuda.synchronize()
    assert phase2.LAUNCHES == n0 + 1
    want = phase2.phase2_rounds_ref(*[a.cpu() if torch.is_tensor(a) else a
                                      for a in args],
                                    **{k: v.cpu() if torch.is_tensor(v)
                                       else v for k, v in op.items()})[:2]
    return [g.cpu() for g in got], want


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("tier", ["block", "grid"])
@pytest.mark.parametrize("case", CASES)
def test_each_tier_equals_plain_version(card, case, tier, seed):
    """Each case's operands through one tier, forced, from the seed
    (it0 n_jump, cap n_jump + T + 2) or without it (it0 0, cap T + 2, the
    loop from base_conf): conflict vector and counter bit for bit."""
    op = captured(card, case)
    T = op["base_conf"].shape[0]
    j = phase2.n_jump(T) if seed else 0
    op.update(seed=seed, conflict0=op["base_conf"], it0=j, cap=j + T + 2)
    got, want = launch_vs_plain(op, tier)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("tier,T", [("grid", 65536), ("block", 3072)])
def test_long_chain_refills_the_trees(card, tier, T, seed):
    """An abort chain of T txns: without the seed T rounds, with it one.
    On the grid 65,536 rounds outrun one fill's 32,767 tags twice, so the
    trees are filled again mid-loop; the block tier runs the longest
    chain its shared memory holds (72 T + 16 bytes). Statuses
    alternate."""
    kw = {k: v.to(card) if torch.is_tensor(v) else v
          for k, v in chain_operands(T).items()}
    base = torch.zeros(T, dtype=torch.int32, device=card)
    j = phase2.n_jump(T) if seed else 0
    c, it = phase2.phase2_rounds_launch(base, base, j, j + T + 2, seed=seed,
                                        tier=tier, **kw)
    want = torch.arange(T, dtype=torch.int32) % 2
    assert torch.equal(c.cpu(), want)
    assert int(it) == (j + 1 if seed else T)


@pytest.mark.cuda
def test_block_bytes_formula_is_the_kernels(card):
    lib = phase2._lib()
    for T, R, Wr, L in [(1, 0, 0, 1), (16, 80, 16, 64),
                        (8192, 40960, 16384, 114688),
                        (65536, 90112, 36864, 262144), (1000, 7, 3, 7777)]:
        for geo in (False, True):
            assert lib.fdb_phase2_block_bytes(T, R, Wr, L, int(geo)) == (
                phase2.block_bytes(T, R, Wr, L, geo))
        # the grid's scratch: the geometry adds perm, lo, hi, the words
        # and their prefix
        assert (lib.fdb_phase2_scratch_ints(T, R, Wr, L, 5, 1)
                - lib.fdb_phase2_scratch_ints(T, R, Wr, L, 5, 0)) == (
            Wr + 2 * R + 2 * phase2.geo_words(L))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [True, False])
@pytest.mark.parametrize("tier", ["block", "grid"])
@pytest.mark.parametrize("T,R,Wr", [(4, 3, 2), (5, 7, 9), (64, 100, 60),
                                    (300, 2500, 1700)])
def test_geometry_form_at_edge_shapes(card, T, R, Wr, tier, seed):
    """Synthetic operands (P2 = 2 (R + Wr): 10, 32, 320 and 8,400 slots,
    none a power of two but 32, the last over one 256-thread block's
    words): the geometry form on the card equals the plain version, and
    the operand form given geometry_ref's perm, lo and hi."""
    arrays, statics = gpu_synthetic(np.random.default_rng(T + R), T=T, R=R,
                                    Wr=Wr)
    P2 = statics["P2"]
    base = torch.from_numpy(
        (np.random.default_rng(R).random(T) < 0.2).astype(np.int32))
    common = dict(seg_lo=arrays["s_begin"], seg_hi=arrays["s_end"],
                  n_leaves=P2, leaf=arrays["q_begin"], rtxn=arrays["rtxn"],
                  wtxn=arrays["wtxn"], w_valid=arrays["w_valid"])
    j = phase2.n_jump(T) if seed else 0
    geo = dict(common, q_end=arrays["q_end"], base_conf=base,
               conflict0=base, it0=j, cap=j + T + 2, seed=seed)
    perm, lo, hi = phase2.geometry_ref(arrays["s_begin"], arrays["q_begin"],
                                       arrays["q_end"], P2)
    ops = dict(common, perm=perm, lo=lo, hi=hi, base_conf=base,
               conflict0=base, it0=j, cap=j + T + 2, seed=seed)
    outs = []
    for op in (geo, ops):
        op = {k: v.to(card) if torch.is_tensor(v) else v
              for k, v in op.items()}
        got, want = launch_vs_plain(op, tier)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        outs.append(got)
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.cuda
def test_forced_block_tier_that_does_not_fit_raises(card):
    """n_leaves 2^22 puts 32 MB of interval tree in the state: no block
    holds it, so a forced block tier raises before any launch and the
    rule's own choice is the grid."""
    kw = {k: v.to(card) if torch.is_tensor(v) else v
          for k, v in chain_operands(16).items()}
    kw["n_leaves"] = 1 << 22
    base = torch.zeros(16, dtype=torch.int32, device=card)
    lim = phase2.device_limits(card)
    assert phase2.choose_tier(16, 16, 16, 1 << 22, lim)[0] == "grid"
    n0 = phase2.LAUNCHES
    with pytest.raises(ValueError, match="block tier"):
        phase2.phase2_rounds_launch(base, base, 0, 18, tier="block", **kw)
    assert phase2.LAUNCHES == n0
    c, it = phase2.phase2_rounds_launch(base, base, 0, 18, **kw)
    assert c.cpu().tolist() == [i % 2 for i in range(16)] and int(it) == 16


@pytest.mark.cuda
def test_gpu_phase2_is_one_kernel_and_its_geometry(card):
    """On the card gpu._phase2_fixed_point's device work is one phase-2
    kernel: the geometry and the seed launch nothing of their own."""
    from torch.profiler import ProfilerActivity, profile

    arrays, statics, base = gpu_case("random")
    args = {k: v.to(card) for k, v in arrays.items()}
    base = torch.from_numpy(base).to(card)
    gpu._phase2_fixed_point(base, smat=None, **args, **statics)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gpu._phase2_fixed_point(base, smat=None, **args, **statics)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [k for k in kernels if "grid_kernel" in k or "block_kernel" in k]
    assert len(ours) == 1, kernels
    assert len(kernels) == 1, kernels
