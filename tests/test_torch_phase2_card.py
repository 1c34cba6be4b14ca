"""Phase 2's CUDA kernel (csrc/phase2.cu) against its plain version, on a
card: through both callers, gpu._phase2_fixed_point and
rankfed._phase2_fixed_point, on the cases of tests/test_torch_phase2.py
(the same numpy-made operands, moved to the card), the conflict vector
and gpu.py's round count bit for bit, and the kernel's launch counted.
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
