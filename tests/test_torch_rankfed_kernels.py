"""The rank-fed resolve's phases 1 and 3 (resolver/rankfed_ops.py)
against the JAX package, on the CPU.

On CPU tensors `rankfed_ops.phase1` and `phase3` run their plain
versions, held bit for bit, on operands packed by the port's
ConflictSetRankFed at C = 2^12 to 2^14 after seeded history batches:

- phase1_ref against tpu.py's `_build_table` and rankfed.py's
  `_table_range_query` run by JAX, with the reads' ranks set to phase
  1's edges (rank_b 0, empty ranges, the whole vector, a window at C)
  and as packed; its stab leaf and validity against rankfed.py:220's;
- phase3_ref, given the phase-2 vector, and the whole `_rank_kernel_impl`
  against `foundationdb_tpu/resolver/rankfed.py::_rank_kernel_impl`.

The wrappers' checks and that a CUDA tensor never reaches a plain
version are held here too; the CUDA kernels themselves run only on a
card: tests/test_torch_rankfed_card.py.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rankfed_cases import (
    edge_ranks,
    phase1_kw,
    phase2_conflict,
    phase3_kw,
    rank_case,
    slices,
)
from foundationdb_tpu.resolver import rankfed as jrf
from foundationdb_tpu.resolver import tpu as jtpu
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.resolver import rankfed as prf
from foundationdb_tpu_torch.resolver import rankfed_ops

CASES = [(1, 1 << 12), (2, 1 << 13), (3, 1 << 14)]


@functools.lru_cache(maxsize=None)
def jax_kernel(R, Wr, T, C):
    lay = jrf.RankLayout(R, Wr, T, C)
    return jax.jit(lambda hv, buf: jrf._rank_kernel_impl(hv, buf, lay=lay))


def jax_phase1(hv, s, T, M):
    """rankfed.py:210-215 and :220 in JAX: base_conf and the stab leaf."""
    j = {k: jnp.asarray(v.numpy()) for k, v in s.items()}
    vtab = jtpu._build_table(jnp.asarray(hv), jnp.maximum, 0)
    hist = jrf._table_range_query(vtab, j["rank_b"] - 1, j["rank_e"],
                                  jnp.maximum, 0)
    read_conf = (hist > j["rsnap"]).astype(jnp.int32)
    hist_conf = jnp.zeros(T, dtype=jnp.int32).at[j["rtxn"]].max(read_conf)
    base = jnp.maximum(hist_conf, (j["too_old"] != 0).astype(jnp.int32))
    leaf = jnp.where(j["qb2"] > 0, jnp.clip(j["qb2"] - 1, 0, M - 1), -1)
    return np.asarray(base), np.asarray(leaf)


@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("seed,C", CASES)
def test_phase1_ref_matches_jax(seed, C, edges):
    buf, hv, lay = rank_case(seed, C)
    assert lay.C == C
    if edges:
        buf = edge_ranks(buf, lay, seed)
    s = slices(buf, lay)
    if edges:
        rb, re = s["rank_b"].numpy(), s["rank_e"].numpy()
        assert (rb == 0).any() and (re <= rb - 1).any() and (re == C).any()
    n0 = dict(rankfed_ops.LAUNCHES)
    base, leaf, valid = rankfed_ops.phase1(torch.from_numpy(hv),
                                           **phase1_kw(s, lay.M))
    assert rankfed_ops.LAUNCHES == n0  # CPU tensors: the plain version
    assert base.dtype == torch.int32 and leaf.dtype == torch.int32
    want_base, want_leaf = jax_phase1(hv, s, lay.T, lay.M)
    np.testing.assert_array_equal(base.numpy(), want_base)
    np.testing.assert_array_equal(leaf.numpy(), want_leaf)
    np.testing.assert_array_equal(valid.numpy(), s["w_valid"].numpy() != 0)
    assert base.numpy().any()   # the history conflicts somewhere


@pytest.mark.parametrize("seed,C", CASES)
def test_phase3_ref_matches_jax(seed, C):
    """Given phase 2's vector, phase3_ref's new version vector and
    statuses equal the JAX kernel's."""
    buf, hv, lay = rank_case(seed, C)
    s = slices(buf, lay)
    base, leaf, valid = rankfed_ops.phase1(torch.from_numpy(hv),
                                           **phase1_kw(s, lay.M))
    conflict = phase2_conflict(base, s, leaf, valid, lay)
    hv_t = torch.from_numpy(hv)
    got_hv, got_st = rankfed_ops.phase3(hv_t, conflict, **phase3_kw(s))
    assert torch.equal(hv_t, torch.from_numpy(hv))   # hv is only read
    want_hv, want_st = jax_kernel(*lay.key())(jnp.asarray(hv),
                                              jnp.asarray(buf))
    np.testing.assert_array_equal(got_hv.numpy(), np.asarray(want_hv))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    st = got_st.numpy()[:lay.T]
    assert (st == 0).any() and (st == 1).any()


@pytest.mark.parametrize("seed,C", CASES)
def test_rank_kernel_matches_jax(seed, C):
    """The whole resolve, phases 1-3, on one packed buffer."""
    buf, hv, lay = rank_case(seed, C)
    got_hv, got_st = prf._rank_kernel_impl(torch.from_numpy(hv),
                                           torch.from_numpy(buf), lay=lay)
    want_hv, want_st = jax_kernel(*lay.key())(jnp.asarray(hv),
                                              jnp.asarray(buf))
    np.testing.assert_array_equal(got_hv.numpy(), np.asarray(want_hv))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))


def test_rank_kernel_makes_no_conversion_op(monkeypatch):
    """_rank_kernel_impl hands the fused buffer's views to phase 1, phase
    2 and phase 3 (one kernel launch each on the card): with the three
    stubbed, no op but views remains around them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops.append(func.name())
            return func(*args, **(kwargs or {}))

    buf, hv, lay = rank_case(1, 1 << 12)
    calls = []
    T, R, Wr = lay.T, lay.R, lay.Wr
    z = torch.zeros(max(T, R, Wr, lay.C), dtype=torch.int32)
    zb = torch.zeros(Wr, dtype=torch.bool)
    monkeypatch.setattr(rankfed_ops, "phase1", lambda hv, **kw: calls.append(
        "phase1") or (z[:T], z[:R], zb))
    monkeypatch.setattr(prf.phase2, "phase2_rounds", lambda *a, **kw: calls
                        .append("phase2") or (z[:T], z[0], 0))
    monkeypatch.setattr(rankfed_ops, "phase3", lambda hv, c, **kw: calls
                        .append("phase3") or (z[:lay.C], z[:T]))
    hv_t, buf_t = torch.from_numpy(hv), torch.from_numpy(buf)
    with Ops() as seen:
        prf._rank_kernel_impl(hv_t, buf_t, lay=lay)
    assert calls == ["phase1", "phase2", "phase3"]
    assert seen.ops == [], seen.ops


def test_wrappers_check_their_operands():
    buf, hv, lay = rank_case(1, 1 << 12)
    s = slices(buf, lay)
    hv_t = torch.from_numpy(hv)
    kw1 = phase1_kw(s, lay.M)
    with pytest.raises(TypeError):
        rankfed_ops.phase1(hv_t.long(), **kw1)
    with pytest.raises(ValueError):
        rankfed_ops.phase1(hv_t, **dict(kw1, rsnap=s["rsnap"][:-1]))
    with pytest.raises(ValueError, match="CUDA"):
        rankfed_ops.phase1_launch(dict(zip(rankfed_ops.PHASE1_OPERANDS, (
            hv_t, *(kw1[k] for k in rankfed_ops.PHASE1_OPERANDS[1:])))),
            M=lay.M)
    conflict = torch.zeros(lay.T, dtype=torch.int32)
    kw3 = phase3_kw(s)
    with pytest.raises(ValueError):
        rankfed_ops.phase3(hv_t, conflict, **dict(kw3, scalars=s["scalars"]
                                                  [:2]))
    with pytest.raises(ValueError):
        rankfed_ops.phase3(hv_t, conflict[:-1], **kw3)
    with pytest.raises(ValueError, match="CUDA"):
        rankfed_ops.phase3_launch(dict(zip(rankfed_ops.PHASE3_OPERANDS, (
            hv_t, conflict, *(kw3[k] for k in
                              rankfed_ops.PHASE3_OPERANDS[2:])))))


def test_rankfed_entry_points_match_the_wrapper():
    """csrc/rankfed.cu's C entry points take exactly the argtypes the
    wrapper gives ctypes; _build.SOURCES builds that source."""
    from test_torch_phase2 import C_TYPES, c_signature

    src = (Path(rankfed_ops.__file__).parents[1] / "csrc" / "rankfed.cu"
           ).read_text()
    assert _build.SOURCES["rankfed"].read_text() == src
    assert set(re.findall(r'extern "C" [\w *]+?\b(fdb_\w+)\(', src)) == set(
        rankfed_ops.ENTRY_POINTS)
    C_TYPES["void* const*"] = rankfed_ops._PTRS
    try:
        for name, want in rankfed_ops.ENTRY_POINTS.items():
            assert c_signature(src, name) == want, name
    finally:
        del C_TYPES["void* const*"]
