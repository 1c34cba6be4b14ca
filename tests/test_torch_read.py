"""The storage read gather (storage_engine/read.py) against the JAX
package, on the CPU.

On CPU tensors `read.read_gather` runs its plain version,
`read_gather_ref`; behind the probe (resolver/probe.probe_ranks, its
plain version here) it is `gpu_engine._read_kernel_impl`, held bit for
bit against `tpu_engine._read_kernel_impl` run by JAX on the same
operands, taken from a KeyValueStoreTPU's own state: the case grid of
tests/test_torch_storage_engine.py's test_read_kernel_matches_jax, an
empty delta, points whose keys sort before every stored key, ranges whose
spans fill S, and key widths of 1 to 16 words (W2 3 to 18 rows). The
wrapper's checks, its CPU dispatch and that a CUDA tensor never reaches
the plain version are held here too; the CUDA kernel itself runs only on
a card: tests/test_torch_read_card.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_read_cases import GRID, read_operands
from foundationdb_tpu.storage_engine import tpu_engine
from foundationdb_tpu.storage_engine.tpu_engine import KeyValueStoreTPU
from foundationdb_tpu_torch import _build
from foundationdb_tpu_torch.resolver import probe
from foundationdb_tpu_torch.storage_engine import gpu_engine, read


def check(P, R, S, *, seed, n_words=2, n_keys=120, n_delta=5, **kw):
    """The port's dispatch (probe + read_gather_ref) against JAX's on one
    engine's operands: the aux vector bit for bit. Returns it."""
    arrs, q, rv, meta, _ = read_operands(KeyValueStoreTPU, seed, n_words,
                                         n_keys, n_delta, P, R, **kw)
    t = [torch.from_numpy(a) for a in arrs]
    hmat, slots, nextsame, fences, dmat, dslots, dnext = t
    qall, rvt = torch.from_numpy(q), torch.from_numpy(rv)
    n0 = dict(read.LAUNCHES)
    bid, pos, _ = probe.probe_ranks(hmat, fences, qall, NB=meta["NB"],
                                    B=meta["B"])
    got = read.read_gather(hmat, slots, nextsame, dmat, dslots, dnext, qall,
                           rvt, bid, pos, P=P, R=R, S=S, **meta)
    assert read.LAUNCHES == n0  # CPU tensors: the plain version
    assert got.dtype == torch.int32 and got.shape == (
        read.aux_len(P, R, S),)
    whole = gpu_engine._read_kernel_impl(*t, qall, rvt, P=P, R=R, S=S,
                                         **meta)
    assert torch.equal(whole, got)
    want = np.asarray(tpu_engine._read_kernel_impl(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(q), jnp.asarray(rv),
        P=P, R=R, S=S, probe="xla", **meta))
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


@pytest.mark.parametrize("P,R,S,n_delta", GRID)
def test_read_gather_matches_jax_on_the_grid(P, R, S, n_delta):
    check(P, R, S, seed=P * 7 + R, n_delta=n_delta)


@pytest.mark.parametrize("P,R", [(8, 4), (16, 0)])
def test_read_gather_matches_jax_on_an_empty_delta(P, R):
    """No write since the compaction: the delta is all +inf pads, so every
    delta rank is 0 and nothing in the delta is found or visible."""
    aux = check(P, R, 16, seed=3 + P, n_delta=0)
    assert not aux[3 * P:4 * P].any()                 # pt_dfound
    off = 6 * P + 4 * R + 3 * R * 16
    assert not aux[off:off + R * 16].any()            # dvis


@pytest.mark.parametrize("n_delta", [0, 9])
def test_read_gather_matches_jax_before_the_first_key(n_delta):
    """A quarter of the points sort before every stored key: their base
    rank is 0, their predecessor clamps to column 0 and is not found."""
    check(16, 4, 8, seed=11, n_delta=n_delta, before_first=True)


@pytest.mark.parametrize("S,n_delta", [(8, 12), (16, 30)])
def test_read_gather_matches_jax_on_spans_that_fill_s(S, n_delta):
    """Every range runs from the first stored key to the +inf pad: its
    base span (and, with 30 delta entries, its delta span) is wider than
    S, so all S slots are gathered and the host falls back."""
    aux = check(8, 4, S, seed=5, n_delta=n_delta, fill_spans=True)
    rb, re = aux[48:52], aux[52:56]
    assert ((re - rb) > S).all()


@pytest.mark.parametrize("n_words", [1, 2, 4, 8, 16])
def test_read_gather_matches_jax_at_every_key_width(n_words):
    """Key widths of 1 to 16 words: W2 = n_words + 2 rows from 3 to 18
    (the simulator's backup windows reach 17), the generic word loop."""
    check(8, 4, 16, seed=20 + n_words, n_words=n_words, n_keys=60,
          n_delta=7)


def test_read_gather_checks_its_operands():
    arrs, q, rv, meta, _ = read_operands(KeyValueStoreTPU, 1, 2, 40, 3, 8, 2)
    t = [torch.from_numpy(a) for a in arrs]
    hmat, slots, nextsame, fences, dmat, dslots, dnext = t
    qall, rvt = torch.from_numpy(q), torch.from_numpy(rv)
    bid, pos, _ = probe.probe_ranks(hmat, fences, qall, NB=meta["NB"],
                                    B=meta["B"])
    args = [hmat, slots, nextsame, dmat, dslots, dnext, qall, rvt, bid, pos]
    kw = dict(P=8, R=2, S=8, **meta)
    with pytest.raises(TypeError):
        read.read_gather(*args[:7], rvt.long(), *args[8:], **kw)
    with pytest.raises(ValueError):
        read.read_gather(*args, **dict(kw, R=3))
    with pytest.raises(ValueError):
        read.read_gather(*args[:8], bid[:-1], pos, **kw)
    with pytest.raises(ValueError, match="power-of-two"):
        read.read_gather(hmat, slots, nextsame, dmat[:, :6].contiguous(),
                         dslots[:6], dnext[:6], *args[6:], **kw)
    with pytest.raises(ValueError, match="CUDA"):
        read.read_gather_launch(dict(zip(read.OPERANDS, args)), **kw)


def test_read_entry_point_matches_the_wrapper():
    """csrc/read.cu's C entry points take exactly the argtypes the
    wrapper gives ctypes; _build.SOURCES builds that source."""
    from test_torch_phase2 import c_signature

    src = (Path(read.__file__).parents[1] / "csrc" / "read.cu").read_text()
    assert _build.SOURCES["read"].read_text() == src
    assert set(re.findall(r'extern "C" [\w *]+?\b(fdb_\w+)\(', src)) == set(
        read.ENTRY_POINTS)
    for name, (restype, argtypes) in read.ENTRY_POINTS.items():
        if name == "fdb_read_gather":
            got = c_signature(src.replace("void* const* ptrs",
                                          "void* ptrs"), name)
            assert got[1][1:] == argtypes[1:] and got[0] == restype
        else:
            assert c_signature(src, name) == (restype, argtypes), name
