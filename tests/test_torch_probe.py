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
