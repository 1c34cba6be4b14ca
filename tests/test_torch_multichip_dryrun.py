"""The port's root entry points, __graft_entry_torch__.py, against the
JAX package's __graft_entry__.py on the CPU.

- entry(device="cpu")'s fn(*args) equals jax.jit of the JAX entry()'s on
  the same tiny inputs, every output exactly;
- dryrun_multichip(8, device="cpu") passes (three sharded steps, each
  equal to the sharded oracle), and its statuses equal the JAX
  ShardedConflictSetTPU's on the conftest's 8-device virtual CPU mesh fed
  the JAX copy of the same transactions.

Every value is an integer, so the tolerance is exact.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as jg  # noqa: E402
import __graft_entry_torch__ as pg  # noqa: E402


def plain(txns):
    return [(t.read_snapshot, [(r.begin, r.end) for r in t.read_ranges],
             [(w.begin, w.end) for w in t.write_ranges]) for t in txns]


@pytest.mark.parametrize("seed, n, version", [(1, 16, 100), (10, 24, 100),
                                              (12, 24, 220)])
def test_tiny_txns_are_the_jax_copys(seed, n, version):
    """Both files draw the same numpy stream into the same ranges."""
    assert plain(pg._tiny_txns(seed, n, version)) == plain(
        jg._tiny_txns(seed, n, version))


def test_entry_equals_the_jax_entry():
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        jfn, jargs = jg.entry()
        want = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
    fn, args = pg.entry(device="cpu")
    assert [a.device.type for a in args] == ["cpu"] * 3
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = [o.numpy() for o in fn(*args)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_dryrun_multichip_8_on_the_cpu(capsys):
    steps = pg.dryrun_multichip(8, device="cpu")
    assert len(steps) == 3 and all(len(s) == 24 for s in steps)
    assert any(1 in s for s in steps)
    assert "8 shards ok, shards per device {'cpu': 8}" in (
        capsys.readouterr().out)


def test_dryrun_statuses_equal_the_jax_mesh():
    """The dry run's three steps on the JAX ShardedConflictSetTPU over an
    8-device CPU mesh (the body of the JAX dryrun_multichip, in this
    process) give the port's statuses."""
    import jax
    from jax.sharding import Mesh

    from foundationdb_tpu.resolver.sharded import ShardedConflictSetTPU

    n = 8
    devs = jax.devices("cpu")
    assert len(devs) >= n, "conftest forces 8 virtual host devices"
    bounds = [jg._k8(256 * (i + 1) // n) for i in range(n - 1)]
    with jax.default_device(devs[0]):
        tpu = ShardedConflictSetTPU(bounds, Mesh(np.array(devs[:n]),
                                                 ("resolvers",)),
                                    max_key_bytes=8, initial_capacity=64)
        want, version = [], 100
        for step in range(3):
            txns = jg._tiny_txns(seed=10 + step, n_txns=24, version=version)
            want.append(tpu.resolve(version, max(0, version - 120),
                                    txns).statuses)
            version += 60
    assert pg.dryrun_multichip(n, device="cpu") == want


def test_without_a_card_the_entry_points_raise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pg.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pg.dryrun_multichip(2)
