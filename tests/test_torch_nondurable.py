"""The port's simulated disk (sim/nondurable.py) against the JAX
package's, on the CPU.

- every case of tests/test_nondurable.py, run from that file with its
  NonDurableOS, DurabilityValidator, DeterministicRandom, DiskQueue and
  KeyValueStoreMemory swapped for the port's (the reference file is
  loaded under another module name and left as it is);
- the same seeded power losses in both packages: the same writes through
  each package's DiskQueue or memory engine over each package's
  NonDurableOS, with the fsync of a dying commit withheld, then kill():
  the havoc's stats (dropped, kept, corrupted), every page left on the
  simulated disk, and the records or rows recovered are equal.
"""

import importlib.util
from pathlib import Path

import pytest

from foundationdb_tpu.core.rand import DeterministicRandom as JRandom
from foundationdb_tpu.sim import nondurable as jnd
from foundationdb_tpu.storage_engine.diskqueue import DiskQueue as JQueue
from foundationdb_tpu.storage_engine.memory_engine import (
    KeyValueStoreMemory as JMemory,
)
from foundationdb_tpu_torch.core.rand import DeterministicRandom as PRandom
from foundationdb_tpu_torch.sim import nondurable as pnd
from foundationdb_tpu_torch.storage_engine.diskqueue import DiskQueue as PQueue
from foundationdb_tpu_torch.storage_engine.memory_engine import (
    KeyValueStoreMemory as PMemory,
)

REF = Path(__file__).with_name("test_nondurable.py")


def _load_reference():
    spec = importlib.util.spec_from_file_location("_ref_nondurable", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference()


@pytest.mark.parametrize("case", sorted(n for n in dir(ref)
                                        if n.startswith("test_")))
def test_reference_case_on_the_port(case, monkeypatch):
    for name, obj in (("DeterministicRandom", PRandom),
                      ("NonDurableOS", pnd.NonDurableOS),
                      ("DurabilityValidator", pnd.DurabilityValidator),
                      ("SimValidationError", pnd.SimValidationError),
                      ("DiskQueue", PQueue),
                      ("KeyValueStoreMemory", PMemory)):
        monkeypatch.setattr(ref, name, obj)
    getattr(ref, case)()


def disk(fs) -> dict:
    """Every file's durable pages and sizes on a simulated disk."""
    return {path: (f.size, f.durable_size, sorted(f.durable.items()),
                   sorted(f.pending.items()))
            for path, f in sorted(fs.files.items())}


def queue_trial(rand_cls, os_cls, queue_cls, seed: int):
    rng = rand_cls(seed)
    fs = os_cls(rng)
    out = []
    for trial in range(8):
        q = queue_cls("/simdisk/q", os_layer=fs)
        for i in range(rng.random_int(1, 20)):
            q.push(b"committed-%d-%d-" % (trial, i) * rng.random_int(1, 60))
        q.commit()
        for i in range(rng.random_int(1, 10)):
            q.push(b"torn-%d-%d" % (trial, i))
        fsync = fs.fsync
        fs.fsync = lambda fd: None   # the dying machine's fsync never lands
        try:
            q.commit()
        finally:
            fs.fsync = fsync
        stats = fs.kill(prefixes=["/simdisk/q"] if trial % 2 else None)
        q2 = queue_cls("/simdisk/q", os_layer=fs)
        out.append((stats, q2.recovered, q2.next_seq, disk(fs)))
    return out


def engine_trial(rand_cls, os_cls, kv_cls, seed: int):
    rng = rand_cls(seed)
    out = []
    for trial in range(6):
        fs = os_cls(rng)
        kv = kv_cls("/simdisk/kv", os_layer=fs)
        for i in range(rng.random_int(5, 60)):
            k = b"k%02d" % rng.random_int(0, 30)
            kv.set(k, b"v-%d-%d" % (trial, i) * rng.random_int(1, 40))
            if rng.random01() < 0.1:
                kv.clear_range(k, k + b"\xff")
        kv.commit()
        kv.set(b"pending", b"written but never committed")
        fsync = fs.fsync
        fs.fsync = lambda fd: None
        try:
            kv.commit()
        finally:
            fs.fsync = fsync
        stats = fs.kill()
        kv2 = kv_cls("/simdisk/kv", os_layer=fs)
        out.append((stats, kv2.get_range(b"", b"\xff"), disk(fs)))
    return out


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_power_loss_equal_in_both_packages_queue(seed):
    want = queue_trial(JRandom, jnd.NonDurableOS, JQueue, seed)
    got = queue_trial(PRandom, pnd.NonDurableOS, PQueue, seed)
    assert [w[0] for w in want] == [g[0] for g in got]   # the havoc stats
    assert sum(w[0]["dropped"] + w[0]["corrupted"] for w in want) > 0
    assert got == want


@pytest.mark.parametrize("seed", [5, 17])
def test_power_loss_equal_in_both_packages_memory_engine(seed):
    want = engine_trial(JRandom, jnd.NonDurableOS, JMemory, seed)
    got = engine_trial(PRandom, pnd.NonDurableOS, PMemory, seed)
    assert [w[0] for w in want] == [g[0] for g in got]
    assert got == want
