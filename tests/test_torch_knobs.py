"""The port's knobs after its core/knobs.py became the copy of the JAX
package's Knobs/ServerKnobs/ClientKnobs registry.

Every knob the port had before keeps its name and default; attribute
assignment and set_knob work; the registry matches the JAX package's,
name for name and default for default, but for the port's recorded
departures (the storage engine's and the conflict set's backends, with
the card as their default; no probe knob); a randomized draw under one
seed equals the JAX package's; the storage-engine knob rejects "tpu" and
unknown names, the conflict-set knob "native", "tpu" and unknown names.
"""

import pytest

from foundationdb_tpu_torch.core.knobs import (
    CLIENT_KNOBS,
    SERVER_KNOBS,
    ClientKnobs,
    ServerKnobs,
)
from foundationdb_tpu_torch.core.rand import DeterministicRandom

# The port's server knobs before the registry (name -> default).
EARLIER_SERVER = {
    "VERSIONS_PER_SECOND": 1_000_000,
    "MAX_READ_TRANSACTION_LIFE_VERSIONS": 5 * 1_000_000,
    "TPU_BATCH_BUCKETS": (256, 1024, 4096, 16384, 65536),
    "TPU_MAX_CHUNK_TXNS": 65536,
    "TPU_MAX_CHUNK_RANGES": 1 << 19,
    "TPU_STICKY_DECAY_BATCHES": 64,
    "TPU_BLOCK_SLOTS": 32,
    "TPU_COMPACT_EVERY_BATCHES": 16,
    "TPU_MAX_TOUCHED_BLOCKS": 1 << 17,
    "TPU_PIPELINE_DEPTH": 4,
    "STORAGE_TPU_DELTA_SLOTS": 2048,
    "STORAGE_TPU_SPAN_CAP": 256,
    "STORAGE_READ_BATCH_MAX": 128,
    "STORAGE_READ_PIPELINE_DEPTH": 2,
}
# Where the port's registry differs from the JAX package's, and why: the
# storage window's and the conflict set's backends are the port's (the
# card is the default of both); the device picks the probe.
DEPARTURES = {"STORAGE_ENGINE_IMPL": "gpu", "CONFLICT_SET_IMPL": "gpu"}
JAX_ONLY = {"TPU_PROBE_KERNEL"}


@pytest.mark.parametrize("name", sorted(EARLIER_SERVER))
def test_earlier_server_knob_keeps_its_default(name):
    assert getattr(ServerKnobs(), name) == EARLIER_SERVER[name]
    assert getattr(SERVER_KNOBS, name) == EARLIER_SERVER[name]


def test_earlier_client_knob_keeps_its_default():
    assert ClientKnobs().KEY_SIZE_LIMIT == 10_000
    assert CLIENT_KNOBS.KEY_SIZE_LIMIT == 10_000


def test_attribute_assignment_and_set_knob(monkeypatch):
    k = ServerKnobs()
    k.TPU_COMPACT_EVERY_BATCHES = 4
    assert k.TPU_COMPACT_EVERY_BATCHES == 4
    k.set_knob("tpu_compact_every_batches", "8")
    assert k.TPU_COMPACT_EVERY_BATCHES == 8
    k.set_knob("TPU_BATCH_BUCKETS", "16,32")
    assert k.TPU_BATCH_BUCKETS == (16, 32)
    k.set_knob("RESOLVER_WIRE_BATCH", "false")
    assert k.RESOLVER_WIRE_BATCH is False
    with pytest.raises(KeyError):
        k.set_knob("NO_SUCH_KNOB", "1")
    # the process-wide registry is settable the same way
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_TPU_DELTA_SLOTS", 16)
    assert SERVER_KNOBS.STORAGE_TPU_DELTA_SLOTS == 16
    assert ServerKnobs().STORAGE_TPU_DELTA_SLOTS == 2048


@pytest.mark.parametrize("cls", ["ServerKnobs", "ClientKnobs"])
def test_registry_matches_the_jax_package(cls):
    from foundationdb_tpu.core import knobs as jknobs
    from foundationdb_tpu_torch.core import knobs as pknobs

    want = getattr(jknobs, cls)().all()
    got = getattr(pknobs, cls)().all()
    for name in JAX_ONLY:
        want.pop(name, None)
    for name, value in DEPARTURES.items():
        if name in want:
            want[name] = value
    assert got == want


@pytest.mark.parametrize("seed", [0, 7])
def test_randomized_draw_matches_the_jax_package(seed):
    from foundationdb_tpu.core.knobs import ServerKnobs as JServerKnobs
    from foundationdb_tpu.core.rand import DeterministicRandom as JRandom

    want = JServerKnobs(randomize=True, random=JRandom(seed)).all()
    got = ServerKnobs(randomize=True, random=DeterministicRandom(seed)).all()
    for name in JAX_ONLY:
        want.pop(name)
    want.update(DEPARTURES)
    assert got == want
    assert got != ServerKnobs().all()  # the draw moved some knob


def test_no_probe_knob():
    for name in JAX_ONLY:
        assert not hasattr(SERVER_KNOBS, name)


def test_conflict_set_impl_takes_gpu_or_oracle(monkeypatch):
    from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
    from foundationdb_tpu_torch.resolver.factory import (
        make_conflict_set,
        validate_conflict_set_impl,
    )
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU

    assert ServerKnobs().CONFLICT_SET_IMPL == "gpu"
    assert isinstance(make_conflict_set(device="cpu"), ConflictSetGPU)
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "oracle")
    assert isinstance(make_conflict_set(), ConflictSetCPU)
    for bad in ("native", "tpu", "rocksdb", ""):
        with pytest.raises(ValueError):
            validate_conflict_set_impl(bad)
        monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", bad)
        with pytest.raises(ValueError):
            make_conflict_set(device="cpu")


@pytest.mark.parametrize("bad", ["tpu", "TPU", "rocksdb", ""])
def test_storage_engine_impl_rejects_tpu_and_unknown_names(bad, monkeypatch):
    from foundationdb_tpu_torch.storage_engine.factory import (
        make_mvcc_window,
        validate_storage_engine_impl,
    )

    with pytest.raises(ValueError):
        validate_storage_engine_impl(bad)
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", bad)
    with pytest.raises(ValueError):
        make_mvcc_window(device="cpu")


def test_storage_engine_impl_selects_the_window(monkeypatch):
    from foundationdb_tpu_torch.kv.versioned_map import VersionedMap
    from foundationdb_tpu_torch.storage_engine.factory import make_mvcc_window
    from foundationdb_tpu_torch.storage_engine.gpu_engine import (
        KeyValueStoreGPU,
    )

    assert SERVER_KNOBS.STORAGE_ENGINE_IMPL == "gpu"
    assert isinstance(make_mvcc_window(device="cpu"), KeyValueStoreGPU)
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "memory")
    assert isinstance(make_mvcc_window(device="cpu"), VersionedMap)
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "GPU")
    assert isinstance(make_mvcc_window(device="cpu"), KeyValueStoreGPU)
