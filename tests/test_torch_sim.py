"""The simulator's own cases on the port, on the CPU (device="cpu"):
every case of tests/test_sim_faults.py (SimulatedCluster under clogs,
blackouts and partitions, with the port's default device backends,
ConflictSetGPU and KeyValueStoreGPU, behind it) and every case of
tests/test_tester_specs.py (run_spec's compound specs); the backup
workloads (BackupRestore, BackupAttrition) on a hand-written spec give
the JAX package's whole result; and without a card every entry point
raises unless the caller asked for the CPU.
"""

import hashlib
import json

import pytest
import torch

from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
from foundationdb_tpu_torch.core.trace import TraceSink, set_global_sink
from foundationdb_tpu_torch.sim import SimulatedCluster
from foundationdb_tpu_torch.workloads.cycle import CycleWorkload
from foundationdb_tpu_torch.workloads.tester import SpecError, run_spec


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The device backends' plain versions on one CPU thread: their ops
    are tiny, and torch's thread pool only contends with the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_spec(spec: dict) -> dict:
    return run_spec(spec, device="cpu")


# ------------------------------------------- tests/test_sim_faults.py cases


def run_cycle_with_faults(seed: int, *, clogging=True, attrition=True,
                          nodes=10, clients=4, txns=12):
    sink = TraceSink()
    set_global_sink(sink)
    loop = sim_loop(seed=seed, buggify=True)
    with loop_context(loop):
        sc = SimulatedCluster(device="cpu")
        db = sc.database()

        async def main():
            wl = CycleWorkload(db, nodes=nodes)
            await wl.setup()
            if clogging:
                sc.start_random_clogging(mean_interval=0.05, max_clog=0.2)
            if attrition:
                sc.start_attrition(mean_interval=0.8, max_outage=0.5)
            await wl.start(clients=clients, txns_per_client=txns)
            ok = await wl.check()
            sc.stop()
            return ok, wl.txns_done, wl.retries

        ok, done, retries = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    digest = hashlib.sha256(
        "\n".join(
            json.dumps(e, sort_keys=True, default=str) for e in sink.events
        ).encode()
    ).hexdigest()
    return ok, done, retries, sink, digest, sc


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_cycle_survives_network_faults(seed):
    ok, done, retries, sink, _, sc = run_cycle_with_faults(seed)
    assert ok, f"cycle invariant broken under faults (seed {seed})"
    assert done == 48
    assert sink.count("SimClogPair") + sink.count("SimBlackout") > 0
    assert not sink.has_severity(40)
    # The device backends were the ones behind the simulated network.
    assert type(sc.cluster.resolver.cs).__name__ == "ConflictSetGPU"
    assert type(sc.cluster.storage.data).__name__ == "KeyValueStoreGPU"


def test_fault_run_is_deterministic():
    a = run_cycle_with_faults(99)
    b = run_cycle_with_faults(99)
    assert a[4] == b[4], "same seed+faults must replay bit-identically"
    c = run_cycle_with_faults(100)
    assert a[4] != c[4]


def test_blackout_drops_messages_and_recovery_resumes():
    ok, done, retries, sink, _, sc = run_cycle_with_faults(
        7, clogging=False, attrition=True, clients=3, txns=10
    )
    assert ok
    assert sc.net.messages_dropped > 0, "blackouts should eat messages"
    assert retries > 0


def test_partition_heals():
    from foundationdb_tpu_torch.core.runtime import current_loop, spawn

    loop = sim_loop(seed=5)
    with loop_context(loop):
        sc = SimulatedCluster(device="cpu")
        db = sc.database()

        async def main():
            await db.set(b"k", b"1")
            sc.net.partition(sc.client_proc, sc.server)

            async def heal_later():
                await current_loop().delay(3.0)
                sc.net.heal(sc.client_proc, sc.server)

            spawn(heal_later(), name="healer")
            v = await db.get(b"k")
            assert v == b"1"
            assert current_loop().now() >= 3.0 - 1e-9
            sc.stop()

        loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()


# ----------------------------------------- tests/test_tester_specs.py cases


def test_cycle_spec_local():
    res = cpu_spec({
        "seed": 11,
        "cluster": {"kind": "local"},
        "workloads": [{"name": "Cycle", "nodes": 16, "clients": 4,
                       "txns": 20}],
    })
    assert res["ok"], res
    assert res["Cycle"]["metrics"]["txns"] == 80


def test_compound_spec_sharded_with_churn():
    res = cpu_spec({
        "seed": 23,
        "buggify": True,
        "cluster": {"kind": "sharded", "n_storage": 4, "n_logs": 2,
                    "replication": "double",
                    "shard_boundaries": [b"cycle/\x00\x00\x00\x08"]},
        "workloads": [
            {"name": "Cycle", "nodes": 16, "clients": 3, "txns": 15},
            {"name": "RandomMoveKeys", "interval": 0.4},
            {"name": "DataDistribution", "interval": 0.3},
        ],
    })
    assert res["ok"], res
    assert res["RandomMoveKeys"]["metrics"]["moves"] >= 1
    assert res["ConsistencyCheck"]["ok"], res["ConsistencyCheck"]


def test_readwrite_spec_reports_metrics():
    res = cpu_spec({
        "seed": 5,
        "cluster": {"kind": "local"},
        "workloads": [{"name": "ReadWrite", "clients": 6, "duration": 2.0}],
    })
    m = res["ReadWrite"]["metrics"]
    assert m["transactions"] > 0 and m["tps"] > 0
    assert m["latency_p50_s"] is not None


def test_spec_determinism():
    spec = {
        "seed": 7,
        "cluster": {"kind": "sharded", "n_storage": 4, "n_logs": 2,
                    "replication": "double", "shard_boundaries": [b"m"]},
        "workloads": [
            {"name": "Serializability", "clients": 3, "txns": 10},
            {"name": "RandomMoveKeys", "interval": 0.5},
        ],
    }
    a, b = cpu_spec(dict(spec)), cpu_spec(dict(spec))
    assert a["Serializability"] == b["Serializability"]
    assert a["RandomMoveKeys"] == b["RandomMoveKeys"]


def test_unknown_workload_rejected():
    with pytest.raises(SpecError):
        cpu_spec({"cluster": {"kind": "local"},
                  "workloads": [{"name": "Nope"}]})


def test_attrition_spec_recovers_and_stays_consistent():
    res = cpu_spec({
        "seed": 77,
        "buggify": True,
        "cluster": {"kind": "recoverable_sharded", "n_storage": 4,
                    "n_logs": 2, "replication": "double"},
        "workloads": [
            {"name": "Cycle", "nodes": 14, "clients": 3, "txns": 20},
            {"name": "Attrition", "interval": 0.8, "kills": 2},
        ],
    })
    assert res["ok"], res
    assert res["Attrition"]["metrics"]["kills"] >= 1
    assert res["ConsistencyCheck"]["ok"]


def test_attrition_requires_recoverable_cluster():
    with pytest.raises(SpecError):
        cpu_spec({"cluster": {"kind": "sharded", "n_storage": 4,
                              "n_logs": 2, "replication": "double"},
                  "workloads": [{"name": "Attrition"}]})


def test_watches_spec_on_sharded_cluster():
    res = cpu_spec({
        "seed": 13,
        "cluster": {"kind": "sharded", "n_storage": 4, "n_logs": 2,
                    "replication": "double",
                    "shard_boundaries": [b"watch/004"]},
        "workloads": [{"name": "Watches", "pairs": 8, "rounds": 3}],
    })
    assert res["ok"], res
    assert res["Watches"]["metrics"]["fires"] == 24


# --------------------------------------- the backup workloads, and no card


@pytest.mark.parametrize("name", ["BackupRestore", "BackupAttrition"])
def test_backup_workloads_raise_naming_item_9(name):
    """Since the backup tier is ported the backup workloads run: a spec
    with one of them beside Cycle gives the JAX package's whole result
    (host backends pinned on both sides), and passes on the port's device
    backends."""
    from foundationdb_tpu.workloads.tester import run_spec as jax_run_spec

    spec = {"seed": 5, "buggify": True,
            "cluster": {"kind": "sharded", "n_storage": 3, "n_logs": 1,
                        "replication": "single"},
            "knobs": {"server:CONFLICT_SET_IMPL": "oracle",
                      "server:STORAGE_ENGINE_IMPL": "memory"},
            "workloads": [{"name": "Cycle", "nodes": 8, "clients": 2,
                           "txns": 8}, {"name": name}]}
    want, got = jax_run_spec(spec), cpu_spec(spec)
    assert want["ok"] and want[name]["ok"], want
    assert set(got) == set(want)
    for key in sorted(want):
        assert got[key] == want[key], key
    device = cpu_spec(dict(spec, knobs={
        "server:CONFLICT_SET_IMPL": "gpu",
        "server:STORAGE_ENGINE_IMPL": "gpu"}))
    assert device["ok"] and device[name] == want[name], device


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_without_a_card_the_simulator_raises():
    from foundationdb_tpu_torch.sim.config import run_randomized
    from foundationdb_tpu_torch.sim.sweep import sweep

    spec = {"cluster": {"kind": "local"}, "workloads": [{"name": "Cycle"}]}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_spec(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep([3])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_randomized([3], log=lambda m: None)
    loop = sim_loop(seed=1)
    with loop_context(loop):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimulatedCluster()
    loop.shutdown()


def test_topology_spec_rehomes_storage_on_the_cluster_device():
    """A machine-topology spec under MachineAttrition on the device
    backends: every storage server, re-homed ones included, keeps a
    KeyValueStoreGPU window on the cluster's device."""
    from foundationdb_tpu_torch.cluster.recovery import (
        RecoverableShardedCluster,
    )

    built = []
    real = RecoverableShardedCluster.start

    def start(self):
        built.append(self)
        return real(self)

    RecoverableShardedCluster.start = start
    try:
        res = cpu_spec({
            "seed": 7, "buggify": True,
            "knobs": {"server:CONFLICT_SET_IMPL": "gpu",
                      "server:STORAGE_ENGINE_IMPL": "gpu"},
            "cluster": {"kind": "recoverable_sharded", "n_storage": 6,
                        "n_logs": 2, "replication": "three_datacenter",
                        "shard_boundaries": ["m"],
                        "topology": {"n_dcs": 3, "machines_per_dc": 2}},
            "workloads": [
                {"name": "Cycle", "nodes": 16, "clients": 3, "txns": 20},
                {"name": "MachineAttrition", "interval": 0.6, "kills": 2,
                 "reboots": 1, "swizzles": 1, "dc_kills": 1,
                 "outage": 0.4},
            ],
        })
    finally:
        RecoverableShardedCluster.start = real
    assert res["ok"], res
    (cluster,) = built
    assert cluster.device == "cpu"
    for s in cluster.storages:
        assert type(s.data).__name__ == "KeyValueStoreGPU"
        assert s.data.device.type == "cpu"
