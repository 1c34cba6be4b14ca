"""Two-DC regions on the port (the LogRouter shipping and DC-kill failover
of cluster/log_system.py, through RecoverableShardedCluster(regions=True)),
on the CPU: every case of tests/test_regions.py with the port's default
back ends, ConflictSetGPU and KeyValueStoreGPU on device="cpu", plus the
chaos_regions spec equal to the JAX package's result with the host back
ends pinned on both sides, and its device back ends equal to its host
ones.

Acceptance contract (the reference file's): a `kill_datacenter` on the
primary DC under the two-region config fails over to the remote log set
with ZERO acked-write loss (under the MachineAttrition nemesis), and
failover is REFUSED whenever it would strand an acked write on the dark
primary."""

import json
import os

import pytest

from foundationdb_tpu_torch.cluster.recovery import RecoverableShardedCluster
from foundationdb_tpu_torch.core import loop_context
from foundationdb_tpu_torch.core.runtime import sim_loop
from foundationdb_tpu_torch.sim.topology import MachineTopology
from foundationdb_tpu_torch.workloads.tester import run_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGIONS_SPEC = os.path.join(ROOT, "specs", "chaos_regions.json")

TOPO = {"n_dcs": 2, "machines_per_dc": 2}


def _regions_cluster(**kw):
    base = dict(n_storage=4, n_logs=3, replication="two_datacenter",
                log_replication="double", regions=True,
                shard_boundaries=[b"m"], topology=TOPO)
    base.update(kw)
    return RecoverableShardedCluster(device="cpu", **base).start()


def test_regions_require_multi_dc_topology():
    loop = sim_loop(seed=2)
    with loop_context(loop):
        with pytest.raises(ValueError, match="n_dcs"):
            RecoverableShardedCluster(
                n_storage=2, n_logs=2, regions=True,
                topology={"n_dcs": 1, "machines_per_dc": 3}, device="cpu",
            )
        with pytest.raises(ValueError, match="n_dcs"):
            RecoverableShardedCluster(n_storage=2, n_logs=2, regions=True,
                                      device="cpu")
    loop.shutdown()


def test_routers_ship_asynchronously_and_mirror_pops():
    loop = sim_loop(seed=11)
    with loop_context(loop):
        cluster = _regions_cluster()
        topo = MachineTopology(cluster, **TOPO)
        db = topo.database()
        ls = cluster.log_system

        async def main():
            assert len(ls.log_sets) == 2
            # Remote logs live on DC1's machines only.
            for m in topo.machines:
                if m.remote_log_ids:
                    assert m.dc.index == 1
                if m.log_ids:
                    assert m.dc.index == 0
            for i in range(15):
                await db.set(b"s%02d" % i, b"x%d" % i)
            deadline = loop.now() + 30.0
            while ls.shipped_version() < ls._acked_floor \
                    and loop.now() < deadline:
                await loop.delay(0.1)
            assert ls.shipped_version() >= ls._acked_floor, \
                "routers never caught up to the acked floor"
            # The mirrored stream is byte-identical per log index.
            for i, (src, dst) in enumerate(
                zip(ls.log_sets[0], ls.log_sets[1])
            ):
                src_entries = [(v, len(tms)) for v, tms in src._entries]
                dst_entries = [(v, len(tms)) for v, tms in dst._entries
                               if v > src.popped]
                assert dst_entries[-len(src_entries):] == src_entries \
                    or src_entries == dst_entries, i
            cluster.stop()

        loop.run(main(), timeout_sim_seconds=600)
    loop.shutdown()


def test_dc_kill_fails_over_with_zero_acked_loss_under_attrition():
    """The tentpole acceptance test: primary-DC kill under the nemesis;
    the remote set takes over and every acked write survives."""
    from foundationdb_tpu_torch.workloads.attrition import MachineAttritionWorkload

    loop = sim_loop(seed=1311, buggify=True)
    with loop_context(loop):
        cluster = _regions_cluster()
        topo = MachineTopology(cluster, **TOPO)
        db = topo.database()
        ls = cluster.log_system

        async def main():
            acked = []
            # Machine attrition runs CONCURRENTLY with the write load
            # (no dc_kills in the deck — the DC kill below is the test's
            # own, so its timing is pinned).
            nemesis = MachineAttritionWorkload(
                topo, interval=0.5, kills=2, reboots=0, swizzles=1,
                name="regions-nemesis",
            ).start()
            for i in range(40):
                k, v = b"r%03d" % i, b"v%d" % i
                await db.set(k, v)
                acked.append((k, v))
            await nemesis.done
            assert await nemesis.check()

            # Drain the routers, then take out the whole primary DC.
            deadline = loop.now() + 60.0
            while ls.shipped_version() < ls._acked_floor \
                    and loop.now() < deadline:
                await loop.delay(0.1)
            assert ls.shipped_version() >= ls._acked_floor
            killed = topo.kill_datacenter(topo.dcs[0])
            assert killed, "the DC kill must land"
            assert all(m.dc.index == 0 for m in killed)
            cluster.start_controller("regions-cc")
            deadline = loop.now() + 60.0
            while not ls.failed_over and loop.now() < deadline:
                await loop.delay(0.2)
            assert ls.failed_over and ls.active_set == 1, \
                "recovery never failed over to the remote log set"

            # The remote set is now the commit path: writes continue
            # while the primary DC is still dark.
            for i in range(40, 50):
                k, v = b"r%03d" % i, b"v%d" % i
                await db.set(k, v)
                acked.append((k, v))
            for m in killed:
                topo.restore_machine(m)
            lost = [k for k, v in acked if (await db.get(k)) != v]
            assert not lost, f"acked writes lost across failover: {lost}"
            cluster.stop()

        loop.run(main(), timeout_sim_seconds=900)
    loop.shutdown()


def test_failover_refused_when_it_would_strand_acked_writes():
    """The known-committed gate: with the routers BEHIND the acked
    floor, a primary-DC loss must refuse failover (stall, not lose)."""
    loop = sim_loop(seed=23)
    with loop_context(loop):
        cluster = _regions_cluster()
        topo = MachineTopology(cluster, **TOPO)
        db = topo.database()
        ls = cluster.log_system
        from foundationdb_tpu_torch.core.errors import OperationFailed

        async def main():
            # Stall shipping: the remote set goes dark, routers park.
            for dst in ls.log_sets[1]:
                dst.reachable = False
            for i in range(10):
                await db.set(b"g%d" % i, b"w%d" % i)
            assert ls.shipped_version() < ls._acked_floor
            for dst in ls.log_sets[1]:
                dst.reachable = True
            # Primary DC dies before the routers catch up... but the
            # remote set was dark while the acked writes happened, so
            # failing over now would strand them.
            killed = topo.kill_datacenter(topo.dcs[0])
            assert killed
            with pytest.raises(OperationFailed):
                ls.lock(cluster.generation + 1)
            assert not ls.failed_over, \
                "failover must never strand an acked write"
            # Restore the primary: recovery proceeds on the PRIMARY set
            # and nothing acked was lost.
            for m in killed:
                topo.restore_machine(m)
            cluster.start_controller("strand-cc")
            deadline = loop.now() + 60.0
            while loop.now() < deadline:
                try:
                    if all([(await db.get(b"g%d" % i)) == b"w%d" % i
                            for i in range(10)]):
                        break
                except BaseException:  # noqa: BLE001 — mid-recovery reads
                    pass
                await loop.delay(0.2)
            for i in range(10):
                assert await db.get(b"g%d" % i) == b"w%d" % i, i
            assert not ls.failed_over
            cluster.stop()

        loop.run(main(), timeout_sim_seconds=900)
    loop.shutdown()


def test_status_json_reports_replication_and_region_lag():
    loop = sim_loop(seed=31)
    with loop_context(loop):
        cluster = _regions_cluster()
        topo = MachineTopology(cluster, **TOPO)
        db = topo.database()

        async def main():
            from foundationdb_tpu_torch.cluster.status import cluster_status

            for i in range(5):
                await db.set(b"st%d" % i, b"v%d" % i)
            st = cluster_status(cluster)["cluster"]
            conf = st["configuration"]
            assert conf["log_replication"] == "double"
            assert conf["log_replication_factor"] == 2
            assert conf["regions"] is True
            regions = st["regions"]
            assert regions["failed_over"] is False
            assert regions["active_set"] == 0
            assert regions["remote_pull_lag_versions"] >= 0
            assert len(regions["routers"]) == 3
            log_roles = [r for r in st["roles"] if r["role"] == "log"]
            assert len(log_roles) == 6  # both sets
            assert {r["log_set"] for r in log_roles} == {0, 1}
            for r in log_roles:
                assert r["durable_lag_versions"] >= 0
                assert r["reachable"] is True
            cluster.stop()

        loop.run(main(), timeout_sim_seconds=600)
    loop.shutdown()


def _regions_chaos_spec(seed=None):
    with open(REGIONS_SPEC) as f:
        spec = json.load(f)
    if seed is not None:
        spec["seed"] = seed
    return spec


def _run_regions_chaos(seed=None):
    return run_spec(_regions_chaos_spec(seed), device="cpu")


def test_chaos_regions_spec_green_and_deterministic():
    """The sweep's base spec (tools/seed_sweep.py --preset regions):
    Cycle under machine kills + a DC kill over the two-region config,
    green and bit-identically replayable."""
    a = _run_regions_chaos()
    assert a["ok"], a
    assert a["sev_errors"] == 0
    b = _run_regions_chaos()
    assert b["fingerprint"] == a["fingerprint"], \
        "same seed must replay to the identical final keyspace"


HOST = {"server:CONFLICT_SET_IMPL": "oracle",
        "server:STORAGE_ENGINE_IMPL": "memory"}
DEVICE = {"server:CONFLICT_SET_IMPL": "gpu",
          "server:STORAGE_ENGINE_IMPL": "gpu"}


def _pinned(spec, knobs):
    return dict(spec, knobs={**spec.get("knobs", {}), **knobs})


@pytest.mark.parametrize("seed", [None, 5])
def test_chaos_regions_spec_equals_the_jax_package(seed):
    """The same spec through both packages' run_spec with the host back
    ends pinned: the whole result (ok, checks, metrics, fingerprint,
    SevErrors, coverage) is equal; the port's device back ends give its
    host back ends' outcome."""
    from foundationdb_tpu.workloads.tester import run_spec as jax_run_spec
    from foundationdb_tpu_torch.sim.sweep import mismatches, outcome

    spec = _regions_chaos_spec(seed)
    want = jax_run_spec(_pinned(spec, HOST))
    got = run_spec(_pinned(spec, HOST), device="cpu")
    assert want["ok"] and not want["sev_errors"], want
    assert got == want
    device = run_spec(_pinned(spec, DEVICE), device="cpu")
    assert mismatches(outcome(device), outcome(got)) == []
