"""The port's recovery tier on the CPU: RecoverableCluster and
RecoverableShardedCluster, which re-recruit the transaction system (the
resolvers through make_conflict_set and SERVER_KNOBS.CONFLICT_SET_IMPL)
every generation, with coordination, leader election and discovery.

- every case of tests/test_recovery.py and tests/test_monitor_leader.py
  on the port; each case that builds a cluster runs once per back end:
  "gpu" (ConflictSetGPU and KeyValueStoreGPU, device="cpu") and "oracle"
  (ConflictSetCPU and the VersionedMap window);
- the cases of tests/test_conflict_factory.py under the port's names:
  the factory builds gpu | native | oracle, reads the knob, and refuses
  the JAX package's "tpu" and a typo;
- a same-seed differential against the JAX package: each package's
  RecoverableCluster under its own sim_loop(seed), two controllers,
  Cycle with two kills of the transaction system, must give identical
  check results, commits, retries, generations, keyspace and trace
  digest (oracles on both sides; and ConflictSetTPU + KeyValueStoreTPU
  with the Pallas probe in interpret mode, on the synchronous resolver
  path, against the port's device back ends at their default pipeline
  depth);
- a dead generation's conflict set is collected;
- the entry points raise without a card. (The durable tier's options run:
  tests/test_torch_durable_cluster.py and test_torch_regions.py.)
"""

import gc
import hashlib
import importlib
import json
import struct
import weakref

import pytest

from foundationdb_tpu_torch.cluster.coordination import (
    CoordinatedState,
    CoordinatorRegister,
    LeaderElection,
)
from foundationdb_tpu_torch.cluster.monitor_leader import ClusterFile, connect
from foundationdb_tpu_torch.cluster.recovery import (
    RecoverableCluster,
    RecoverableShardedCluster,
)
from foundationdb_tpu_torch.core import delay, loop_context, sim_loop, spawn
from foundationdb_tpu_torch.core.errors import (
    FdbError,
    NotCommitted,
    OperationFailed,
    TLogStopped,
)
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.core.runtime import current_loop
from foundationdb_tpu_torch.core.trace import TraceSink, set_global_sink
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.factory import (
    KNOWN_CONFLICT_SET_IMPLS,
    make_conflict_set,
    validate_conflict_set_impl,
)
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.workloads.consistency_check import (
    ConsistencyCheckWorkload,
)
from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

BACKENDS = {"gpu": "gpu", "oracle": "memory"}   # conflict set -> window


@pytest.fixture(params=sorted(BACKENDS))
def backend(request, monkeypatch):
    """The recruited back ends: the conflict-set knob and the storage
    window knob set together (the port's knobs are restored after)."""
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", request.param)
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL",
                        BACKENDS[request.param])
    return request.param


@pytest.fixture
def psim():
    """A fresh deterministic port simulation loop, made current."""
    loop = sim_loop(seed=12345)
    with loop_context(loop):
        yield loop
    loop.shutdown()


def cs_type(backend):
    return ConflictSetGPU if backend == "gpu" else ConflictSetCPU


def rsc(**kw):
    return RecoverableShardedCluster(device="cpu", **kw)


# ------------------------------------------------- tests/test_recovery.py


def test_coordinated_state_quorum_and_fencing(psim):
    coords = [CoordinatorRegister(f"c{i}") for i in range(3)]
    cs = CoordinatedState(coords)

    async def main():
        gen1, v1 = cs.read_modify_write(lambda cur: {"n": 1})
        assert cs.read(gen1 + 1) == {"n": 1}
        # An older generation can no longer write (fenced).
        assert cs.write(gen1 - 1, {"n": 99}) is False
        assert cs.read(gen1 + 2) == {"n": 1}
        # Quorum survives one coordinator down; two down = unavailable.
        coords[0].available = False
        _, v2 = cs.read_modify_write(lambda cur: {"n": cur["n"] + 1})
        assert v2 == {"n": 2}
        coords[1].available = False
        with pytest.raises(OperationFailed):
            cs.read(10**18)
        coords[0].available = True
        coords[1].available = True
        assert cs.read(2 * 10**18) == {"n": 2}

    psim.run(main())


def test_leader_election_lease_takeover(psim):
    coords = [CoordinatorRegister(f"c{i}") for i in range(3)]
    el = LeaderElection(CoordinatedState(coords), lease_seconds=0.5)

    async def main():
        a = el.try_become_leader("A")
        assert a is not None and a.epoch == 1
        assert el.try_become_leader("B") is None
        a = el.heartbeat(a)
        assert a is not None
        # A stops heartbeating; after the lease lapses B takes over with a
        # NEW epoch, and A's stale lease is deposed.
        await current_loop().delay(0.6)
        b = el.try_become_leader("B")
        assert b is not None and b.epoch == 2
        assert el.heartbeat(a) is None

    psim.run(main())


def test_recovery_under_workload(backend):
    """Kill the transaction system mid-workload: the controller recovers
    a new generation over the surviving log, in-flight work retries, and
    the Cycle invariant holds; every generation recruited the knob's
    conflict set."""
    sink = TraceSink()
    set_global_sink(sink)
    loop = sim_loop(seed=6)
    with loop_context(loop):
        rc = RecoverableCluster(device="cpu").start()
        rc.start_controller("cc0")
        db = rc.database()

        async def main():
            wl = CycleWorkload(db, nodes=10)
            await wl.setup()
            work = spawn(wl.start(clients=3, txns_per_client=15),
                         name="cycle")

            async def killer():
                await current_loop().delay(0.3)
                rc.kill_transaction_system()
                await current_loop().delay(2.0)
                rc.kill_transaction_system()

            k = spawn(killer(), name="killer")
            await work.done
            await k.done
            ok = await wl.check()
            gens, kind = rc.generation, type(rc.resolver.cs)
            rc.stop()
            return ok, wl.txns_done, gens, kind

        ok, done, gens, kind = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    assert ok, "cycle invariant must survive recoveries"
    assert done == 45
    assert gens >= 3, "two kills => at least two recoveries past gen 1"
    assert kind is cs_type(backend)
    assert sink.count("RecoveryComplete") >= 3
    assert not sink.has_severity(40)


def test_tlog_epoch_fences_in_flight_commits(psim):
    """Every epoch-fence checkpoint in MemoryTLog.commit fires: a commit
    after the lock fails at once, a commit parked on the version chain
    fails on wake, a purged batch is invisible, the new chain advances."""
    from foundationdb_tpu_torch.cluster.tlog import MemoryTLog

    async def main():
        tlog = MemoryTLog(0)
        await tlog.commit(0, 1, [("m1",)], epoch=1)
        parked = spawn(tlog.commit(2, 3, [("m3",)], epoch=1), name="parked")
        await current_loop().delay(0.01)  # let it park on when_at_least(2)
        assert not parked.done.is_ready()
        rv = tlog.lock(2)
        assert rv == 1  # durable prefix survives
        try:
            await tlog.commit(1, 2, [("m2",)], epoch=1)
            raise AssertionError("expected TLogStopped")
        except TLogStopped:
            pass
        await tlog.commit(1, 4, [("m4",)], epoch=2)
        await current_loop().delay(0.01)
        assert parked.done.is_ready()
        assert isinstance(parked.done.error(), TLogStopped)
        entries = await tlog.peek(0)
        assert [v for v, _ in entries] == [1, 4]

    psim.run(main())


def test_proxy_maps_fence_to_not_committed(psim, backend):
    """A proxy of a fenced generation answers with the retryable
    not_committed, logged at severity 30."""
    from foundationdb_tpu_torch.cluster import LocalCluster
    from foundationdb_tpu_torch.cluster.interfaces import (
        CommitTransactionRequest,
    )

    sink = TraceSink()
    set_global_sink(sink)

    async def main():
        cluster = LocalCluster(make_conflict_set(0, device="cpu"),
                               device="cpu").start()
        db = cluster.database()
        await db.set(b"k", b"v")
        cluster.tlog.lock(1)  # newer generation fences the proxy
        req = CommitTransactionRequest(
            read_snapshot=0, read_conflict_ranges=(),
            write_conflict_ranges=(), mutations=(),
        )
        cluster.proxy.commit_stream.send(req)
        with pytest.raises(NotCommitted):
            await req.reply.future
        cluster.stop()

    psim.run(main())
    evs = sink.find("ProxyCommitBatchError")
    assert evs and all(e["Severity"] == 30 for e in evs)


def test_controller_failover(backend):
    """Two controller candidates: when the leading one dies, the
    standby's lease takeover makes IT perform the next recovery."""
    sink = TraceSink()
    set_global_sink(sink)
    loop = sim_loop(seed=12)
    with loop_context(loop):
        rc = RecoverableCluster(device="cpu").start()
        rc.start_controller("ccA")
        db = rc.database()

        async def main():
            await db.set(b"x", b"1")
            await current_loop().delay(1.0)
            rc._controllers.cancel_all()
            rc.start_controller("ccB")
            rc.kill_transaction_system()
            await db.set(b"y", b"2")  # blocks until ccB recovers
            vx, vy = await db.get(b"x"), await db.get(b"y")
            gen = rc.generation
            rc.stop()
            return vx, vy, gen

        vx, vy, gen = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    assert (vx, vy) == (b"1", b"2")
    assert gen >= 2
    leaders = [e["Leader"] for e in sink.find("LeaderElected")]
    assert "ccA" in leaders and "ccB" in leaders


def test_sharded_cluster_recovery_generations(psim, backend):
    """Recovery over the sharded tier: the tag-partitioned log is fenced,
    a new generation is recruited against the same logs, shard map and
    fleet, committed data survives, and DD and replicas still work."""
    from foundationdb_tpu_torch.cluster.data_distribution import move_keys
    from foundationdb_tpu_torch.kv.keys import KeyRange

    async def main():
        c = rsc(n_storage=4, n_logs=2, replication="double",
                shard_boundaries=[b"m"]).start()
        db = c.database()
        for i in range(15):
            await db.set(b"pre%02d" % i, b"v%d" % i)
        gen0 = c.generation
        c.kill_transaction_system()
        c.start_controller("cc0")
        await db.set(b"post", b"alive")
        assert c.generation > gen0
        assert type(c.resolver.cs) is cs_type(backend)
        for i in range(15):
            assert await db.get(b"pre%02d" % i) == b"v%d" % i
        assert await db.get(b"post") == b"alive"
        old_team = set(c.shard_map.team_for_key(b"a"))
        new_team = sorted(set(range(4)) - old_team)[:1] + sorted(old_team)[:1]
        await move_keys(c, KeyRange(b"", b"m"), new_team, c.move_keys_lock)
        assert await db.get(b"pre00") == b"v0"
        await delay(1.0)
        cc = ConsistencyCheckWorkload(c)
        assert await cc.check(), cc.failures
        c.stop()

    psim.run(main())


def test_sharded_recovery_aborts_inflight_commits(psim, backend):
    """A commit in flight across the kill is reported committed only if
    it is durable in the new generation's log prefix."""

    async def main():
        c = rsc(n_storage=3, n_logs=2, replication="double",
                shard_boundaries=[]).start()
        db = c.database()
        await db.set(b"seed", b"1")
        outcomes = []

        async def writer(i):
            tr = db.create_transaction()
            tr.options.set_retry_limit(0)
            tr.set(b"w%02d" % i, b"x")
            try:
                await tr.commit()
                outcomes.append((i, "committed"))
            except FdbError as e:
                outcomes.append((i, e.name))

        ws = [spawn(writer(i)) for i in range(10)]
        await delay(0.001)
        c.kill_transaction_system()
        c.start_controller("cc0")
        for w in ws:
            await w.done
        await delay(1.0)
        for i, outcome in outcomes:
            if outcome == "committed":
                assert await db.get(b"w%02d" % i) == b"x", (i, outcomes)
        c.stop()

    psim.run(main())


def test_sharded_recovery_quorum_truncation_keeps_replicas_consistent(
        backend):
    """With buggify'd fsync delays a commit can be durable on one log but
    not another at kill time: epoch end truncates every log to the quorum
    minimum and rolls back storages past it, so team replicas agree."""
    for seed in (3, 9, 31):
        loop = sim_loop(seed=seed, buggify=True)
        with loop_context(loop):
            async def main():
                c = rsc(n_storage=4, n_logs=2, replication="double",
                        shard_boundaries=[b"m"]).start()
                c.start_controller("cc0")
                db = c.database()
                stop = [False]

                async def writer(i):
                    n = 0
                    while not stop[0]:
                        try:
                            await db.set(b"w%d/%02d" % (i, n % 20), b"%d" % n)
                        except BaseException:  # noqa: BLE001 — retried next
                            pass
                        n += 1

                ws = [spawn(writer(i)) for i in range(3)]
                await delay(0.5)
                c.kill_transaction_system()  # mid-fsync for some batch
                await delay(3.0)             # controller recovers
                stop[0] = True
                for w in ws:
                    await w.done
                await delay(1.5)             # replicas drain the new chain
                cc = ConsistencyCheckWorkload(c)
                ok = await cc.check()
                assert ok, (seed, cc.failures)
                assert c.generation >= 2
                c.stop()

            loop.run(main(), timeout_sim_seconds=600)
        loop.shutdown()


def test_recovery_discards_phantom_metadata(psim, backend):
    """A \\xff effect applied to the config caches whose push never became
    durable does not survive recovery: the caches are re-derived from
    durable state."""
    from foundationdb_tpu_torch.cluster.interfaces import Mutation
    from foundationdb_tpu_torch.cluster.management import (
        exclude_servers,
        get_excluded_servers,
    )
    from foundationdb_tpu_torch.cluster.system_data import (
        excluded_server_key,
    )
    from foundationdb_tpu_torch.kv.atomic import MutationType

    async def main():
        c = rsc(n_storage=4, n_logs=2, replication="double",
                shard_boundaries=[b"m"]).start()
        db = c.database()
        await exclude_servers(db, [3])
        await db.set(b"k", b"v")
        inner = c.inner
        assert 3 in inner.excluded
        inner._apply_metadata(
            Mutation(MutationType.SET_VALUE, excluded_server_key(2), b""),
            version=inner.metadata_version + 1,
        )
        assert 2 in inner.excluded
        c.kill_transaction_system()
        c.start_controller("cc0")
        await db.set(b"post", b"alive")
        for _ in range(200):  # the rebuild task runs async after recovery
            if 2 not in inner.excluded:
                break
            await delay(0.05)
        assert 2 not in inner.excluded, "phantom exclusion survived recovery"
        assert 3 in inner.excluded, "durable exclusion lost by the rebuild"
        assert await get_excluded_servers(db) == {3}
        c.stop()

    psim.run(main())


# ------------------------------------------- tests/test_monitor_leader.py


def test_cluster_file_parse_roundtrip(tmp_path, psim):
    cf = ClusterFile.parse("mydb:abc123@coord0,coord1,coord2")
    assert cf.description == "mydb"
    assert cf.cluster_id == "abc123"
    assert cf.coordinators == ["coord0", "coord1", "coord2"]
    assert ClusterFile.parse(cf.to_text()) == cf
    path = str(tmp_path / "fdb.cluster")
    cf.save(path)
    assert ClusterFile.load(path) == cf
    with pytest.raises(ValueError):
        ClusterFile.parse("not a cluster string")
    with pytest.raises(ValueError):
        ClusterFile.parse("a:b@")

    async def main():
        cf2 = cf.change_coordinators(["c3", "c4", "c5"])
        assert cf2.coordinators == ["c3", "c4", "c5"]
        assert cf2.cluster_id != cf.cluster_id  # stale files detectable

    psim.run(main())


def test_discovery_based_client_follows_recoveries(psim, backend):
    """A client built from the coordinators alone finds the cluster and
    follows a recovery to the new generation."""

    async def main():
        c = rsc(n_storage=4, n_logs=2, replication="double",
                shard_boundaries=[b"m"]).start()
        db, mon = connect(c.coordinators)
        await delay(0.5)  # first poll lands
        await db.set(b"via-discovery", b"1")
        assert await db.get(b"via-discovery") == b"1"
        gen0 = c.generation
        c.kill_transaction_system()
        c.start_controller("cc0")
        await db.set(b"after-recovery", b"2")
        assert c.generation > gen0
        assert await db.get(b"via-discovery") == b"1"
        assert await db.get(b"after-recovery") == b"2"
        mon.cancel()
        c.stop()

    psim.run(main())


def test_quorum_blip_keeps_last_known_endpoints(psim, backend):
    async def main():
        c = rsc(n_storage=3, n_logs=2, replication="double",
                shard_boundaries=[]).start()
        db, mon = connect(c.coordinators)
        await delay(0.5)
        await db.set(b"k", b"v")
        # Majority of coordinators down: discovery cannot read, but the
        # last-known endpoints keep serving.
        for coord in c.coordinators[:2]:
            coord.available = False
        await delay(1.0)
        assert await db.get(b"k") == b"v"
        for coord in c.coordinators[:2]:
            coord.available = True
        mon.cancel()
        c.stop()

    psim.run(main())


# ------------------------------- tests/test_conflict_factory.py, port names


def test_factory_selects_each_impl():
    assert KNOWN_CONFLICT_SET_IMPLS == ("gpu", "native", "oracle")
    assert isinstance(make_conflict_set(0, impl="oracle"), ConflictSetCPU)
    cs = make_conflict_set(0, impl="gpu", device="cpu")
    assert isinstance(cs, ConflictSetGPU) and cs.device.type == "cpu"
    assert isinstance(make_conflict_set(0, impl="GPU", device="cpu"),
                      ConflictSetGPU)


def test_factory_recruits_native(monkeypatch):
    """The name "native" (the JAX package's default) recruits the port's
    C++ conflict detector, by argument and by the knob, at init_version."""
    from foundationdb_tpu_torch.resolver.native_cpu import (
        ConflictSetNativeCPU,
    )

    assert validate_conflict_set_impl("Native") == "native"
    cs = make_conflict_set(5, impl="native")
    assert isinstance(cs, ConflictSetNativeCPU) and cs.entries() == [(b"", 5)]
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "native")
    assert isinstance(make_conflict_set(0), ConflictSetNativeCPU)


@pytest.mark.parametrize("bad", ["tpu", "skiplist", ""])
def test_factory_refuses_jax_backends_and_typos(bad, monkeypatch):
    with pytest.raises(ValueError, match="gpu\\|native\\|oracle"):
        validate_conflict_set_impl(bad)
    with pytest.raises(ValueError):
        make_conflict_set(0, impl=bad, device="cpu")
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", bad)
    with pytest.raises(ValueError):
        make_conflict_set(0, device="cpu")


def test_factory_reads_knob(monkeypatch):
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "oracle")
    assert validate_conflict_set_impl() == "oracle"
    assert isinstance(make_conflict_set(7), ConflictSetCPU)
    assert make_conflict_set(7).entries() == [(b"", 7)]
    monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "gpu")
    cs = make_conflict_set(7, device="cpu")
    assert isinstance(cs, ConflictSetGPU) and cs.entries() == [(b"", 7)]


def test_default_recruits_the_card(monkeypatch):
    """The port's default is the card's conflict set, and without a card
    the default recruitment raises: nothing falls back to the CPU."""
    import torch

    assert SERVER_KNOBS.CONFLICT_SET_IMPL == "gpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_conflict_set(0)


def test_recoverable_cluster_commits_through_factory(backend):
    """A recovery-capable cluster whose resolver is recruited by the knob
    commits and detects a lost-update conflict on every back end."""
    loop = sim_loop(seed=31)
    with loop_context(loop):
        c = RecoverableCluster(device="cpu").start()
        db = c.database()

        async def main():
            assert type(c.resolver.cs) is cs_type(backend)
            await db.set(b"k", b"v1")
            assert await db.get(b"k") == b"v1"
            tr1 = db.create_transaction()
            tr2 = db.create_transaction()
            assert await tr1.get(b"k") == b"v1"
            assert await tr2.get(b"k") == b"v1"
            tr1.set(b"k", b"t1")
            tr2.set(b"k", b"t2")
            await tr1.commit()
            with pytest.raises(NotCommitted):
                await tr2.commit()
            c.stop()

        loop.run(main(), timeout_sim_seconds=1e5)
    loop.shutdown()


# ------------------------------------------------------ the port's own


def test_dead_generation_conflict_set_is_collected(backend):
    """After a recovery, nothing holds the dead generation's conflict set
    (its state tensors and in-flight handles go with it)."""
    loop = sim_loop(seed=8)
    with loop_context(loop):
        rc = RecoverableCluster(device="cpu").start()
        rc.start_controller("cc0")
        db = rc.database()

        async def main():
            refs = []
            for i in range(3):
                await db.set(b"k%d" % i, b"v")
                refs.append(weakref.ref(rc.resolver.cs))
                rc.kill_transaction_system()
            await db.set(b"after", b"v")
            gc.collect()
            alive = [r() is not None for r in refs]
            assert type(rc.resolver.cs) is cs_type(backend)
            rc.stop()
            return alive

        alive = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    assert alive == [False, False, False]


def test_without_a_card_it_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecoverableCluster()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RecoverableShardedCluster(n_resolvers=4)


# ------------------------------------ same-seed differential vs the JAX package

NODES = 16


def cycle_key(i: int) -> bytes:
    return b"cycle/" + struct.pack(">I", i)


def _recovery_run(pkg: str, seed: int):
    """Cycle on one package's RecoverableCluster under its own
    sim_loop(seed) with a fresh trace sink, two controllers and two kills
    of the transaction system; then a keyspace dump."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    rt, tr = mod("core.runtime"), mod("core.trace")
    port = pkg == "foundationdb_tpu_torch"
    sink = tr.TraceSink()
    old_sink = tr.global_sink()
    tr.set_global_sink(sink)
    loop = rt.sim_loop(seed=seed)
    try:
        with rt.loop_context(loop):
            rc = mod("cluster.recovery").RecoverableCluster(
                **({"device": "cpu"} if port else {})).start()
            rc.start_controller("cc0")
            rc.start_controller("cc1")
            db = rc.database()

            async def main():
                cyc = mod("workloads.cycle").CycleWorkload(db, nodes=NODES)
                await cyc.setup()
                work = rt.spawn(cyc.start(clients=4, txns_per_client=8),
                                name="cycle")

                async def killer():
                    await rt.current_loop().delay(0.3)
                    rc.kill_transaction_system()
                    await rt.current_loop().delay(1.5)
                    rc.kill_transaction_system()

                k = rt.spawn(killer(), name="killer")
                await work.done
                await k.done
                ok = await cyc.check()

                async def dump(t):
                    return await t.get_range(b"", b"\xff")

                rows = await db.transact(dump)
                rc.stop()
                return ok, cyc.retries, cyc.txns_done, rows

            out = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
    finally:
        tr.set_global_sink(old_sink)
    digest = hashlib.sha256("\n".join(
        json.dumps(e, sort_keys=True, default=str) for e in sink.events
    ).encode()).hexdigest()
    return {"result": out, "generation": rc.generation,
            "recoveries": rc.recoveries_done,
            "digest": digest, "events": len(sink.events)}


@pytest.mark.parametrize("backend_pair", ["oracle", "device"])
def test_same_seed_differential_against_jax_package(backend_pair,
                                                    monkeypatch):
    from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS

    if backend_pair == "oracle":
        for knobs, cs, window in ((JKNOBS, "oracle", "memory"),
                                  (SERVER_KNOBS, "oracle", "memory")):
            monkeypatch.setattr(knobs, "CONFLICT_SET_IMPL", cs)
            monkeypatch.setattr(knobs, "STORAGE_ENGINE_IMPL", window)
    else:
        monkeypatch.setattr(JKNOBS, "CONFLICT_SET_IMPL", "tpu")
        monkeypatch.setattr(JKNOBS, "STORAGE_ENGINE_IMPL", "tpu")
        monkeypatch.setattr(JKNOBS, "TPU_PROBE_KERNEL", "pallas")
        # The port's pipelined resolver role does not yield before its
        # readback, so it keeps the synchronous path's schedule (a seed's
        # device and host backends replay alike); the JAX package's role
        # yields there, so its device side runs the synchronous path.
        monkeypatch.setattr(JKNOBS, "TPU_PIPELINE_DEPTH", 1)
        monkeypatch.setattr(SERVER_KNOBS, "CONFLICT_SET_IMPL", "gpu")
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "gpu")
    want = _recovery_run("foundationdb_tpu", seed=21)
    got = _recovery_run("foundationdb_tpu_torch", seed=21)
    ok, retries, done, rows = got["result"]
    assert ok and retries > 0 and done == 32 and rows
    assert got["generation"] >= 3 and got["recoveries"] >= 3
    for key in ("result", "generation", "recoveries", "digest", "events"):
        assert got[key] == want[key], key
