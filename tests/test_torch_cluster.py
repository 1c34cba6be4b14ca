"""The port's transaction system: LocalCluster with ConflictSetGPU as its
resolver and KeyValueStoreGPU as its storage window, on the CPU.

- every case of tests/test_cluster.py against the port's LocalCluster,
  once on the oracle backends (ConflictSetCPU + the VersionedMap window)
  and once on the device backends run on the CPU (ConflictSetGPU +
  KeyValueStoreGPU, device="cpu");
- a same-seed differential against the JAX package: its LocalCluster and
  the port's, each under its own sim_loop(seed), run the same Cycle and
  ReadWrite and must give identical check results, retries, conflict
  counts, final keyspace and trace digest (oracles on both sides; and
  ConflictSetTPU + KeyValueStoreTPU with the Pallas probe in interpret
  mode against the port's device backends);
- the role-level cases of tests/test_pipeline.py that need no sharding,
  on ConflictSetGPU;
- the LocalCluster twin of test_read_batcher_coalesces_on_sim_cluster;
- LocalCluster() without a card raises.
"""

import hashlib
import importlib
import json
import struct

import numpy as np
import pytest

from foundationdb_tpu_torch.client.transaction import Transaction
from foundationdb_tpu_torch.cluster import LocalCluster
from foundationdb_tpu_torch.core.errors import NotCommitted, TransactionTooOld
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop, spawn
from foundationdb_tpu_torch.kv.atomic import MutationType
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo
from foundationdb_tpu_torch.storage_engine.gpu_engine import KeyValueStoreGPU
from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

BACKENDS = ("oracle", "device")


@pytest.fixture
def knob(monkeypatch):
    """Set a knob of the port; the port's knobs are restored after the
    test."""
    def set_knob(name, value):
        monkeypatch.setattr(SERVER_KNOBS, name, value)

    return set_knob


def make_cs(backend: str):
    """The conflict set of a backend, setting the storage knob to match."""
    if backend == "oracle":
        SERVER_KNOBS.STORAGE_ENGINE_IMPL = "memory"
        return ConflictSetCPU()
    SERVER_KNOBS.STORAGE_ENGINE_IMPL = "gpu"
    return ConflictSetGPU(max_key_bytes=16, initial_capacity=64, device="cpu")


@pytest.fixture(params=BACKENDS)
def backend(request, knob):
    knob("STORAGE_ENGINE_IMPL", SERVER_KNOBS.STORAGE_ENGINE_IMPL)
    return request.param


def run_sim(main_coro_factory, backend, seed=1, buggify=False, timeout=1e6):
    loop = sim_loop(seed=seed, buggify=buggify)
    with loop_context(loop):
        cluster = LocalCluster(make_cs(backend), device="cpu").start()
        db = cluster.database()

        async def main():
            try:
                return await main_coro_factory(db)
            finally:
                cluster.stop()

        out = loop.run(main(), timeout_sim_seconds=timeout)
    loop.shutdown()
    return out, loop


# ------------------------------------------------ tests/test_cluster.py


def test_set_get_commit(backend):
    async def main(db):
        await db.set(b"hello", b"world")
        assert await db.get(b"hello") == b"world"
        assert await db.get(b"missing") is None
        await db.clear(b"hello")
        assert await db.get(b"hello") is None

    run_sim(main, backend)


def test_read_your_writes_and_ranges(backend):
    async def main(db):
        async def setup(tr: Transaction):
            for i in range(5):
                tr.set(b"k%d" % i, b"v%d" % i)

        await db.transact(setup)

        async def body(tr: Transaction):
            tr.set(b"k1", b"NEW")
            assert await tr.get(b"k1") == b"NEW"
            tr.clear_range(b"k3", b"k5")
            assert await tr.get(b"k3") is None
            rows = await tr.get_range(b"k0", b"k9")
            assert rows == [(b"k0", b"v0"), (b"k1", b"NEW"), (b"k2", b"v2")]
            rows = await tr.get_range(b"k0", b"k9", limit=2, reverse=True)
            assert rows == [(b"k2", b"v2"), (b"k1", b"NEW")]

        await db.transact(body)
        assert await db.get(b"k1") == b"NEW"
        assert await db.get(b"k4") is None

    run_sim(main, backend)


def test_atomic_ops(backend):
    async def main(db):
        async def body(tr: Transaction):
            tr.add(b"ctr", (5).to_bytes(8, "little"))
            tr.add(b"ctr", (7).to_bytes(8, "little"))
            assert int.from_bytes(await tr.get(b"ctr"), "little") == 12

        await db.transact(body)
        assert int.from_bytes(await db.get(b"ctr"), "little") == 12

        async def body2(tr: Transaction):
            tr.add(b"ctr", (100).to_bytes(8, "little"))
            tr.atomic_op(MutationType.BYTE_MAX, b"m", b"beta")
            tr.atomic_op(MutationType.BYTE_MAX, b"m", b"alpha")

        await db.transact(body2)
        assert int.from_bytes(await db.get(b"ctr"), "little") == 112
        assert await db.get(b"m") == b"beta"

    run_sim(main, backend)


def test_conflicting_transactions(backend):
    async def main(db):
        await db.set(b"x", b"0")
        tr1 = db.create_transaction()
        tr2 = db.create_transaction()
        assert await tr1.get(b"x") == b"0"
        assert await tr2.get(b"x") == b"0"
        tr1.set(b"x", b"1")
        tr2.set(b"x", b"2")
        v1 = await tr1.commit()
        assert v1 > 0
        with pytest.raises(NotCommitted):
            await tr2.commit()
        await tr2.on_error(NotCommitted())
        assert await tr2.get(b"x") == b"1"
        tr2.set(b"x", b"2")
        await tr2.commit()
        assert await db.get(b"x") == b"2"

    run_sim(main, backend)


def test_snapshot_reads_do_not_conflict(backend):
    async def main(db):
        await db.set(b"x", b"0")
        tr1 = db.create_transaction()
        tr2 = db.create_transaction()
        assert await tr1.get(b"x", snapshot=True) == b"0"
        assert await tr2.get(b"x") == b"0"
        tr1.set(b"y", b"1")
        tr2.set(b"x", b"1")
        await tr2.commit()
        await tr1.commit()

    run_sim(main, backend)


def test_transaction_too_old(backend):
    async def main(db):
        from foundationdb_tpu_torch.core.runtime import current_loop

        await db.set(b"x", b"0")
        await current_loop().delay(8.0)
        await db.set(b"x", b"1")
        await current_loop().delay(8.0)
        await db.set(b"x", b"2")
        await current_loop().delay(0.5)
        tr = db.create_transaction()
        tr.set_read_version(1)
        with pytest.raises(TransactionTooOld):
            await tr.get(b"x")

    run_sim(main, backend)


def test_watch_fires_on_change(backend):
    async def main(db):
        await db.set(b"w", b"a")
        tr = db.create_transaction()
        assert await tr.get(b"w") == b"a"
        watch = tr.watch(b"w")
        await tr.commit()

        async def writer():
            from foundationdb_tpu_torch.core.runtime import current_loop

            await current_loop().delay(0.5)
            await db.set(b"w", b"b")

        w = spawn(writer(), name="watch_writer")
        changed_at = await watch.wait()
        assert changed_at > 0
        await w.done
        assert await db.get(b"w") == b"b"

    run_sim(main, backend)


def test_watch_registered_mid_arm_is_not_dropped(backend):
    async def main(db):
        from foundationdb_tpu_torch.core.runtime import current_loop

        await db.set(b"w1", b"a")
        await db.set(b"w2", b"a")
        tr = db.create_transaction()
        tr.set(b"t", b"1")
        tr.watch(b"w1")
        real_get = tr.get
        mid_arm = []

        async def get_hook(key, **kw):
            if not mid_arm:
                mid_arm.append(tr.watch(b"w2"))
            return await real_get(key, **kw)

        tr.get = get_hook
        await tr.commit()
        assert mid_arm, "arming read never went through the hook"

        async def writer():
            await current_loop().delay(0.5)
            await db.set(b"w2", b"b")

        w = spawn(writer(), name="mid_arm_writer")
        assert await mid_arm[0].wait() > 0
        await w.done

    run_sim(main, backend)


def test_cycle_workload_invariant(backend):
    async def main(db):
        wl = CycleWorkload(db, nodes=12)
        await wl.setup()
        await wl.start(clients=5, txns_per_client=20)
        assert wl.txns_done == 100
        assert await wl.check()
        return wl.retries, db.cluster.resolver.conflict_transactions

    (retries, conflicts), _ = run_sim(main, backend, seed=7)
    # Concurrent clients on 12 nodes must produce real OCC conflicts,
    # detected by this backend's conflict set.
    assert retries > 0
    assert conflicts > 0


def test_cycle_workload_deterministic(backend):
    def one(seed):
        async def main(db):
            wl = CycleWorkload(db, nodes=10)
            await wl.setup()
            await wl.start(clients=3, txns_per_client=10)
            ok = await wl.check()
            return (ok, wl.retries, db.cluster.master.version)

        result, loop = run_sim(main, backend, seed=seed)
        return result, loop.tasks_run

    a1 = one(42)
    a2 = one(42)
    b = one(43)
    assert a1 == a2, "same seed must replay identically"
    assert a1[0][0] and b[0][0]
    assert a1 != b, "different seed should explore a different interleaving"


def test_key_width_growth_and_pipeline_survival(backend):
    """Keys beyond the resolver's initial packed width commit fine, and an
    internal resolver failure fails only its own batch."""
    from foundationdb_tpu_torch.core.errors import OperationFailed

    loop = sim_loop(seed=3)
    with loop_context(loop):
        cs = make_cs(backend)
        cluster = LocalCluster(conflict_set=cs, device="cpu").start()
        db = cluster.database()

        async def main():
            await db.set(b"x" * 40, b"v")
            if backend == "device":
                assert cs.max_key_bytes >= 40  # width growth

            # One injected failure on the path this backend takes: the
            # pipelined role dispatches via submit, the sync role via
            # resolve (the oracle has no submit, and must not gain one).
            names = ("resolve", "submit") if backend == "device" else (
                "resolve",)
            real = {n: getattr(cs, n) for n in names}

            def boom(*a, **kw):
                for n, f in real.items():
                    setattr(cs, n, f)
                raise RuntimeError("injected resolver failure")

            for n in names:
                setattr(cs, n, boom)
            with pytest.raises(OperationFailed):
                await db.set(b"victim", b"v")
            await db.set(b"alive", b"yes")
            assert await db.get(b"alive") == b"yes"
            assert await db.get(b"x" * 40) == b"v"
            cluster.stop()

        loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()


def test_clear_of_max_size_key(backend):
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS

    async def main(db):
        big = b"k" * CLIENT_KNOBS.KEY_SIZE_LIMIT
        await db.set(big, b"v")
        assert await db.get(big) == b"v"
        await db.clear(big)
        assert await db.get(big) is None

    run_sim(main, backend)


def test_reset_cancels_pending_watches(backend):
    from foundationdb_tpu_torch.core.errors import TransactionCancelled

    async def main(db):
        await db.set(b"w", b"a")
        tr = db.create_transaction()
        assert await tr.get(b"w") == b"a"
        watch = tr.watch(b"w")
        tr.reset()
        with pytest.raises(TransactionCancelled):
            await watch.wait()

    run_sim(main, backend)


# ------------------------------------- same-seed differential vs the JAX package


def _cluster_run(pkg: str, backend: str, seed: int):
    """Cycle + ReadWrite + a final keyspace dump on one package's
    LocalCluster under its own sim_loop(seed), with a fresh trace sink.
    Returns everything the two packages must agree on."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    rt, tr = mod("core.runtime"), mod("core.trace")
    port = pkg == "foundationdb_tpu_torch"
    if backend == "oracle":
        cs = mod("resolver.cpu").ConflictSetCPU()
    elif port:
        cs = ConflictSetGPU(max_key_bytes=16, initial_capacity=64,
                            device="cpu")
    else:
        cs = mod("resolver.tpu").ConflictSetTPU(max_key_bytes=16,
                                                initial_capacity=64)
    sink = tr.TraceSink()
    old_sink = tr.global_sink()
    tr.set_global_sink(sink)
    loop = rt.sim_loop(seed=seed)
    try:
        with rt.loop_context(loop):
            cluster = mod("cluster").LocalCluster(
                conflict_set=cs, **({"device": "cpu"} if port else {}))
            cluster.start()
            db = cluster.database()

            async def main():
                cyc = mod("workloads.cycle").CycleWorkload(db, nodes=12)
                await cyc.setup()
                await cyc.start(clients=4, txns_per_client=6)
                ok = await cyc.check()
                rw = mod("workloads.read_write").ReadWriteWorkload(
                    db, key_space=50)
                await rw.run(clients=4, duration=0.05)

                async def dump(t):
                    return await t.get_range(b"", b"\xff")

                rows = await db.transact(dump)
                cluster.stop()
                return (ok, cyc.retries, cyc.txns_done, rw.txns_done,
                        rw.retries, rows)

            out = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
    finally:
        tr.set_global_sink(old_sink)
    digest = hashlib.sha256("\n".join(
        json.dumps(e, sort_keys=True, default=str) for e in sink.events
    ).encode()).hexdigest()
    return {"result": out, "conflicts": cluster.resolver.conflict_transactions,
            "engine": type(cluster.storage.data).__name__,
            "digest": digest, "events": len(sink.events)}


@pytest.mark.parametrize("backend_pair", ["oracle", "device"])
def test_same_seed_differential_against_jax_package(backend_pair,
                                                    monkeypatch):
    from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS

    if backend_pair == "oracle":
        monkeypatch.setattr(JKNOBS, "STORAGE_ENGINE_IMPL", "memory")
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "memory")
    else:
        monkeypatch.setattr(JKNOBS, "STORAGE_ENGINE_IMPL", "tpu")
        monkeypatch.setattr(JKNOBS, "TPU_PROBE_KERNEL", "pallas")
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "gpu")
    want = _cluster_run("foundationdb_tpu", backend_pair, seed=11)
    got = _cluster_run("foundationdb_tpu_torch", backend_pair, seed=11)
    ok, retries = got["result"][:2]
    assert ok and retries > 0 and got["conflicts"] > 0
    assert got["result"][-1], "the keyspace dump is empty"
    assert got["engine"] == ("VersionedMap" if backend_pair == "oracle"
                             else "KeyValueStoreGPU")
    for key in ("result", "conflicts", "digest", "events"):
        assert got[key] == want[key], key


# ------------------------------ role-level cases of tests/test_pipeline.py


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def random_batch(rng, n, version, key_space=400, lag=300):
    txns = []
    for _ in range(n):
        rr = [
            KeyRange(k8(a), k8(a + int(rng.integers(1, 8))))
            for a in map(int, rng.integers(0, key_space, rng.integers(0, 4)))
        ]
        wr = [
            KeyRange(k8(a), k8(a + 1))
            for a in map(int, rng.integers(0, key_space, rng.integers(0, 3)))
        ]
        txns.append(TxnConflictInfo(version - int(rng.integers(0, lag)), rr,
                                    wr))
    return txns


def gen_windows(seed, n_batches=10, batch=40):
    rng = np.random.default_rng(seed)
    windows = []
    v = 1000
    for _ in range(n_batches):
        v += 100
        windows.append((v, random_batch(rng, batch, v)))
    return windows


def sync_reference(windows):
    cpu = ConflictSetCPU()
    return [cpu.resolve(v, v - 600, t).statuses for v, t in windows]


def test_role_pipeline_depth_measured(knob):
    """Concurrent windows through the ResolverRole on ConflictSetGPU, with
    verdicts equal to the oracle and replies in commit-version order. The
    port's role does not yield between a window's dispatch and its
    readback (the JAX package's does, and measures depth >= 3 here): each
    window keeps the synchronous path's schedule, so the measured
    in-flight depth is exactly 1."""
    from foundationdb_tpu_torch.cluster.interfaces import (
        ResolveTransactionBatchRequest,
    )
    from foundationdb_tpu_torch.cluster.resolver_role import ResolverRole
    from foundationdb_tpu_torch.core.actors import all_of
    from foundationdb_tpu_torch.core.runtime import TaskPriority

    knob("TPU_PIPELINE_DEPTH", 4)
    windows = gen_windows(9, n_batches=8, batch=30)
    expected = sync_reference(windows)

    loop = sim_loop(seed=5)
    with loop_context(loop):
        cs = ConflictSetGPU(max_key_bytes=8, initial_capacity=64,
                            device="cpu")
        role = ResolverRole(cs, init_version=1000)
        reply_order = []

        async def one(prev, v, txns):
            req = ResolveTransactionBatchRequest(
                prev_version=prev, version=v,
                last_receive_version=prev, transactions=txns,
            )
            res = await role.resolve_batch(req)
            reply_order.append(v)
            return res.statuses

        async def main():
            prev = 1000
            tasks = []
            for v, txns in windows:
                tasks.append(spawn(one(prev, v, txns), TaskPriority.RESOLVER,
                                   name=f"w{v}"))
                prev = v
            return await all_of([t.done for t in tasks])

        results = loop.run(main(), timeout_sim_seconds=1e5)
    loop.shutdown()
    assert [list(map(int, r)) for r in results] == expected
    assert reply_order == sorted(reply_order)
    assert role.max_inflight == 1, role.max_inflight
    assert cs.max_inflight == 1, cs.max_inflight
    ps = role.pipeline_status()
    assert ps["max_in_flight_measured"] == 1
    assert ps["stages"]["pack_ms"]["samples"] >= 8
    assert ps["stages"]["device_ms"]["p50"] is not None


def test_role_wire_batches_and_sync_path_parity(knob):
    """Wire-encoded requests through the role on ConflictSetGPU match the
    oracle, pipelined and synchronous (depth 1)."""
    from foundationdb_tpu_torch.cluster.interfaces import (
        ResolveTransactionBatchRequest,
    )
    from foundationdb_tpu_torch.cluster.resolver_role import ResolverRole
    from foundationdb_tpu_torch.resolver.wire import WireBatch

    windows = gen_windows(21, n_batches=4, batch=25)
    expected = sync_reference(windows)

    for depth in (1, 3):
        knob("TPU_PIPELINE_DEPTH", depth)
        loop = sim_loop(seed=6)
        with loop_context(loop):
            cs = ConflictSetGPU(max_key_bytes=8, initial_capacity=64,
                                device="cpu")
            role = ResolverRole(cs, init_version=1000)

            async def main():
                out = []
                prev = 1000
                for v, txns in windows:
                    req = ResolveTransactionBatchRequest(
                        prev_version=prev, version=v,
                        last_receive_version=prev, transactions=[],
                        wire=WireBatch.from_txns(txns).to_bytes(),
                    )
                    out.append((await role.resolve_batch(req)).statuses)
                    prev = v
                return out

            got = loop.run(main(), timeout_sim_seconds=1e5)
        loop.shutdown()
        assert [list(map(int, r)) for r in got] == expected, f"depth {depth}"
        assert role.total_transactions == sum(len(t) for _, t in windows)
        assert role.keys_resolved > 0


def test_role_parked_dispatch_refuses_superseded_window(knob):
    """A dispatch parked at the depth gate re-checks the version chain
    when it wakes, and refuses a window a skip_window superseded; the
    conflict set (here a ConflictSetGPU that must stay untouched) never
    sees it."""
    from foundationdb_tpu_torch.cluster.interfaces import (
        ResolveTransactionBatchRequest,
    )
    from foundationdb_tpu_torch.cluster.resolver_role import ResolverRole
    from foundationdb_tpu_torch.core.errors import OperationFailed
    from foundationdb_tpu_torch.core.runtime import current_loop

    class RefusingGPU(ConflictSetGPU):
        def submit(self, version, new_oldest, batch):
            raise AssertionError("superseded window must not dispatch")

        def verdicts(self, handle):
            raise AssertionError("nothing was submitted")

    knob("TPU_PIPELINE_DEPTH", 2)
    loop = sim_loop(seed=9)
    with loop_context(loop):
        role = ResolverRole(RefusingGPU(max_key_bytes=8, initial_capacity=64,
                                        device="cpu"), init_version=0)
        role._inflight_q.extend([10, 20])
        role.version.set(20)

        async def main():
            req = ResolveTransactionBatchRequest(
                prev_version=20, version=30,
                last_receive_version=20, transactions=[],
            )
            dispatch = spawn(role.resolve_batch(req), name="parked_w30")
            await current_loop().delay(0.1)
            skip = spawn(role.skip_window(20, 30), name="skip_w30")
            await current_loop().delay(0.1)
            role._inflight_q.popleft()
            role._consumed.set(10)
            with pytest.raises(OperationFailed, match="depth gate"):
                await dispatch.done
            role._inflight_q.popleft()
            role._consumed.set(20)
            await skip.done
            assert role.version.get() == 30
            assert role._consumed.get() == 30

        loop.run(main(), timeout_sim_seconds=1e5)
    loop.shutdown()
    assert role.cs.entries() == ConflictSetCPU(0).entries()  # untouched



@pytest.mark.parametrize("first", ["skip", "window"])
def test_role_skip_window_against_a_waiting_window(knob, first):
    """A proxy's skip_window(P, V) and the lost request for (P, V] both
    wait on the chain at P. Whichever waited first moves the chain at P;
    the other finds it moved (the window is refused, the skip is a
    no-op). The pipelined role on ConflictSetGPU ends with the same
    verdicts and the same conflict set as the synchronous role on the
    oracle: a refused window merges nothing."""
    from foundationdb_tpu_torch.cluster.interfaces import (
        ResolveTransactionBatchRequest,
    )
    from foundationdb_tpu_torch.cluster.resolver_role import ResolverRole
    from foundationdb_tpu_torch.core.errors import OperationFailed
    from foundationdb_tpu_torch.core.runtime import current_loop

    (v1, t1), (v2, t2), (v3, t3) = gen_windows(31, n_batches=3, batch=30)

    def run(cs, depth):
        knob("TPU_PIPELINE_DEPTH", depth)
        loop = sim_loop(seed=12)
        with loop_context(loop):
            role = ResolverRole(cs, init_version=1000)

            def request(prev, v, txns):
                return role.resolve_batch(ResolveTransactionBatchRequest(
                    prev_version=prev, version=v,
                    last_receive_version=prev, transactions=txns))

            async def refused(prev, v, txns):
                try:
                    await request(prev, v, txns)
                except OperationFailed:
                    return None
                raise AssertionError(f"window ({prev}, {v}] not refused")

            async def main():
                if first == "skip":
                    skip = spawn(role.skip_window(v1, v2), name="skip")
                    await current_loop().delay(0.1)
                    lost = spawn(refused(v1, v2, t2), name="lost")
                else:
                    lost = spawn(request(v1, v2, t2), name="lost")
                    await current_loop().delay(0.1)
                    skip = spawn(role.skip_window(v1, v2), name="skip")
                await current_loop().delay(0.1)
                got = [await request(1000, v1, t1)]
                got.append(await lost.done)
                await skip.done
                got.append(await request(v2, v3, t3))
                assert role.version.get() == role._consumed.get() == v3
                return [None if r is None else list(map(int, r.statuses))
                        for r in got]

            got = loop.run(main(), timeout_sim_seconds=1e5)
        loop.shutdown()
        return got, cs.entries()

    gpu = run(ConflictSetGPU(max_key_bytes=8, initial_capacity=64,
                             device="cpu"), 4)
    oracle = run(ConflictSetCPU(), 1)
    assert (gpu[0][1] is None) == (first == "skip")
    assert gpu == oracle

def test_status_json_pipeline_block(knob):
    """cluster_status() exposes the resolver's per-stage breakdown and
    depth on the port's LocalCluster with ConflictSetGPU."""
    from foundationdb_tpu_torch.cluster.status import cluster_status

    knob("STORAGE_ENGINE_IMPL", "gpu")
    loop = sim_loop(seed=8)
    with loop_context(loop):
        cs = ConflictSetGPU(max_key_bytes=16, initial_capacity=64,
                            device="cpu")
        cluster = LocalCluster(conflict_set=cs, device="cpu").start()
        db = cluster.database()

        async def main():
            for i in range(5):
                await db.set(b"k%d" % i, b"v")
            st = cluster_status(cluster)
            cluster.stop()
            return st

        st = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    res = [r for r in st["cluster"]["roles"] if r["role"] == "resolver"][0]
    pipe = res["pipeline"]
    assert set(pipe["stages"]) == {"pack_ms", "h2d_ms", "device_ms", "d2h_ms"}
    assert pipe["depth_configured"] == SERVER_KNOBS.TPU_PIPELINE_DEPTH
    assert pipe["stages"]["pack_ms"]["samples"] > 0
    assert res["conflict_set"] == "ConflictSetGPU"


# -------------------------------------------- storage role wiring (batcher)


def test_read_batcher_coalesces_on_local_cluster(knob):
    """Reads on the port's LocalCluster route through the storage role's
    batcher into KeyValueStoreGPU's fused dispatch, chosen by the knob;
    LocalCluster.start registers the engine's metrics."""
    from foundationdb_tpu_torch.core.metrics import global_registry

    knob("STORAGE_ENGINE_IMPL", "gpu")
    loop = sim_loop(seed=12345)
    with loop_context(loop):
        cluster = LocalCluster(device="cpu").start()
        assert isinstance(cluster.resolver.cs, ConflictSetGPU)
        eng = cluster.storage.data
        assert isinstance(eng, KeyValueStoreGPU)

        async def main():
            w = CycleWorkload(cluster.database(), nodes=8)
            await w.setup()
            await w.start(clients=3, txns_per_client=6)
            assert await w.check()
            snap = global_registry().snapshot()
            cluster.stop()
            return snap

        snap = loop.run(main(), timeout_sim_seconds=300)
    loop.shutdown()
    assert cluster.storage.read_batches > 0, "reads must route through the batcher"
    reads = eng.c_point_reads.total + eng.c_range_reads.total
    assert reads > 0, "reads must hit the fused device path"
    assert eng.c_batches.total == cluster.storage.read_batches
    names = json.dumps(snap, default=str)
    for name in ("storage.gpu.point_reads", "storage.gpu.batches",
                 "storage.gpu.last_dispatch_ms"):
        assert name in names, name


def test_local_cluster_without_a_card_raises(monkeypatch, knob):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    knob("STORAGE_ENGINE_IMPL", "gpu")
    loop = sim_loop(seed=1)
    with loop_context(loop):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalCluster()
        # the storage window alone, with the oracle as the resolver
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LocalCluster(conflict_set=ConflictSetCPU())
        # asked for the CPU, both device components run there
        c = LocalCluster(device="cpu")
        assert c.resolver.cs.device.type == "cpu"
        assert c.storage.data.device.type == "cpu"
    loop.shutdown()
