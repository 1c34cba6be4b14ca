"""The port's multi-role tier: ShardedKVCluster with four resolver roles,
replicated storage teams and tag-partitioned logs, on the CPU.

- every case of tests/test_sharded_cluster.py on the port's
  ShardedKVCluster(device="cpu"): each resolver role holds a
  ConflictSetGPU and each storage server a KeyValueStoreGPU window, both
  running their plain torch versions on the CPU;
- the first three cases of tests/test_multi_resolution.py (Cycle and a
  conflict across resolver boundaries, state-transaction retention on
  resolver 0, resolution balancing);
- a same-seed differential of Cycle on ShardedKVCluster(n_resolvers=4)
  with Cycle's keys split over the four resolvers and four storage
  shards: the JAX package's cluster and the port's, each under its own
  sim_loop(seed), must give identical check results, retries, conflict
  counts per resolver, final keyspace and trace digest (oracles on both
  sides; ConflictSetTPU + KeyValueStoreTPU with the Pallas probe in
  interpret mode, on the synchronous resolver path, against the port's
  device backends at their default pipeline depth).
"""

import hashlib
import importlib
import json
import struct

import pytest

from foundationdb_tpu_torch.client.load_balance import QueueModel, load_balance
from foundationdb_tpu_torch.cluster import sharded_cluster
from foundationdb_tpu_torch.cluster.interfaces import GetValueRequest, Mutation
from foundationdb_tpu_torch.cluster.log_system import (
    TaggedMutation,
    TagPartitionedLogSystem,
)
from foundationdb_tpu_torch.cluster.sharded_cluster import ShardedKVCluster
from foundationdb_tpu_torch.core import delay, loop_context, sim_loop, spawn
from foundationdb_tpu_torch.core.errors import NotCommitted, TLogStopped
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS
from foundationdb_tpu_torch.kv.atomic import MutationType
from foundationdb_tpu_torch.kv.keys import KeyRange
from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
from foundationdb_tpu_torch.storage_engine.gpu_engine import KeyValueStoreGPU
from foundationdb_tpu_torch.workloads.cycle import CycleWorkload


@pytest.fixture
def psim(monkeypatch):
    """A fresh deterministic port simulation loop, made current; the
    storage windows on the device backend (the port's default)."""
    monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "gpu")
    loop = sim_loop(seed=12345)
    with loop_context(loop):
        yield loop
    loop.shutdown()


def _set(k: bytes, v: bytes) -> Mutation:
    return Mutation(MutationType.SET_VALUE, k, v)


def _cluster(**kw):
    kw.setdefault("n_storage", 4)
    kw.setdefault("n_logs", 2)
    kw.setdefault("replication", "double")
    kw.setdefault("shard_boundaries", [b"g", b"n", b"t"])
    kw.setdefault("device", "cpu")
    return ShardedKVCluster(**kw)


def test_device_backends_on_every_role(psim):
    c = _cluster(n_resolvers=4, n_proxies=2, shard_boundaries=[b"m"])
    assert [type(r.cs) for r in c.resolvers] == [ConflictSetGPU] * 4
    assert all(r.cs.device.type == "cpu" for r in c.resolvers)
    assert [type(s.data) for s in c.storages] == [KeyValueStoreGPU] * 4
    assert c.resolver_config.boundaries == [b"\x40", b"\x80", b"\xc0"]


def test_without_a_card_it_raises(psim, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedKVCluster(n_resolvers=4)


# ------------------------------------------- tests/test_sharded_cluster.py


def test_tag_routing_and_per_tag_peek(psim):
    async def main():
        ls = TagPartitionedLogSystem(n_logs=2)
        v0, v1 = ls.tag_view(0), ls.tag_view(1)
        await ls.push(0, 10, [
            TaggedMutation((0,), _set(b"a", b"1")),
            TaggedMutation((1,), _set(b"b", b"2")),
            TaggedMutation((0, 1), _set(b"c", b"3")),
        ])
        e0 = await v0.peek(0)
        e1 = await v1.peek(0)
        assert [m.param1 for _, ms in e0 for m in ms] == [b"a", b"c"]
        assert [m.param1 for _, ms in e1 for m in ms] == [b"b", b"c"]
        assert all(log.version.get() == 10 for log in ls.logs)
        assert ls.durable_version() == 10

    psim.run(main())


def test_empty_versions_still_visible_to_every_tag(psim):
    async def main():
        ls = TagPartitionedLogSystem(n_logs=2)
        v1 = ls.tag_view(1)
        await ls.push(0, 5, [TaggedMutation((0,), _set(b"x", b"y"))])
        assert await v1.peek(0) == [(5, [])]

    psim.run(main())


def test_pop_waits_for_all_tags(psim):
    async def main():
        ls = TagPartitionedLogSystem(n_logs=1)
        va, vb = ls.tag_view(0), ls.tag_view(2)
        await ls.push(0, 7, [
            TaggedMutation((0,), _set(b"a", b"1")),
            TaggedMutation((2,), _set(b"b", b"2")),
        ])
        va.pop(7)
        assert len(ls.logs[0]._entries) == 1
        vb.pop(7)
        assert len(ls.logs[0]._entries) == 0

    psim.run(main())


def test_log_system_lock_fences_and_reports_min_durable(psim):
    async def main():
        ls = TagPartitionedLogSystem(n_logs=2)
        await ls.push(0, 3, [TaggedMutation((0,), _set(b"k", b"v"))])
        assert ls.lock(epoch=1) == 3
        with pytest.raises(TLogStopped):
            await ls.push(3, 4, [], epoch=0)

    psim.run(main())


def test_sharded_cluster_basic_rw(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        rows = [(b"apple", b"1"), (b"hat", b"2"), (b"pear", b"3"),
                (b"zebra", b"4")]
        for k, v in rows:
            await db.set(k, v)
        for k, v in rows:
            assert await db.get(k) == v

        async def body(tr):
            return await tr.get_range(b"", b"\xff")

        got = await db.transact(body)
        assert [k for k, _ in got] == [k for k, _ in rows]
        c.stop()

    psim.run(main())


def test_mutations_only_reach_team_members(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        await db.set(b"apple", b"1")
        await delay(1.0)
        team = c.shard_map.team_for_key(b"apple")
        assert len(team) == 2
        for s in c.storages:
            have = s.data.get(b"apple", s.version.get())
            assert have == (b"1" if s.tag in team else None), s.tag
        c.stop()

    psim.run(main())


def test_replicas_converge_identically(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        wl = CycleWorkload(db, nodes=24)
        await wl.setup()
        await wl.start(clients=4, txns_per_client=15)
        assert await wl.check()
        await delay(1.0)
        for begin, end, team in c.shard_map.ranges():
            if not team:
                continue
            end = end if end is not None else b"\xff\xff"
            views = [c.storages[t].data.get_range(
                begin, end, c.storages[t].version.get()) for t in team]
            assert all(v == views[0] for v in views[1:]), (begin, end)
        c.stop()

    psim.run(main())


def test_stale_location_cache_recovers_via_wrong_shard_server(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        await db.set(b"apple", b"1")
        assert await db.get(b"apple") == b"1"
        old_team = set(c.shard_map.team_for_key(b"apple"))
        new_team = [t for t in range(4) if t not in old_team][:2]
        assert len(new_team) == 2
        c.move_shard(KeyRange(b"", b"g"), new_team)
        assert await db.get(b"apple") == b"1"
        assert await db.get(b"banana") is None
        c.stop()

    psim.run(main())


def test_triple_replication_layout(psim):
    async def main():
        c = _cluster(replication="triple", n_storage=5).start()
        db = c.database()
        await db.set(b"k", b"v")
        await delay(0.5)
        assert len(c.shard_map.team_for_key(b"k")) == 3
        assert await db.get(b"k") == b"v"
        c.stop()

    psim.run(main())


def test_load_balance_hedges_to_healthy_replica(psim):
    class DeadEndpoint:
        def send(self, req):
            pass

    class LiveEndpoint:
        def __init__(self):
            self.hits = 0

        def send(self, req):
            self.hits += 1
            req.reply.send(b"value")

    async def main():
        qm = QueueModel()
        dead, live = DeadEndpoint(), LiveEndpoint()
        result = await load_balance(
            qm, [("dead", dead), ("live", live)],
            lambda: GetValueRequest(b"k", 1),
        )
        assert result == b"value"
        assert live.hits == 1
        assert qm.model("dead").failed_until == 0
        assert qm.model("dead").outstanding == 0

    psim.run(main())


def test_load_balance_prefers_low_latency_replica(psim):
    class SlowEndpoint:
        def __init__(self, d):
            self.d = d
            self.hits = 0

        def send(self, req):
            self.hits += 1

            async def answer():
                await delay(self.d)
                if not req.reply.is_set():
                    req.reply.send(b"v")

            spawn(answer())

    async def main():
        qm = QueueModel()
        fast, slow = SlowEndpoint(0.001), SlowEndpoint(0.2)
        for _ in range(30):
            await load_balance(qm, [("fast", fast), ("slow", slow)],
                               lambda: GetValueRequest(b"k", 1))
        assert fast.hits > slow.hits

    psim.run(main())


def test_cross_shard_reverse_range_and_limits(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        keys = [b"apple", b"hat", b"pear", b"zebra"]
        for i, k in enumerate(keys):
            await db.set(k, b"%d" % i)

        async def rev(tr):
            return await tr.get_range(b"", b"\xff", reverse=True)

        assert [k for k, _ in await db.transact(rev)] == keys[::-1]

        async def rev2(tr):
            return await tr.get_range(b"", b"\xff", limit=2, reverse=True)

        assert [k for k, _ in await db.transact(rev2)] == [b"zebra", b"pear"]

        async def fwd2(tr):
            return await tr.get_range(b"", b"\xff", limit=3)

        assert [k for k, _ in await db.transact(fwd2)] == keys[:3]
        c.stop()

    psim.run(main())


def test_watch_on_sharded_cluster_is_long_lived(psim):
    async def main():
        c = _cluster().start()
        db = c.database()
        await db.set(b"watched", b"v0")

        async def watcher():
            tr = db.create_transaction()
            assert await tr.get(b"watched") == b"v0"
            fut = tr.watch(b"watched")
            await tr.commit()
            await fut.wait()
            return "fired"

        w = spawn(watcher())
        await delay(8.0)  # > READ_TIMEOUT: the watch must still be pending
        assert not w.done.is_ready()
        await db.set(b"watched", b"v1")
        assert await w.done == "fired"
        c.stop()

    psim.run(main())


# ------------------------------- tests/test_multi_resolution.py, first three


def _multi(**kw):
    kw.setdefault("shard_boundaries", [b"m"])
    kw.setdefault("n_proxies", 2)
    kw.setdefault("n_resolvers", 4)
    return _cluster(**kw)


def test_cycle_and_conflicts_across_resolver_boundaries(psim):
    async def main():
        c = _multi().start()
        db = c.database()
        w = CycleWorkload(db, nodes=20)
        await w.setup()
        await w.start(clients=4, txns_per_client=20)
        assert await w.check()
        # A range read spanning the 0x80 boundary vs a write at 0x81.
        await db.set(b"\x7f/k", b"a")
        await db.set(b"\x81/k", b"b")
        tr1 = db.create_transaction()
        await tr1.get_range(b"\x7f", b"\x82")
        tr2 = db.create_transaction()
        tr2.set(b"\x81/k", b"c")
        await tr2.commit()
        tr1.set(b"outcome", b"should-not-commit")
        with pytest.raises(NotCommitted):
            await tr1.commit()
        assert await db.get(b"outcome") is None
        c.stop()

    psim.run(main())


def test_state_txn_retention_feeds_resolver_zero(psim):
    async def main():
        from foundationdb_tpu_torch.cluster.management import exclude_servers

        c = _multi().start()
        db = c.database()
        await exclude_servers(db, [2])
        assert c.excluded == {2}
        for i in range(6):
            await db.set(b"tick%d" % i, b"t")
        await delay(0.1)
        r0 = c.resolvers[0]
        assert any(
            any(m.param1.startswith(b"\xff") for m in ms)
            for ms in r0.state_store.values()
        ), "committed system mutations not retained at resolver 0"
        c.stop()

    psim.run(main())


def test_resolution_balancing_moves_hot_boundary(psim):
    async def main():
        c = _multi(n_resolvers=2, resolver_boundaries=[b"\x80"]).start()
        db = c.database()
        for i in range(120):
            await db.set(b"\x10hot%03d" % (i % 40), b"%d" % i)
        for _ in range(200):
            if c.balancer.moves:
                break
            await delay(0.1)
        assert c.balancer.moves > 0, "hot boundary never moved"
        assert c.resolver_config.boundaries[0] != b"\x80"
        # Conflicts still caught in the moved range while it dual-routes.
        await db.set(b"\x10hot000", b"base")
        tr1 = db.create_transaction()
        await tr1.get(b"\x10hot000")
        tr2 = db.create_transaction()
        tr2.set(b"\x10hot000", b"clobber")
        await tr2.commit()
        tr1.set(b"\x10hot-out", b"no")
        with pytest.raises(NotCommitted):
            await tr1.commit()
        c.stop()

    psim.run(main())


# ------------------------------------- same-seed differential vs the JAX package

NODES = 24


def cycle_key(i: int) -> bytes:
    return b"cycle/" + struct.pack(">I", i)


def _sharded_run(pkg: str, seed: int):
    """Cycle on one package's ShardedKVCluster(n_resolvers=4), both the
    resolvers and the storage shards split at Cycle keys, under its own
    sim_loop(seed) with a fresh trace sink; then a keyspace dump."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    rt, tr = mod("core.runtime"), mod("core.trace")
    port = pkg == "foundationdb_tpu_torch"
    bounds = [cycle_key(NODES * i // 4) for i in (1, 2, 3)]
    sink = tr.TraceSink()
    old_sink = tr.global_sink()
    tr.set_global_sink(sink)
    loop = rt.sim_loop(seed=seed)
    try:
        with rt.loop_context(loop):
            cluster = mod("cluster.sharded_cluster").ShardedKVCluster(
                n_storage=4, n_logs=2, replication="double",
                shard_boundaries=bounds, n_resolvers=4,
                resolver_boundaries=bounds,
                **({"device": "cpu"} if port else {}))
            cluster.start()
            db = cluster.database()

            async def main():
                cyc = mod("workloads.cycle").CycleWorkload(db, nodes=NODES)
                await cyc.setup()
                await cyc.start(clients=6, txns_per_client=8)
                ok = await cyc.check()

                async def dump(t):
                    return await t.get_range(b"", b"\xff")

                rows = await db.transact(dump)
                cluster.stop()
                return ok, cyc.retries, cyc.txns_done, rows

            out = loop.run(main(), timeout_sim_seconds=1e6)
        loop.shutdown()
    finally:
        tr.set_global_sink(old_sink)
    digest = hashlib.sha256("\n".join(
        json.dumps(e, sort_keys=True, default=str) for e in sink.events
    ).encode()).hexdigest()
    return {"result": out,
            "conflicts": [r.conflict_transactions for r in cluster.resolvers],
            "conflict_sets": [type(r.cs).__name__ for r in cluster.resolvers],
            "engines": [type(s.data).__name__ for s in cluster.storages],
            "digest": digest, "events": len(sink.events)}


@pytest.mark.parametrize("backend_pair", ["oracle", "device"])
def test_same_seed_differential_against_jax_package(backend_pair,
                                                    monkeypatch):
    from functools import partial

    from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS

    if backend_pair == "oracle":
        monkeypatch.setattr(JKNOBS, "CONFLICT_SET_IMPL", "oracle")
        monkeypatch.setattr(JKNOBS, "STORAGE_ENGINE_IMPL", "memory")
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "memory")
        monkeypatch.setattr(
            sharded_cluster, "make_conflict_set",
            partial(sharded_cluster.make_conflict_set, impl="oracle"))
    else:
        monkeypatch.setattr(JKNOBS, "CONFLICT_SET_IMPL", "tpu")
        monkeypatch.setattr(JKNOBS, "STORAGE_ENGINE_IMPL", "tpu")
        monkeypatch.setattr(JKNOBS, "TPU_PROBE_KERNEL", "pallas")
        monkeypatch.setattr(SERVER_KNOBS, "STORAGE_ENGINE_IMPL", "gpu")
        # The port's pipelined resolver role does not yield before its
        # readback, so it keeps the synchronous path's schedule (a seed's
        # device and host backends replay alike); the JAX package's role
        # yields there, so its device side runs the synchronous path.
        monkeypatch.setattr(JKNOBS, "TPU_PIPELINE_DEPTH", 1)
    want = _sharded_run("foundationdb_tpu", seed=11)
    got = _sharded_run("foundationdb_tpu_torch", seed=11)
    ok, retries = got["result"][:2]
    assert ok and retries > 0
    # every resolver judged its own share of the keys, and some conflicted
    assert sum(got["conflicts"]) > 0
    assert got["result"][-1], "the keyspace dump is empty"
    assert got["conflict_sets"] == (
        ["ConflictSetCPU"] * 4 if backend_pair == "oracle"
        else ["ConflictSetGPU"] * 4)
    assert got["engines"] == (
        ["VersionedMap"] * 4 if backend_pair == "oracle"
        else ["KeyValueStoreGPU"] * 4)
    for key in ("result", "conflicts", "digest", "events"):
        assert got[key] == want[key], key


# ------------------------------------------- host paths the multi-role tier runs


@pytest.mark.parametrize("tagged", [True, False])
def test_peek_wire_round_trip_equals_the_jax_codec(tagged):
    """TaggedMutationBatch.to_entries (every simulated peek decodes
    through it) gives back the entries, tagged or bare, as the JAX
    package's codec does on the same entries: versions past 2^32, empty
    params, empty rows, every mutation type of the mix."""
    from foundationdb_tpu.cluster.commit_wire import (
        TaggedMutationBatch as JBatch,
    )
    from foundationdb_tpu.cluster.interfaces import Mutation as JMutation
    from foundationdb_tpu.cluster.log_system import (
        TaggedMutation as JTagged,
    )
    from foundationdb_tpu.kv.atomic import MutationType as JType
    from foundationdb_tpu_torch.cluster.commit_wire import TaggedMutationBatch

    def entries(mut, tag, mtype):
        rows = [mut(mtype.SET_VALUE, b"k%d" % i, b"v" * (i % 3))
                for i in range(40)]
        rows += [mut(mtype.CLEAR_RANGE, b"a", b"z"),
                 mut(mtype.ADD_VALUE, b"", b"\x00\x01")]
        if tagged:
            rows = [tag(tuple(range(i % 3)), m) for i, m in enumerate(rows)]
        return [(7, rows[:30]), (1 << 40, rows[30:]), ((1 << 40) + 1, [])]

    mine = entries(Mutation, TaggedMutation, MutationType)
    theirs = entries(JMutation, JTagged, JType)
    back = TaggedMutationBatch.from_bytes(
        TaggedMutationBatch.from_entries(mine).to_bytes()).to_entries()
    jback = JBatch.from_bytes(JBatch.from_entries(theirs).to_bytes()
                              ).to_entries()
    assert back == mine

    def plain(es):
        return [(v, [(getattr(r, "tags", None),
                      int(getattr(r, "mutation", r).type),
                      getattr(r, "mutation", r).param1,
                      getattr(r, "mutation", r).param2) for r in rows])
                for v, rows in es]

    assert plain(back) == plain(jback)


@pytest.mark.parametrize("seed", [0, 1])
def test_proxy_clip_equals_the_jax_clip(seed):
    """The proxy's per-resolver clip (cluster/resolution.clip_txns, with
    its in-segment fast path) equals the JAX package's on ranges inside,
    across and outside the segments, empty and inverted ones too."""
    import numpy as np

    from foundationdb_tpu.cluster.resolution import clip_txns as jclip
    from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
    from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
    from foundationdb_tpu_torch.cluster.resolution import clip_txns
    from foundationdb_tpu_torch.resolver.types import TxnConflictInfo

    rng = np.random.default_rng(seed)

    def key():
        return bytes(rng.integers(0, 4, rng.integers(0, 4)).astype(np.uint8))

    for _ in range(200):
        cuts = sorted(key() for _ in range(3))
        segs = [(cuts[0], cuts[1])] + ([(cuts[1], cuts[2])]
                                       if rng.random() < 0.5 else [])
        spec = [(int(rng.integers(0, 9)),
                 [(key(), key()) for _ in range(rng.integers(0, 4))],
                 [(key(), key()) for _ in range(rng.integers(0, 3))])
                for _ in range(6)]
        got = clip_txns([TxnConflictInfo(s, [KeyRange(*r) for r in rr],
                                         [KeyRange(*w) for w in wr])
                         for s, rr, wr in spec], segs)
        want = jclip([JTxn(s, [JKeyRange(*r) for r in rr],
                           [JKeyRange(*w) for w in wr])
                      for s, rr, wr in spec], segs)
        assert [(t.read_snapshot, [(r.begin, r.end) for r in t.read_ranges],
                 [(w.begin, w.end) for w in t.write_ranges]) for t in got] \
            == [(t.read_snapshot, [(r.begin, r.end) for r in t.read_ranges],
                 [(w.begin, w.end) for w in t.write_ranges]) for t in want]
