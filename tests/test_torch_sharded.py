"""The port's multi-resolver conflict set, ShardedConflictSetGPU (on the
CPU), against the JAX package's ShardedConflictSetTPU on the virtual CPU
mesh (conftest: 8 host devices) and the sharded oracle
ShardedConflictSetCPU.

The same numpy-seeded batches go into all of them; statuses,
shard_entries() and last_p2_iters must be equal after every batch, across
compactions, block and key-width growth, the touched-block cap, abort
chains, pipelined submits and a mid-stream hand-over of a JAX set's state
to ShardedConflictSetGPU.from_state. The merged st_aux bytes of a fast and
a compaction step equal the JAX step's output byte for byte. The JAX
differentials run the port's set in both placements: every shard on one
device (`device="cpu"`) and one device per shard (`devices=["cpu"] * S`,
the mesh's counterpart), which must give the same results. The cases
keep to a few shapes (8-byte keys, 25-txn batches, a capacity that does not
grow where growth is not the point) to bound the JAX compiles: every step
shape is a compile of a few seconds.
"""

import math
import struct

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.kv.keys import KeyRange as JKeyRange
from foundationdb_tpu.resolver.sharded import (
    ShardedConflictSetCPU as JShardedOracle,
)
from foundationdb_tpu.resolver.types import TxnConflictInfo as JTxn
from foundationdb_tpu.resolver.wire import WireBatch as JWire
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as PKNOBS
from foundationdb_tpu_torch.kv.keys import KeyRange as PKeyRange
from foundationdb_tpu_torch.resolver import (
    ShardedConflictSetCPU,
    ShardedConflictSetGPU,
    clip_txns_to_shard,
)
from foundationdb_tpu_torch.resolver.cpu import ConflictSetCPU
from foundationdb_tpu_torch.resolver.packing import next_bucket
from foundationdb_tpu_torch.resolver.types import TxnConflictInfo as PTxn
from foundationdb_tpu_torch.resolver.wire import WireBatch as PWire


def k8(x: int) -> bytes:
    return struct.pack(">Q", int(x))


def mesh_of(n):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices("cpu")
    assert len(devs) >= n, "conftest forces 8 virtual host devices"
    return Mesh(np.array(devs[:n]), ("resolvers",))


PLACEMENTS = ("device", "devices")


def placement(kind, n_shards):
    """The port set's placement keywords: every shard on the CPU through
    `device`, or one CPU device per shard through `devices`."""
    return ({"device": "cpu"} if kind == "device"
            else {"devices": ["cpu"] * n_shards})


def bounds_of(n_shards, key_space=1000):
    return [k8(key_space * (i + 1) // n_shards) for i in range(n_shards - 1)]


def raw_batch(rng, n, version, key_space=1000, lag=400):
    """Point writes and range reads of up to 20 keys over key_space (the
    JAX tests' random_txns), as plain tuples for either package."""
    out = []
    for _ in range(n):
        rr = []
        for _ in range(rng.integers(0, 4)):
            a = int(rng.integers(0, key_space))
            rr.append((k8(a), k8(a + int(rng.integers(1, 20)))))
        wr = []
        for _ in range(rng.integers(0, 3)):
            a = int(rng.integers(0, key_space))
            wr.append((k8(a), k8(a + 1)))
        out.append((version - int(rng.integers(0, lag)), rr, wr))
    return out


def chain_raw(n, snap=10):
    """The abort cascade: t0 blind-writes k0; every t_i reads k_{i-1} and
    writes k_i, so verdicts alternate down the chain."""
    out = [(snap, [], [(k8(0), k8(1))])]
    for i in range(1, n):
        out.append((snap, [(k8(i - 1), k8(i))], [(k8(i), k8(i + 1))]))
    return out


def txns(raw, jax_side: bool):
    T, KR = (JTxn, JKeyRange) if jax_side else (PTxn, PKeyRange)
    return [T(s, [KR(*r) for r in rr], [KR(*w) for w in wr])
            for s, rr, wr in raw]


class Trio:
    """ShardedConflictSetTPU, ShardedConflictSetGPU (on the CPU, placed
    as `where` says) and the port's ShardedConflictSetCPU over one
    partition; step() resolves one batch on all three and holds them
    equal."""

    def __init__(self, bounds, where="device", **kw):
        from foundationdb_tpu.resolver.sharded import ShardedConflictSetTPU

        self.tpu = ShardedConflictSetTPU(bounds, mesh_of(len(bounds) + 1),
                                         **kw)
        self.port = ShardedConflictSetGPU(
            bounds, **placement(where, len(bounds) + 1), **kw)
        self.ora = ShardedConflictSetCPU(bounds)

    def step(self, v, no, raw, wire=False, entries=True):
        want = self.ora.resolve(v, no, txns(raw, False)).statuses
        if wire:
            a = self.tpu.resolve(v, no, JWire.from_txns(txns(raw, True)))
            b = self.port.resolve(v, no, PWire.from_txns(txns(raw, False)))
        else:
            a = self.tpu.resolve(v, no, txns(raw, True))
            b = self.port.resolve(v, no, txns(raw, False))
        assert a.statuses == want
        assert b.statuses == want
        assert self.port.last_p2_iters == self.tpu.last_p2_iters
        if entries:
            assert self.port.shard_entries() == self.ora.shard_entries()
            assert self.port.shard_entries() == self.tpu.shard_entries()
        return want


@pytest.fixture
def knobs(monkeypatch):
    """Set a server knob in both packages (restored after the test)."""
    def set_knob(name, value):
        monkeypatch.setattr(JKNOBS, name, value)
        monkeypatch.setattr(PKNOBS, name, value)

    return set_knob


# ------------------------------------------- the partition helpers and oracle


def test_clip_txns_to_shard():
    t = PTxn(5, [PKeyRange(k8(10), k8(30))], [PKeyRange(k8(25), k8(26))])
    [c] = clip_txns_to_shard([t], k8(20), k8(28))
    assert c.read_ranges == [PKeyRange(k8(20), k8(28))]
    assert c.write_ranges == [PKeyRange(k8(25), k8(26))]
    [c2] = clip_txns_to_shard([t], k8(100), None)
    assert c2.read_ranges == [] and c2.write_ranges == []


@pytest.mark.parametrize("kind", ["sorted", "duplicates", "unsorted",
                                  "none"])
def test_one_pass_clip_equals_per_shard_clip(kind):
    """clip_txns_to_shards (the set's one-pass clip) equals, shard by
    shard, the JAX package's clip_txns_to_shard over shard_key_ranges,
    with empty, inverted, point, in-shard and cross-shard ranges."""
    from foundationdb_tpu.resolver.sharded import (
        clip_txns_to_shard as jclip,
        shard_key_ranges as jranges,
    )
    from foundationdb_tpu_torch.resolver.sharded import clip_txns_to_shards

    rng = np.random.default_rng(["sorted", "duplicates", "unsorted",
                                 "none"].index(kind))

    def key():
        return bytes(rng.integers(0, 4, rng.integers(0, 4)).astype(np.uint8))

    for _ in range(200):
        if kind == "none":
            bounds = []
        elif kind == "duplicates":
            b = key()
            bounds = sorted([b, b, key()])
        else:
            bounds = sorted(key() for _ in range(3))
            if kind == "unsorted":
                bounds = bounds[::-1]
        spec = [(int(rng.integers(0, 9)),
                 [(key(), key()) for _ in range(rng.integers(0, 4))],
                 [(key(), key()) for _ in range(rng.integers(0, 3))])
                for _ in range(6)]
        got = clip_txns_to_shards(
            [PTxn(s, [PKeyRange(*r) for r in rr], [PKeyRange(*w) for w in wr])
             for s, rr, wr in spec], bounds)
        jtx = [JTxn(s, [JKeyRange(*r) for r in rr], [JKeyRange(*w) for w in wr])
               for s, rr, wr in spec]
        want = [jclip(jtx, lo, hi) for lo, hi in jranges(bounds)]

        def plain(shards):
            return [[(t.read_snapshot,
                      [(r.begin, r.end) for r in t.read_ranges],
                      [(w.begin, w.end) for w in t.write_ranges])
                     for t in txns] for txns in shards]

        assert plain(got) == plain(want)


def test_sharded_oracle_matches_single_set_when_partition_invisible():
    rng = np.random.default_rng(0)
    single, sharded = ConflictSetCPU(), ShardedConflictSetCPU([k8(10_000)])
    v = 1000
    for _ in range(5):
        raw = raw_batch(rng, 30, v)
        v += 100
        assert (single.resolve(v, 0, txns(raw, False)).statuses
                == sharded.resolve(v, 0, txns(raw, False)).statuses)


def test_sharded_conservatism_is_reference_semantics():
    """A txn aborted on shard A still merges its writes on shard B, so a
    later reader of the shard-B key conflicts (per-resolver
    independence), where a single global set commits it."""
    sharded, single = ShardedConflictSetCPU([k8(500)]), ConflictSetCPU()
    setup = PTxn(0, [], [PKeyRange(k8(100), k8(101))])
    x = PTxn(5, [PKeyRange(k8(100), k8(101))], [PKeyRange(k8(900), k8(901))])
    y = PTxn(15, [PKeyRange(k8(900), k8(901))], [])
    for cs in (sharded, single):
        assert cs.resolve(10, 0, [setup]).statuses == [0]
        assert cs.resolve(20, 0, [x]).statuses == [1]
    assert sharded.resolve(30, 0, [y]).statuses == [1]
    assert single.resolve(30, 0, [y]).statuses == [0]


def test_port_oracle_matches_jax_sharded_oracle():
    rng = np.random.default_rng(3)
    bounds = bounds_of(4)
    ja = JShardedOracle(bounds)
    po = ShardedConflictSetCPU(bounds)
    v = 1000
    for _ in range(6):
        v += 120
        raw = raw_batch(rng, 40, v)
        assert (ja.resolve(v, v - 600, txns(raw, True)).statuses
                == po.resolve(v, v - 600, txns(raw, False)).statuses)
    assert ja.shard_entries() == po.shard_entries()


# ----------------------------------------------- tests/test_sharded.py cases


@pytest.mark.parametrize("where", PLACEMENTS)
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_differential(n_shards, where):
    trio = Trio(bounds_of(n_shards), where, max_key_bytes=8,
                initial_capacity=512)
    rng = np.random.default_rng(42 + n_shards)
    v = 1000
    for b in range(6):
        raw = raw_batch(rng, 25, v)
        v += 120
        trio.step(v, v - 600, raw, wire=b == 5)
    assert trio.port.fast_resolves > 0


def test_sharded_growth_blocks_and_entries():
    """Per-shard history growth past the initial 64 slots: block growth
    on the device ahead of a compaction, step functions bit-for-bit."""
    trio = Trio([k8(500)], max_key_bytes=8, initial_capacity=64)
    rng = np.random.default_rng(9)
    v = 100
    for _ in range(4):
        raw = [(v - 10, [], [(k8(k), k8(k + 1))
                             for k in rng.integers(0, 1000, 2)])
               for _ in range(30)]
        v += 100
        trio.step(v, 0, raw)
    assert trio.port.capacity == trio.tpu.capacity > 64
    assert trio.port.NB == trio.tpu.NB


@pytest.mark.parametrize("where", PLACEMENTS)
def test_sharded_width_growth(where):
    """Keys beyond the initial packed width widen every shard's state and
    fence directory (same contract as the single-resolver set)."""
    trio = Trio([b"m"], where, max_key_bytes=8, initial_capacity=64)
    raw1 = [(0, [], [(b"abc", b"abd")])]
    raw2 = [(5, [(b"a" * 40, b"a" * 40 + b"\xff")],
             [(b"z" * 100, b"z" * 100 + b"\x00")])]
    for v, raw in ((10, raw1), (20, raw2), (30, raw1)):
        trio.step(v, 0, raw)
    assert trio.port.max_key_bytes == trio.tpu.max_key_bytes >= 100


# ----------------------------------- tests/test_sharded_block.py tier-1 cases


@pytest.mark.parametrize("where", PLACEMENTS)
def test_sharded_block_differential_across_compactions(knobs, where):
    """Statuses AND per-shard entries with the compaction cadence at 3, so
    the run crosses several shard-wide compactions (fast <-> compaction
    hand-offs)."""
    knobs("TPU_COMPACT_EVERY_BATCHES", 3)
    trio = Trio([k8(333), k8(666)], where, max_key_bytes=8,
                initial_capacity=512)
    rng = np.random.default_rng(7)
    v = 1000
    for _ in range(8):
        raw = raw_batch(rng, 25, v)
        v += 120
        trio.step(v, v - 600, raw)
    assert trio.port.compactions >= 2 and trio.port.fast_resolves >= 4


def test_phase2_chain_log_depth_sharded():
    """The abort cascade through the sharded path: the chain lives in
    shard 0, the merged round count is the max over shards and within
    the doubling bound."""
    trio = Trio([k8(1_000_000)], max_key_bytes=8, initial_capacity=64)
    n = 60
    want = trio.step(100, 0, chain_raw(n))
    assert want[:4] == [0, 1, 0, 1]
    assert trio.port.last_p2_iters <= math.ceil(math.log2(next_bucket(n))) + 2


def test_phase2_chain_across_shards():
    """A chain whose links cross the shard boundary: each shard sees a
    broken chain, and the merge is exact against the sharded oracle."""
    trio = Trio([k8(30)], max_key_bytes=8, initial_capacity=64)
    trio.step(100, 0, chain_raw(60))
    trio.step(200, 0, chain_raw(60, snap=150))


def test_touched_block_cap_forces_compaction(knobs):
    """A batch spraying more blocks than TPU_MAX_TOUCHED_BLOCKS takes the
    compaction instead of an outsized gather bucket."""
    bounds = [k8(50_000)]
    trio = Trio(bounds, max_key_bytes=8, initial_capacity=2048,
                min_capacity=2048)
    rng = np.random.default_rng(5)
    v = 1000
    raw = [(v - 1, [], [(k8(int(k)), k8(int(k) + 1))])
           for k in rng.choice(100_000, size=700, replace=False)]
    trio.step(v, 0, raw)
    knobs("TPU_MAX_TOUCHED_BLOCKS", 8)
    v += 100
    spray = [(v - 5, [], [(k8(int(k)), k8(int(k) + 1))])
             for k in rng.choice(100_000, size=64, replace=False)]
    c0 = trio.port.compactions
    trio.step(v, 0, spray)
    assert trio.port._since_compact == trio.tpu._since_compact == 0
    assert trio.port.compactions == c0 + 1


def test_sharded_recompile_guard(knobs):
    """A steady batch profile (same txn count and footprint; snapshots and
    verdicts free to vary) must not add step shapes once its bucket is
    warm, through repeated compactions; the port counts the same shapes
    the JAX package compiles."""
    knobs("TPU_COMPACT_EVERY_BATCHES", 4)
    for cap in (2048, 4096):
        trio = Trio([k8(500)], max_key_bytes=8, initial_capacity=cap,
                    min_capacity=cap)
        rng = np.random.default_rng(cap)
        v, warm = 1000, None
        for batch in range(12):
            raw = []
            for i in range(24):
                rr = [(k8(k), k8(k + 1))
                      for k in ((5 * (3 * i + j)) % 1000 for j in range(3))]
                wr = [(k8(k), k8(k + 1))
                      for k in ((5 * (2 * i + j) + 250) % 1000
                                for j in range(2))]
                raw.append((v - int(rng.integers(0, 400)), rr, wr))
            v += 120
            trio.step(v, v - 600, raw, entries=batch == 11)
            if batch == 1:
                warm = trio.port.compiled_steps
        assert trio.port.compiled_steps == warm <= 3
        assert trio.port.compiled_steps == trio.tpu.compiled_steps


# ------------------------------------------------------------ port-only cases


@pytest.mark.parametrize("where", PLACEMENTS)
def test_merged_st_aux_bytes_equal_the_jax_step(knobs, where):
    """The raw merged verdict vector of one fast step and one compaction
    step: statuses, the max-mangled LE bytes of n, overflow and the
    phase-2 round byte, byte for byte against the JAX step's pmax."""
    bounds = bounds_of(4)
    trio = Trio(bounds, where, max_key_bytes=8, initial_capacity=64)
    rng = np.random.default_rng(11)
    v = 1000
    for kind in ("fast", "compaction"):
        if kind == "compaction":
            knobs("TPU_COMPACT_EVERY_BATCHES", 1)
        v += 120
        raw = raw_batch(rng, 25, v) + chain_raw(6, snap=v - 1)
        f0 = trio.port.fast_resolves
        ht = trio.tpu.submit(v, v - 600, txns(raw, True))
        hp = trio.port.submit(v, v - 600, txns(raw, False))
        assert (trio.port.fast_resolves > f0) == (kind == "fast")
        want = np.asarray(ht.st)[0]
        got = hp.st.numpy()
        assert got.dtype == np.int8 and want.dtype == np.int8
        assert np.array_equal(got, want), kind
        assert trio.port.verdicts(hp) == trio.tpu.verdicts(ht)
        # the n bytes are the max over shards of each byte, not one n
        assert hp.p2_syncs >= trio.port.n_shards


@pytest.mark.parametrize("where", PLACEMENTS)
def test_hand_over_mid_stream_from_jax_state(knobs, where):
    """Three batches on ShardedConflictSetTPU, its state handed to
    ShardedConflictSetGPU.from_state (split onto the shards' devices),
    three more on both: identical, across a compaction."""
    knobs("TPU_COMPACT_EVERY_BATCHES", 3)
    bounds = bounds_of(4)
    trio = Trio(bounds, where, max_key_bytes=8, initial_capacity=64)
    tpu = trio.tpu
    rng = np.random.default_rng(9)
    v = 1000
    for _ in range(3):
        v += 120
        trio.step(v, v - 500, raw_batch(rng, 25, v), entries=False)
    tpu._refresh_mirror()
    state = {
        "hmat": np.asarray(tpu.hmat), "counts": np.asarray(tpu.counts),
        "fences": np.asarray(tpu.fences), "btree": np.asarray(tpu.btree),
        "n": np.asarray(tpu.n), "NB": tpu.NB, "B": tpu.B,
        "n_words": tpu.n_words, "_base": tpu._base,
        "oldest_version": tpu.oldest_version,
        "_since_compact": tpu._since_compact,
        "_fences_enc": tpu._fences_enc, "_fills": tpu._fills,
        "min_NB": tpu.min_NB, "boundaries": tpu.boundaries,
    }
    trio.port = ShardedConflictSetGPU.from_state(state,
                                                 **placement(where, 4))
    assert trio.port.devices == [torch.device("cpu")] * 4
    assert trio.port.shard_entries() == tpu.shard_entries()
    for _ in range(3):
        v += 120
        trio.step(v, v - 500, raw_batch(rng, 25, v))
        assert trio.port._since_compact == tpu._since_compact
    assert trio.port.compactions >= 1


def test_submit_verdicts_pipelining_parity():
    """Three batches submitted before any is consumed (depth 3), then
    consumed in order; two more consumed newest first: the verdicts equal
    the sharded oracle's and the synchronous path's."""
    bounds = [k8(100), k8(200), k8(300)]
    rng = np.random.default_rng(41)
    windows, v = [], 1000
    for _ in range(5):
        v += 100
        windows.append((v, raw_batch(rng, 20, v, key_space=400, lag=300)))
    ora = ShardedConflictSetCPU(bounds)
    want = [ora.resolve(v, v - 600, txns(r, False)).statuses
            for v, r in windows]
    sync = ShardedConflictSetGPU(bounds, max_key_bytes=8,
                                 initial_capacity=64, device="cpu")
    assert [sync.resolve(v, v - 600, txns(r, False)).statuses
            for v, r in windows] == want

    cs = ShardedConflictSetGPU(bounds, max_key_bytes=8, initial_capacity=64,
                               device="cpu")
    handles = [cs.submit(v, v - 600, txns(r, False)) for v, r in windows[:3]]
    assert cs.inflight == cs.max_inflight == 3
    assert all(h.depth_at_submit == i + 1 for i, h in enumerate(handles))
    got = [cs.verdicts(h) for h in handles]
    handles = [cs.submit(v, v - 600, txns(r, False)) for v, r in windows[3:]]
    got += reversed([cs.verdicts(h) for h in reversed(handles)])
    assert got == want
    assert cs.inflight == 0
    assert cs.shard_entries() == ora.shard_entries()
    for h in handles:
        assert h.consumed and h.pack_ms >= 0 and h.dispatch_ms >= 0
        assert h.device_ms is not None and h.d2h_ms is not None
    with pytest.raises(RuntimeError):
        cs.verdicts(handles[0])


def test_reduced_config4_against_the_oracle():
    """BASELINE config 4 cut down: 4 shards over 2^14 uniform 8-byte keys,
    1,024-txn batches of 5 point reads and 2 point writes, every 7th txn
    with a wide read range drawn over the whole space (cross-shard
    stitching), snapshots lagging U[0, 4,096), the GC horizon 6 batches
    behind (so the history outgrows a batch's writes and the fast path
    runs once the window has filled)."""
    space = 1 << 14
    bounds = [k8(space // 4), k8(space // 2), k8(3 * space // 4)]
    rng = np.random.default_rng(4)
    cs = ShardedConflictSetGPU(bounds, max_key_bytes=9,
                               initial_capacity=1 << 14, device="cpu")
    ora = ShardedConflictSetCPU(bounds)
    v, n, crossing = 100_000, 1024, 0
    for b in range(8):
        raw = []
        for i in range(n):
            rr = [(k8(a), k8(a) + b"\x00")
                  for a in rng.integers(0, space, 5)]
            if i % 7 == 0:
                lo = int(rng.integers(0, space - 1))
                hi = int(rng.integers(lo + 1, space))
                rr.append((k8(lo), k8(hi)))
                crossing += sum(lo < int.from_bytes(x, "big") < hi
                                for x in bounds) > 0
            wr = [(k8(a), k8(a) + b"\x00")
                  for a in rng.integers(0, space, 2)]
            raw.append((v - int(rng.integers(0, 4 * n)), rr, wr))
        no = max(0, v - 6 * n)
        want = ora.resolve(v, no, txns(raw, False)).statuses
        assert cs.resolve(v, no, txns(raw, False)).statuses == want, b
        assert 0 < sum(want) < 2 * n
        v += n
    assert cs.shard_entries() == ora.shard_entries()
    assert crossing > 100 and cs.fast_resolves > 0


@pytest.mark.parametrize("where", PLACEMENTS)
def test_local_cluster_cycle_on_the_sharded_set(where):
    """The port's LocalCluster with a 4-shard ShardedConflictSetGPU as its
    resolver (tests/test_cluster_tpu.py's mesh case): the Cycle invariant
    holds with real cross-shard conflicts, and every resolve batch
    replayed through ShardedConflictSetCPU gives the same verdicts and
    step functions."""
    from foundationdb_tpu_torch.cluster import LocalCluster
    from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
    from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

    bounds = [b"cycle/\x00\x00\x00\x05", b"cycle/\x00\x00\x00\x0a",
              b"cycle/\x00\x00\x00\x0f"]
    cs = ShardedConflictSetGPU(bounds, max_key_bytes=16,
                               initial_capacity=64, **placement(where, 4))
    log = []
    real_submit, real_verdicts = cs.submit, cs.verdicts
    open_ = {}

    def submit(version, oldest, batch):
        h = real_submit(version, oldest, batch)
        open_[id(h)] = len(log)
        log.append([version, oldest, batch, None])
        return h

    def verdicts(h):
        st = real_verdicts(h)
        log[open_.pop(id(h))][3] = st
        return st

    cs.submit, cs.verdicts = submit, verdicts
    loop = sim_loop(seed=13)
    with loop_context(loop):
        cluster = LocalCluster(conflict_set=cs, device="cpu").start()
        db = cluster.database()

        async def main():
            wl = CycleWorkload(db, nodes=14)
            await wl.setup()
            await wl.start(clients=3, txns_per_client=6)
            ok = await wl.check()
            cluster.stop()
            return ok, wl.retries

        ok, retries = loop.run(main(), timeout_sim_seconds=1e6)
    loop.shutdown()
    assert ok
    assert retries > 0
    assert cluster.resolver.conflict_transactions > 0
    ora = ShardedConflictSetCPU(bounds)
    for v, oldest, batch, st in log:
        batch = batch.to_txns() if hasattr(batch, "to_txns") else batch
        assert ora.resolve(v, oldest, batch).statuses == st
    assert cs.shard_entries() == ora.shard_entries()
    assert sum(1 for e in ora.shard_entries() if len(e) > 1) >= 3


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedConflictSetGPU([k8(5)])
    assert ShardedConflictSetGPU([k8(5)], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [
    {"devices": ["cpu"] * 3},
    {"devices": ["cpu"] * 5},
    {"devices": ["cpu"] * 4, "device": "cpu"},
], ids=["too-few", "too-many", "both"])
def test_a_placement_of_the_wrong_size_or_both_raises(kw):
    """devices= needs exactly one device per shard (the JAX mesh needs
    exactly S devices); device= and devices= together are refused; the
    hand-over checks the same."""
    bounds = bounds_of(4)
    with pytest.raises(ValueError, match="exactly 4 devices|not both"):
        ShardedConflictSetGPU(bounds, **kw)
    state = {"boundaries": bounds}
    with pytest.raises(ValueError, match="exactly 4 devices|not both"):
        ShardedConflictSetGPU.from_state(state, **kw)


def test_shards_on_one_device_share_one_upload_and_one_mirror_read(
        monkeypatch):
    """Shards whose devices repeat share one H2D of their fused buffers a
    batch and one mirror readback a compaction: one device, one upload
    and one read, whichever argument placed them."""
    from foundationdb_tpu_torch.resolver import gpu

    uploads = []
    real = gpu.upload
    monkeypatch.setattr(gpu, "upload",
                        lambda buf, dev: uploads.append(buf.shape) or
                        real(buf, dev))
    rng = np.random.default_rng(12)
    raws = [raw_batch(rng, 25, 1000 + 120 * b) for b in range(4)]
    sets = [ShardedConflictSetGPU(bounds_of(4), max_key_bytes=8,
                                  initial_capacity=512, **placement(w, 4))
            for w in PLACEMENTS]
    for cs in sets:
        uploads.clear()
        for b, raw in enumerate(raws):
            v = 1120 + 120 * b
            cs.resolve(v, v - 600, txns(raw, False))
        assert len(uploads) == 4 and all(u[0] == 4 for u in uploads)
        cs._refresh_mirror()  # the last compaction's read is lazy
        assert cs.mirror_reads == cs.compactions >= 1
        assert len(cs._groups) == 1
    assert sets[0].shard_entries() == sets[1].shard_entries()


@pytest.mark.parametrize("name", ["cuda:1", "cuda:4"])
def test_a_card_past_the_count_raises_at_once(monkeypatch, name):
    """resolve_device("cuda:N") with N at or past the machine's card
    count raises there, naming the count, not at the first allocation."""
    from foundationdb_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="has 1 CUDA device"):
        resolve_device(name)
    with pytest.raises(RuntimeError, match="has 1 CUDA device"):
        ShardedConflictSetGPU(bounds_of(2), devices=["cpu", name])
    assert resolve_device("cuda:0") == torch.device("cuda:0")
