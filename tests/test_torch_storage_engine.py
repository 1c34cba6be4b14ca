"""The port's storage read window: KeyValueStoreGPU (on the CPU) against the
JAX package's KeyValueStoreTPU and the host oracle VersionedMap.

Every case of tests/test_storage_engine_tpu.py that needs no cluster runs
on a KeyValueStoreTPU and a KeyValueStoreGPU side by side (`Twin`): each
read reply, `entries()`, NB, the key width and the counters must be equal
after every read. `_read_kernel_impl` is held bit for bit against both
JAX probes on identical operands; a seeded op mix runs against the JAX
engine and the oracle; a KeyValueStoreTPU is handed over mid-stream to
KeyValueStoreGPU.from_state. All integer: equality is exact everywhere.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.knobs import SERVER_KNOBS as JKNOBS
from foundationdb_tpu.kv.versioned_map import canonical_chain as j_chain
from foundationdb_tpu.storage_engine import tpu_engine
from foundationdb_tpu.storage_engine.tpu_engine import KeyValueStoreTPU
from foundationdb_tpu_torch.core.knobs import SERVER_KNOBS as PKNOBS
from foundationdb_tpu_torch.kv.versioned_map import VersionedMap
from foundationdb_tpu_torch.kv.versioned_map import canonical_chain
from foundationdb_tpu_torch.storage_engine import gpu_engine
from foundationdb_tpu_torch.storage_engine.factory import make_mvcc_window
from foundationdb_tpu_torch.storage_engine.gpu_engine import (
    KeyValueStoreGPU,
    decode_set_columns,
)

I32MAX = 2**31 - 1
COUNTERS = ("c_point_reads", "c_range_reads", "c_batches",
            "c_span_fallbacks", "c_compactions", "c_delta_folds")


@pytest.fixture
def knob(monkeypatch):
    """Set a knob in both packages."""
    def set_knob(name, value):
        monkeypatch.setattr(JKNOBS, name, value)
        monkeypatch.setattr(PKNOBS, name, value)

    return set_knob


class Twin:
    """A KeyValueStoreTPU and a KeyValueStoreGPU(device="cpu") driven by the
    same calls. Writes go to both; every reply, entries(), NB, the key
    width and the counters must be equal."""

    def __init__(self, gpu=None, tpu=None, **kw):
        self.j = tpu if tpu is not None else KeyValueStoreTPU(**kw)
        self.g = gpu if gpu is not None else KeyValueStoreGPU(
            device="cpu", **kw)
        # counts from before a hand-over (from_state starts at zero)
        self.c0 = {c: getattr(self.j, c).total - getattr(self.g, c).total
                   for c in COUNTERS}

    def __getattr__(self, name):
        def both(*a, **k):
            want = getattr(self.j, name)(*a, **k)
            got = getattr(self.g, name)(*a, **k)
            assert got == want, name
            return got

        return both

    def check_state(self) -> None:
        assert self.g.NB == self.j.NB
        assert self.g._n_words == self.j._n_words
        for c in COUNTERS:
            assert (getattr(self.g, c).total + self.c0[c]
                    == getattr(self.j, c).total), c

    def submit_reads(self, points, ranges):
        return (self.j.submit_reads(points, ranges),
                self.g.submit_reads(points, ranges))

    def read_verdicts(self, handles):
        want = self.j.read_verdicts(handles[0])
        got = self.g.read_verdicts(handles[1])
        assert got == want
        self.check_state()
        return got

    def read(self, points, ranges=()):
        return self.read_verdicts(self.submit_reads(points, list(ranges)))

    def entries(self):
        want, got = self.j.entries(), self.g.entries()
        assert got == want
        self.check_state()
        return got

    def __len__(self):
        assert len(self.g) == len(self.j)
        return len(self.g)

    @property
    def NB(self):
        self.check_state()
        return self.g.NB


def read_all(eng, keys, versions):
    """One fused dispatch of every (key, version) point; returns values."""
    pv, _ = eng.read([(k, v) for k in keys for v in versions])
    return pv


# ---------------------------------------------------------------------------
# factory and device
# ---------------------------------------------------------------------------

def test_factory_constructs_by_name():
    assert isinstance(make_mvcc_window(device="cpu"), KeyValueStoreGPU)
    assert isinstance(make_mvcc_window("memory"), VersionedMap)
    with pytest.raises(ValueError, match="gpu|memory"):
        make_mvcc_window("rocksdb", device="cpu")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyValueStoreGPU()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mvcc_window()
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyValueStoreGPU.from_state({})
    assert KeyValueStoreGPU(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the cases of tests/test_storage_engine_tpu.py, on both engines
# ---------------------------------------------------------------------------

def test_point_reads_match_oracle_differential():
    rng = np.random.default_rng(5)
    eng = Twin(n_words=2, block_slots=8)
    oracle = VersionedMap()
    v = 10
    keys = [b"k%03d" % i for i in range(40)]
    for step in range(150):
        k = keys[int(rng.integers(0, len(keys)))]
        op = rng.random()
        if op < 0.55:
            val = b"v%d" % step
            eng.set(k, val, v)
            oracle.set(k, val, v)
        elif op < 0.75:
            eng.clear(k, v)
            oracle.clear(k, v)
        elif op < 0.85:
            fv = v - int(rng.integers(0, 30))
            eng.forget_before(fv)
            oracle.forget_before(fv)
        v += int(rng.integers(1, 3))
        if step % 25 == 24:
            vs = [v, max(oracle.oldest_version, v - 10)]
            got = read_all(eng, keys, vs)
            assert got == [oracle.get(k, rv) for k in keys for rv in vs]
    assert eng.entries() == oracle.entries()


def test_mvcc_version_window_visibility():
    eng = Twin(n_words=1, block_slots=8)
    eng.set(b"a", b"a1", 10)
    eng.set(b"a", b"a2", 20)
    eng.clear(b"a", 30)
    eng.set(b"a", b"a4", 40)
    eng.set(b"b", b"b1", 15)
    eng._compact()
    pv, _ = eng.read(
        [(b"a", rv) for rv in (5, 10, 19, 20, 29, 30, 39, 40, 99)]
        + [(b"b", 14), (b"b", 15)])
    assert pv == [None, b"a1", b"a1", b"a2", b"a2", None, None, b"a4",
                  b"a4", None, b"b1"]


def test_delta_tombstone_suppresses_base_value():
    eng = Twin(n_words=1, block_slots=8)
    eng.set(b"x", b"old", 10)
    eng._compact()
    eng.clear(b"x", 20)
    assert read_all(eng, [b"x"], [15, 25]) == [b"old", None]
    _, rv = eng.read([], [(b"a", b"z", 25, 0, False)])
    assert rv == [[]]


def test_range_reads_span_block_boundaries(knob):
    knob("STORAGE_TPU_SPAN_CAP", 256)
    eng = Twin(n_words=2, block_slots=8)
    oracle = VersionedMap()
    for i in range(96):
        k, val = b"key%04d" % i, b"val%d" % i
        eng.set(k, val, 10 + i)
        oracle.set(k, val, 10 + i)
    eng._compact()
    v = 10 + 96
    cases = [
        (b"key0000", b"key0100", v, 0, False),   # whole keyspace
        (b"key0006", b"key0021", v, 0, False),   # mid-block to mid-block
        (b"key0006", b"key0021", v, 5, False),   # limit
        (b"key0006", b"key0091", v, 7, True),    # reverse + limit
        (b"key0000", b"key0050", 30, 0, False),  # old version cut
        (b"zzz", b"zzzz", v, 0, False),          # past the last fence
    ]
    _, rvs = eng.read([], cases)
    for (b, e, rv, lim, rev), got in zip(cases, rvs):
        assert got == oracle.get_range(b, e, rv, lim, rev), (b, e, rv)
    assert eng.g.c_range_reads.total >= len(cases)


def test_block_directory_grows_and_shrinks():
    eng = Twin(n_words=2, block_slots=8)
    nb0 = eng.NB
    v = 1
    for i in range(400):
        eng.set(b"g%05d" % i, b"x", v)
        v += 1
    eng._compact()
    assert eng.NB > nb0
    assert len(eng) == 400
    eng.clear_range(b"g", b"h", v)
    eng.forget_before(v)
    eng._compact()
    assert eng.NB == nb0
    assert len(eng) == 0
    got = read_all(eng, [b"g%05d" % i for i in (0, 199, 399)], [v + 1])
    assert got == [None, None, None]


def test_entries_canonical_independent_of_forget_timing():
    def build(forget_early: bool):
        e = Twin(n_words=1, block_slots=8)
        e.set(b"p", b"1", 10)
        e.clear(b"q", 12)
        if forget_early:
            e.forget_before(15)
            e._compact()
        e.set(b"p", b"2", 20)
        e.set(b"q", b"3", 21)
        if not forget_early:
            e.forget_before(15)
        return e

    a, b = build(True), build(False)
    assert a.entries() == b.entries()
    o = VersionedMap()
    o.set(b"p", b"1", 10)
    o.clear(b"q", 12)
    o.set(b"p", b"2", 20)
    o.set(b"q", b"3", 21)
    o.forget_before(15)
    assert a.entries() == o.entries()


@pytest.mark.parametrize("chain,oldest", [
    ([(5, b"x"), (8, None), (12, b"y")], 9),
    ([(5, b"x"), (8, None)], 6),
    ([(5, None)], 5),
    ([(5, None), (7, b"z")], 4),
    ([], 3),
])
def test_canonical_chain_drops_tombstone_base(chain, oldest):
    assert canonical_chain(chain, oldest) == j_chain(chain, oldest)
    if chain == [(5, b"x"), (8, None), (12, b"y")]:
        assert canonical_chain(chain, oldest) == [(12, b"y")]


def test_pipelined_handles_survive_compaction(knob):
    knob("STORAGE_TPU_DELTA_SLOTS", 16)
    eng = Twin(n_words=1, block_slots=8)
    for i in range(12):
        eng.set(b"h%02d" % i, b"a%d" % i, 10 + i)
    h1 = eng.submit_reads([(b"h%02d" % i, 50) for i in range(12)], [])
    for i in range(40):  # > STORAGE_TPU_DELTA_SLOTS: forces a compaction
        eng.set(b"z%02d" % i, b"b%d" % i, 30 + i)
    h2 = eng.submit_reads([(b"z%02d" % i, 99) for i in range(40)], [])
    assert eng.g.c_compactions.total >= 2
    pv2, _ = eng.read_verdicts(h2)
    pv1, _ = eng.read_verdicts(h1)
    assert pv1 == [b"a%d" % i for i in range(12)]
    assert pv2 == [b"b%d" % i for i in range(40)]
    with pytest.raises(ValueError, match="consumed"):
        eng.g.read_verdicts(h1[1])


def test_wide_range_falls_back_to_oracle(knob):
    knob("STORAGE_TPU_SPAN_CAP", 8)
    eng = Twin(n_words=2, block_slots=8)
    oracle = VersionedMap()
    for i in range(64):
        eng.set(b"w%03d" % i, b"v%d" % i, 10)
        oracle.set(b"w%03d" % i, b"v%d" % i, 10)
    eng._compact()
    before = eng.g.c_span_fallbacks.total
    _, rvs = eng.read([], [(b"w", b"x", 11, 0, False)])
    assert eng.g.c_span_fallbacks.total > before
    assert rvs[0] == oracle.get_range(b"w", b"x", 11)


def test_pallas_probe_engine_matches_port(monkeypatch):
    # the JAX engine on its Pallas probe (interpret mode on the CPU) and
    # the port on its plain probe give the same replies and counters
    monkeypatch.setattr(JKNOBS, "TPU_PROBE_KERNEL", "pallas")
    eng = Twin(n_words=2, block_slots=8)
    for i in range(50):
        eng.set(b"pp%03d" % i, b"v%d" % i, 10 + i)
    eng._compact()
    assert eng.j._probe_impl() == "pallas"
    pts = [(b"pp%03d" % i, 100) for i in range(0, 50, 3)] + [(b"nope", 100)]
    rgs = [(b"pp000", b"pp020", 100, 0, False)]
    pv, rv = eng.read(pts, rgs)
    assert pv[0] == b"v0" and pv[-1] is None and len(rv[0]) == 20


def test_decode_set_columns_matches_jax():
    from foundationdb_tpu.cluster.commit_wire import TaggedMutationBatch
    from foundationdb_tpu.cluster.interfaces import Mutation
    from foundationdb_tpu.kv.atomic import MutationType

    sets = [Mutation(MutationType.SET_VALUE, b"k%d" % i, b"val%d" % i)
            for i in range(5)]
    more = [Mutation(MutationType.SET_VALUE, b"m%d" % i, b"x" * i)
            for i in range(3)]
    tmb = TaggedMutationBatch.from_entries([(1234, sets), (1240, more)])
    tmb = TaggedMutationBatch.from_bytes(tmb.to_bytes())
    decoded = decode_set_columns(tmb)
    assert decoded == tpu_engine.decode_set_columns(tmb)
    assert decoded[0] == (1234, [m.param1 for m in sets],
                          [m.param2 for m in sets])
    assert decoded[1][0] == 1240
    mixed = sets + [Mutation(MutationType.CLEAR_RANGE, b"a", b"b")]
    tmb2 = TaggedMutationBatch.from_entries([(1235, mixed)])
    assert decode_set_columns(tmb2) is None
    # the decoded columns apply through set_bulk on both engines
    eng = Twin(n_words=1, block_slots=8)
    for ver, keys, vals in decoded:
        eng.set_bulk(keys, vals, ver)
    assert read_all(eng, [b"k3", b"m2"], [1300]) == [b"val3", b"xx"]


def test_key_width_grows_mid_stream():
    eng = Twin(n_words=1, block_slots=8)
    eng.set(b"ab", b"1", 10)
    eng.set(b"x" * 40, b"2", 11)   # > 4 bytes: forces a width regrow
    eng._compact()
    eng.set(b"y" * 100, b"3", 12)  # and again through the delta path
    got = read_all(eng, [b"ab", b"x" * 40, b"y" * 100], [20])
    assert got == [b"1", b"2", b"3"]
    # a queried key wider than the layout regrows it on the read path
    got = read_all(eng, [b"q" * 200], [20])
    assert got == [None] and eng.g._n_words == 64


# ---------------------------------------------------------------------------
# the fused read kernel on identical operands
# ---------------------------------------------------------------------------

def kernel_operands(seed: int, n_keys: int, n_delta: int, P: int, R: int):
    """A JAX engine's device arrays after random writes (base compacted,
    then `n_delta` entries in the delta) and a (W+2, P+2R) query matrix
    whose columns copy stored entries and fences with the version row
    set to -1, the stored version, +1 or I32MAX, plus random keys."""
    rng = np.random.default_rng(seed)
    eng = KeyValueStoreTPU(n_words=2, block_slots=8)
    v = 100
    for _ in range(n_keys):
        k = b"r%04d" % rng.integers(0, 3 * n_keys)
        if rng.random() < 0.2:
            eng.clear(k, v)
        else:
            eng.set(k, b"v", v)
        v += int(rng.integers(0, 3))
    eng._compact()
    for _ in range(n_delta):
        eng.set(b"r%04d" % rng.integers(0, 3 * n_keys), b"d", v)
        v += 1
    eng._fold_pending()
    arrs = [np.array(a) for a in (
        eng._d_hmat, eng._d_slots, eng._d_next, eng._d_fences,
        eng._d_dmat, eng._d_dslots, eng._d_dnext)]
    hmat, fences = arrs[0], arrs[3]
    W2, n = hmat.shape[0], P + 2 * R
    cols = np.concatenate([hmat, fences], axis=1)
    live = cols[:, cols[W2 - 2] != I32MAX]
    q = live[:, rng.integers(0, live.shape[1], n)].copy()
    vers = q[W2 - 1].astype(np.int64) + rng.integers(-1, 2, n)
    edge = rng.random(n) < 0.4
    vers[edge] = rng.choice(np.array([-1, 0, I32MAX], np.int64), edge.sum())
    q[W2 - 1] = np.clip(vers, -1, I32MAX)
    rand = rng.integers(0, n, n // 5)
    q[:W2 - 2, rand] = rng.integers(-2**31, 2**31 - 1, (W2 - 2, rand.size))
    q[:, -1] = np.asarray(eng._d_hmat)[:, -1]  # a +inf pad column
    q[W2 - 1, P:] = -1  # range endpoints ignore versions
    rv = rng.integers(0, v - eng._vbase + 2, R).astype(np.int32)
    meta = dict(F=eng.F, NB=eng.NB, B=eng.B)
    return arrs, q.astype(np.int32), rv, meta, eng


@pytest.mark.parametrize("P,R,S,n_delta", [
    (8, 0, 8, 0),      # points only, empty delta
    (8, 8, 8, 5),
    (16, 8, 16, 0),    # ranges over an empty delta
    (24, 16, 32, 30),  # next_bucket sizes
    (8, 9, 16, 12),    # R not a bucket
])
def test_read_kernel_matches_jax(P, R, S, n_delta):
    import jax.numpy as jnp

    arrs, q, rv, meta, eng = kernel_operands(P * 7 + R, 120, n_delta, P, R)
    port = gpu_engine._read_kernel_impl(
        *(torch.from_numpy(a) for a in arrs), torch.from_numpy(q),
        torch.from_numpy(rv), P=P, R=R, S=S, **meta).numpy()
    assert port.dtype == np.int32
    assert port.size == 6 * P + 4 * R + 6 * R * S
    from foundationdb_tpu.resolver.pallas_probe import fits_vmem

    probes = ["xla"] + (["pallas"] if fits_vmem(
        eng._n_words + 1, meta["NB"], meta["B"]) else [])
    assert probes == ["xla", "pallas"]
    for probe in probes:
        want = np.asarray(tpu_engine._read_kernel_impl(
            *(jnp.asarray(a) for a in arrs), jnp.asarray(q), jnp.asarray(rv),
            P=P, R=R, S=S, probe=probe, **meta))
        np.testing.assert_array_equal(port, want, err_msg=probe)


# ---------------------------------------------------------------------------
# seeded op mix against the JAX engine and the oracle, and the hand-over
# ---------------------------------------------------------------------------

def random_ops(rng, n_ops: int, v0: int = 100):
    """A seeded script of (op, args) over a small key space, versions
    rising, reads inside the window. `oldest` tracks forget_before."""
    keys = [b"m%02d" % i for i in range(30)] + [b"m%02d/long-key" % i
                                                for i in range(3)]
    v, oldest, ops = v0, 0, []
    for _ in range(n_ops):
        r = rng.random()
        k = keys[int(rng.integers(0, len(keys)))]
        if r < 0.40:
            ops.append(("set", (k, b"v%d" % v, v)))
        elif r < 0.50:
            ops.append(("clear", (k, v)))
        elif r < 0.54:
            e = keys[int(rng.integers(0, len(keys)))]
            ops.append(("clear_range", (min(k, e), max(k, e), v)))
        elif r < 0.58:
            oldest = max(oldest, v - int(rng.integers(0, 20)))
            ops.append(("forget_before", (oldest,)))
        elif r < 0.60:
            ops.append(("rollback_above", (v - int(rng.integers(0, 4)),)))
        elif r < 0.62:
            ops.append(("set_snapshot", (k, b"s%d" % v, v)))
        elif r < 0.64:
            ops.append(("_compact", ()))
        else:
            lo = max(oldest, v - 30)
            pts = [(keys[int(i)], int(rng.integers(lo, v + 2)))
                   for i in rng.integers(0, len(keys), rng.integers(0, 9))]
            rgs = []
            for _ in range(int(rng.integers(0, 4))):
                a, b = sorted(rng.integers(0, len(keys), 2))
                rgs.append((keys[int(a)], keys[int(b)] + b"\x00",
                            int(rng.integers(lo, v + 2)),
                            int(rng.integers(0, 4)), bool(rng.random() < .5)))
            ops.append(("read", (pts, rgs)))
        v += int(rng.integers(0, 3))
    return ops


def run_ops(eng, oracle, ops):
    for op, args in ops:
        if op == "read":
            pts, rgs = args
            pv, rv = eng.read(pts, rgs)
            assert pv == [oracle.get(k, v) for k, v in pts]
            assert rv == [oracle.get_range(*r) for r in rgs]
        elif op != "_compact":
            getattr(eng, op)(*args)
            getattr(oracle, op)(*args)
        else:
            eng._compact()
    assert eng.entries() == oracle.entries()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_mix_matches_jax_and_oracle(seed, knob):
    knob("STORAGE_TPU_DELTA_SLOTS", 24)
    knob("STORAGE_TPU_SPAN_CAP", 16)
    rng = np.random.default_rng(seed)
    eng = Twin(n_words=1, block_slots=8)
    oracle = VersionedMap()
    run_ops(eng, oracle, random_ops(rng, 260))
    assert eng.g.c_compactions.total > 2
    assert eng.g.c_delta_folds.total > 2
    assert eng.g.c_span_fallbacks.total > 0


def handover_state(eng: KeyValueStoreTPU) -> dict:
    """A KeyValueStoreTPU's state as plain numpy arrays, ints and lists."""
    ora = eng._oracle
    state = {
        "_keys": ora._keys, "_chains": ora._chains,
        "oldest_version": ora.oldest_version,
        "latest_version": ora.latest_version,
        "n_words": eng._n_words, "B": eng.B, "NB": eng.NB,
        "_force_compact": eng._force_compact,
    }
    for name in ("_values", "_pending", "_delta_keys", "_delta_vers",
                 "_delta_slots", "_vbase", "_n_base", "_base_abs"):
        state[name] = getattr(eng, name)
    for name, attr in (("hmat", "_d_hmat"), ("slots", "_d_slots"),
                       ("nextsame", "_d_next"), ("fences", "_d_fences"),
                       ("dmat", "_d_dmat"), ("dslots", "_d_dslots"),
                       ("dnext", "_d_dnext")):
        state[name] = np.asarray(getattr(eng, attr))
    return state


@pytest.mark.parametrize("seed", [3, 4])
def test_from_state_handover_mid_stream(seed, knob):
    knob("STORAGE_TPU_DELTA_SLOTS", 24)
    knob("STORAGE_TPU_SPAN_CAP", 16)
    rng = np.random.default_rng(seed)
    ops = random_ops(rng, 240)
    tpu = KeyValueStoreTPU(n_words=1, block_slots=8)
    oracle = VersionedMap()
    cut = 0
    # run the JAX engine alone past op 120, up to a point with writes
    # pending and a non-empty delta
    while cut < 120 or not (tpu._pending and len(tpu._delta_keys)):
        op, args = ops[cut]
        cut += 1
        if op == "read":
            tpu.read_verdicts(tpu.submit_reads(*args))
        elif op == "_compact":
            tpu._compact()
        else:
            getattr(tpu, op)(*args)
            getattr(oracle, op)(*args)
    state = handover_state(tpu)
    gpu = KeyValueStoreGPU.from_state(state, device="cpu")
    gpu.set(b"m00/other", b"x", tpu.latest_version)
    assert tpu._oracle._chains.get(b"m00/other") is None  # nothing aliased
    gpu = KeyValueStoreGPU.from_state(state, device="cpu")
    twin = Twin(gpu=gpu, tpu=tpu)
    twin.check_state()
    run_ops(twin, oracle, ops[cut:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_versioned_map_matches_jax(seed):
    """The port's VersionedMap (its forget_before visits only the keys
    its index names) against the JAX package's under a seeded mix of
    sets, clears, range clears, snapshot inserts, window moves and
    rollbacks: the same entries(), key index, version chains (trimmed
    alike), point and range reads and live count after every step, and after a hand-over of its chains
    (reindex)."""
    from foundationdb_tpu.kv.versioned_map import VersionedMap as JMap

    rng = np.random.default_rng(seed)
    mine, theirs = VersionedMap(), JMap()
    keys = [b"k%03d" % i for i in range(60)]
    v = 10
    for step in range(600):
        op = rng.random()
        k = keys[int(rng.integers(0, len(keys)))]
        if op < 0.45:
            v += int(rng.integers(0, 3))
            val = b"v%d" % step
            mine.set(k, val, v)
            theirs.set(k, val, v)
        elif op < 0.6:
            v += 1
            mine.clear(k, v)
            theirs.clear(k, v)
        elif op < 0.65:
            v += 1
            e = keys[int(rng.integers(0, len(keys)))]
            mine.clear_range(k, e, v)
            theirs.clear_range(k, e, v)
        elif op < 0.7:
            sv = max(mine.oldest_version, v - int(rng.integers(0, 20)))
            mine.set_snapshot(k, b"s%d" % step, sv)
            theirs.set_snapshot(k, b"s%d" % step, sv)
        elif op < 0.9:
            f = v - int(rng.integers(0, 15))
            mine.forget_before(f)
            theirs.forget_before(f)
        elif op < 0.93:
            r = max(mine.oldest_version, v - int(rng.integers(0, 10)))
            mine.rollback_above(r)
            theirs.rollback_above(r)
            v = r
        else:
            handed = VersionedMap()
            handed._keys = list(mine._keys)
            handed._chains = {kk: list(c) for kk, c in mine._chains.items()}
            handed.oldest_version = mine.oldest_version
            handed.latest_version = mine.latest_version
            handed.reindex()
            mine = handed
        assert mine.entries() == theirs.entries(), step
        assert mine._keys == theirs._keys, step
        assert mine._chains == theirs._chains, step  # trimmed alike
        assert len(mine) == len(theirs), step
        rv = max(mine.oldest_version, v - int(rng.integers(0, 10)))
        assert [mine.get(kk, rv) for kk in keys] == [
            theirs.get(kk, rv) for kk in keys], step
        assert mine.get_range(keys[5], keys[40], rv, 7) == theirs.get_range(
            keys[5], keys[40], rv, 7), step
