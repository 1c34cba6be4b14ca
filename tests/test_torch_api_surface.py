"""The port's binding surface against the JAX package's, on the CPU: the
fdb-style api module (`api.open(device="cpu")`), the thread-safe facade
(client/threadsafe.py), the stack tester (stack_tester.py) and IndexedSet
(kv/indexed_set.py). The cases of tests/test_api_surface.py run on the
port; the stack tester's programs from `generate_program(seed)` run under
both packages (tests/_torch_twins.py: the JAX package on its host
backends, the port on the same and on its device backends) at the same
seed and leave the same rows; IndexedSet takes the same operations to the
same contents and metric sums."""

import random
import threading

import pytest
import torch

import foundationdb_tpu_torch.api as fdb
from _torch_twins import assert_all_equal, run_twins
from foundationdb_tpu_torch.core.rand import DeterministicRandom
from foundationdb_tpu_torch.core.runtime import loop_context, sim_loop
from foundationdb_tpu_torch.kv.indexed_set import IndexedSet
from foundationdb_tpu_torch.stack_tester import StackTester, generate_program


@pytest.fixture
def psim():
    """A fresh deterministic loop of the port, made current."""
    loop = sim_loop(seed=12345)
    with loop_context(loop):
        yield loop
    loop.shutdown()


# ---------------------------------------------------- fdb-style api

def test_open_transactional_and_layers(psim):
    async def main():
        db = fdb.open(device="cpu")

        @fdb.transactional
        async def add_user(tr, uid, name):
            tr.set(fdb.tuple.pack(("users", uid)), name)

        @fdb.transactional
        async def get_user(tr, uid):
            return await tr.get(fdb.tuple.pack(("users", uid)))

        await add_user(db, 42, b"alice")
        assert await get_user(db, 42) == b"alice"

        @fdb.transactional
        async def both(tr):
            await add_user(tr, 43, b"bob")
            return await get_user(tr, 43)

        assert await both(db) == b"bob"

        async def mk(tr):
            d = await fdb.directory.create_or_open(tr, ("app",))
            tr.set(d.pack(("x",)), b"1")
            return d

        d = await db.transact(mk)
        assert await db.get(d.pack(("x",))) == b"1"
        db.cluster.stop()

    psim.run(main())


def test_open_starts_the_embedded_cluster_on_the_device(psim):
    from foundationdb_tpu_torch.resolver.gpu import ConflictSetGPU
    from foundationdb_tpu_torch.storage_engine.gpu_engine import (
        KeyValueStoreGPU,
    )

    db = fdb.open(device="cpu")
    assert isinstance(db.cluster.resolver.cs, ConflictSetGPU)
    assert db.cluster.resolver.cs.device.type == "cpu"
    assert isinstance(db.cluster.storage.data, KeyValueStoreGPU)
    db.cluster.stop()
    db = fdb.open(sharded=True, device="cpu", n_storage=3)
    assert len(db.cluster.storages) == 3
    db.cluster.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fdb.open()


def test_api_surface_equals_the_jax_package():
    import foundationdb_tpu.api as jfdb

    assert sorted(fdb.__all__) == sorted(jfdb.__all__)
    assert fdb.tuple.pack(("users", 42)) == jfdb.tuple.pack(("users", 42))


def test_database_level_default_options(psim):
    async def main():
        db = fdb.open(device="cpu")
        db.options.set_transaction_retry_limit(0)
        tr = db.create_transaction()
        assert tr._retries_left == 0
        db.cluster.stop()

    psim.run(main())


# ---------------------------------------------- thread-safe facade

def test_threadsafe_database_cross_thread(psim):
    from foundationdb_tpu_torch.client.threadsafe import ThreadSafeDatabase
    from foundationdb_tpu_torch.core.runtime import delay

    async def main():
        db = fdb.open(device="cpu")
        ts = ThreadSafeDatabase(db)
        futs = []

        def worker():
            for i in range(5):
                async def body(tr, i=i):
                    tr.set(b"t%d" % i, b"v%d" % i)
                    return i

                futs.append(ts.run(body))

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        for _ in range(2000):
            await delay(0.001)
            if len(futs) == 5 and all(f.done() for f in futs):
                break
        assert sorted(f.result(timeout=0) for f in futs) == list(range(5))
        for i in range(5):
            assert await db.get(b"t%d" % i) == b"v%d" % i
        ts.close()
        db.cluster.stop()

    psim.run(main())


# -------------------------------------------------------- stack tester

@pytest.mark.parametrize("seed", range(5))
def test_stack_programs_match_model(seed):
    """The program runs and matches the model on each run, and all three
    runs leave the same rows."""
    prog = generate_program(random.Random(seed), n_txns=6)

    async def main(pkg):
        db = pkg.mod("api").open(cluster=pkg.local())
        st = pkg.mod("stack_tester").StackTester(db)
        await st.run(prog)
        assert await st.check(), "api diverged from the model"
        rows = await db.transact(lambda tr: tr.get_range(b"", b"\xff"))
        db.cluster.stop()
        return rows

    assert_all_equal(run_twins(main, seed=seed))


def test_stack_programs_equal_the_jax_package():
    from foundationdb_tpu.stack_tester import (
        generate_program as jax_generate_program,
    )

    for seed in range(20):
        assert generate_program(random.Random(seed), n_txns=6) == \
            jax_generate_program(random.Random(seed), n_txns=6)


def test_stack_reset_discards(psim):
    async def main():
        db = fdb.open(device="cpu")
        st = StackTester(db)
        await st.run([
            ("NEW_TRANSACTION",),
            ("PUSH", b"st/key"), ("PUSH", b"gone"), ("SET",),
            ("RESET",),
            ("PUSH", b"st/key"), ("GET",), ("POP",),
            ("COMMIT",),
        ])
        assert await st.check()
        assert await db.get(b"st/key") is None
        db.cluster.stop()

    psim.run(main())


# ---------------------------------------------------------- IndexedSet

def test_indexed_set_map_and_metrics():
    s = IndexedSet(random=DeterministicRandom(7))
    rng = random.Random(3)
    model = {}
    for _ in range(2000):
        k = rng.randrange(500)
        if rng.random() < 0.3 and model:
            s.erase(k)
            model.pop(k, None)
        else:
            m = rng.randrange(1, 100)
            s.insert(k, f"v{k}", metric=m)
            model[k] = m
    assert len(s) == len(model)
    assert list(s) == [(k, f"v{k}") for k in sorted(model)]
    for lo, hi in [(0, 500), (10, 20), (100, 400), (499, 499)]:
        want = sum(m for k, m in model.items() if lo <= k < hi)
        assert s.sum_range(lo, hi) == want
        assert s.sum_to(hi) - s.sum_to(lo) == want
    total = sum(model.values())
    keys = sorted(model)
    acc = 0
    for k in keys[:50]:
        assert s.index_of_metric(acc) == k
        acc += model[k]
    assert s.index_of_metric(total) is None
    assert s.index_of_metric(total - 1) == keys[-1]


def test_indexed_set_split_point_usage():
    s = IndexedSet(random=DeterministicRandom(1))
    for i in range(1000):
        s.insert(i, None, metric=10)
    mid = s.index_of_metric(s.sum_range(0, 1000) // 2)
    assert 450 <= mid <= 550


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexed_set_equals_the_jax_package(seed):
    from foundationdb_tpu.core.rand import DeterministicRandom as JRandom
    from foundationdb_tpu.kv.indexed_set import IndexedSet as JIndexedSet

    p, j = IndexedSet(random=DeterministicRandom(seed)), \
        JIndexedSet(random=JRandom(seed))
    rng = random.Random(seed)
    for _ in range(1500):
        k = rng.randrange(300)
        if rng.random() < 0.3:
            p.erase(k)
            j.erase(k)
        else:
            m = rng.randrange(1, 50)
            p.insert(k, k * 3, metric=m)
            j.insert(k, k * 3, metric=m)
    assert list(p) == list(j) and len(p) == len(j)
    for lo in range(0, 300, 37):
        assert p.sum_range(lo, lo + 50) == j.sum_range(lo, lo + 50)
        assert p.index_of_metric(lo * 7) == j.index_of_metric(lo * 7)
