"""The port's client layers against the JAX package's, on the CPU:
the subspace layer, the directory layer with its high-contention
allocator, and TaskBucket (layers/subspace.py, directory.py,
task_bucket.py). Every case of tests/test_directory.py and the TaskBucket
cases of tests/test_taskbucket_dr.py run as written there, under each
package (tests/_torch_twins.py: the JAX package on its host backends, the
port on the same and on its device backends, device="cpu") at the same
seed; the directory prefixes the allocator hands out, the task ids and
claims, and what each case reads back are equal in all three runs."""

import pytest

from _torch_twins import Pkg, assert_all_equal, run_twins
from foundationdb_tpu.layers.subspace import Subspace as JSubspace
from foundationdb_tpu_torch.layers import Subspace as PSubspace
from foundationdb_tpu_torch.layers import subspace as psubspace


# ------------------------------------------------------------- subspace

@pytest.mark.parametrize("Subspace", [JSubspace, PSubspace])
def test_subspace(Subspace):
    """tests/test_layers_and_tools.py's case, on both packages."""
    s = Subspace((b"app",))["users"]
    k = s.pack((42, b"row"))
    assert s.contains(k)
    assert s.unpack(k) == (42, b"row")
    b, e = s.range()
    assert b < k < e
    with pytest.raises(ValueError):
        Subspace((b"other",)).unpack(k)


def test_subspace_keys_equal_the_jax_package():
    rng_items = [(), (b"a",), ("users", 42), (1, -7, b"\x00\xff", "x"),
                 (None, 3.5, True)]
    for raw in (b"", b"\x15\x01"):
        for t in rng_items:
            j, p = JSubspace(t, raw), PSubspace(t, raw)
            assert p.key() == j.key()
            for sub in rng_items:
                assert p.pack(sub) == j.pack(sub)
                assert p.range(sub) == j.range(sub)
                assert p.subspace(sub).key() == j.subspace(sub).key()
                assert p.unpack(p.pack(sub)) == j.unpack(j.pack(sub))
            assert p["k"].key() == j["k"].key()
    assert psubspace.Subspace is PSubspace


# ------------------------------------------ tests/test_directory.py

def test_directory_create_open_list_remove():
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        dl = pkg.mod("layers.directory").DirectoryLayer()

        async def body(tr):
            app = await dl.create_or_open(tr, ("app",))
            users = await dl.create_or_open(tr, ("app", "users"))
            events = await dl.create_or_open(tr, ("app", "events"))
            tr.set(users.pack((42,)), b"alice")
            tr.set(events.pack((1,)), b"login")
            return app, users, events

        app, users, events = await db.transact(body)
        assert users.key() != events.key() != app.key()
        assert len(users.key()) <= 6

        async def check(tr):
            assert await dl.exists(tr, ("app", "users"))
            assert not await dl.exists(tr, ("app", "nope"))
            names = await dl.list(tr, ("app",))
            assert sorted(names) == ["events", "users"]
            u = await dl.open(tr, ("app", "users"))
            assert u.key() == users.key()
            assert await tr.get(u.pack((42,))) == b"alice"
            return names

        names = await db.transact(check)

        async def remove(tr):
            await dl.remove(tr, ("app", "events"))

        await db.transact(remove)

        async def check2(tr):
            assert not await dl.exists(tr, ("app", "events"))
            assert await dl.list(tr, ("app",)) == ["users"]
            rows = await tr.get_range(events.key(), events.key() + b"\xff")
            assert rows == []
            return await tr.get_range(b"", b"\xff")

        rows = await db.transact(check2)
        c.stop()
        return [d.key() for d in (app, users, events)], names, rows

    prefixes, _, rows = assert_all_equal(run_twins(main))
    assert len(set(prefixes)) == 3 and rows


def test_directory_move_keeps_contents():
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        dl = pkg.mod("layers.directory").DirectoryLayer()

        async def body(tr):
            d = await dl.create_or_open(tr, ("a", "b"))
            tr.set(d.pack(("x",)), b"1")
            return d

        d = await db.transact(body)

        async def mv(tr):
            await dl.create_or_open(tr, ("c",))
            return await dl.move(tr, ("a", "b"), ("c", "b2"))

        moved = await db.transact(mv)
        assert moved.key() == d.key()

        async def check(tr):
            assert not await dl.exists(tr, ("a", "b"))
            m = await dl.open(tr, ("c", "b2"))
            assert await tr.get(m.pack(("x",))) == b"1"
            return m.key()

        key = await db.transact(check)
        c.stop()
        return d.key(), key

    assert_all_equal(run_twins(main))


def test_directory_layer_tag_conflict():
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        dl = pkg.mod("layers.directory").DirectoryLayer()

        async def body(tr):
            return (await dl.create_or_open(tr, ("typed",),
                                            layer=b"queue")).key()

        key = await db.transact(body)

        async def body2(tr):
            await dl.create_or_open(tr, ("typed",), layer=b"blob")

        with pytest.raises(ValueError) as e:
            await db.transact(body2)
        c.stop()
        return key, str(e.value)

    assert_all_equal(run_twins(main))


def test_hca_concurrent_allocations_unique():
    """Many concurrent allocators never hand out the same prefix, and
    hand out the same prefixes to the same names on both packages."""

    async def main(pkg):
        spawn = pkg.mod("core.runtime").spawn
        all_of = pkg.mod("core.actors").all_of
        c = pkg.local()
        db = c.database()
        dl = pkg.mod("layers.directory").DirectoryLayer()

        async def make(i):
            async def body(tr):
                d = await dl.create_or_open(tr, ("dirs", "d%02d" % i))
                return d.key()

            return await db.transact(body)

        tasks = [spawn(make(i)) for i in range(24)]
        keys = await all_of([t.done for t in tasks])
        assert len(set(keys)) == 24, "allocator handed out duplicate prefixes"
        c.stop()
        return list(keys)

    assert_all_equal(run_twins(main))


# ------------------------------- tests/test_taskbucket_dr.py: TaskBucket

def _tb(pkg, name):
    return pkg.mod("layers.task_bucket").TaskBucket(
        pkg.mod("layers.subspace").Subspace((name,)))


def test_taskbucket_add_claim_finish():
    async def main(pkg):
        c = pkg.local()
        db = c.database()
        tb = _tb(pkg, "tb")

        async def add(tr):
            return tb.add(tr, {b"op": b"copy", b"n": 1}, priority=1)

        tid = await db.transact(add)
        assert len(tid) == 16

        async def claim(tr):
            return await tb.get_one(tr)

        task = await db.transact(claim)
        assert task is not None
        assert task.params == {b"op": b"copy", b"n": 1}
        assert task.priority == 1

        async def fin(tr):
            tb.finish(tr, task)

        await db.transact(fin)

        async def empty(tr):
            return await tb.is_empty(tr)

        assert await db.transact(empty)
        c.stop()
        return tid, task.id, task.lease_version

    tid, claimed, _ = assert_all_equal(run_twins(main))
    assert tid == claimed


@pytest.fixture
def short_leases(monkeypatch):
    """TASKBUCKET_TIMEOUT_VERSIONS at ~0.2 s of versions on both
    packages."""
    for which in ("jax", "port"):
        knobs = Pkg(which, "host").mod("core.knobs").SERVER_KNOBS
        monkeypatch.setattr(knobs, "TASKBUCKET_TIMEOUT_VERSIONS", 200_000)


def test_taskbucket_lease_expiry_requeues(short_leases):
    async def main(pkg):
        delay = pkg.mod("core.runtime").delay
        c = pkg.local()
        db = c.database()
        tb = _tb(pkg, "tb2")

        async def add(tr):
            return tb.add(tr, {b"op": b"x"})

        tid = await db.transact(add)

        async def claim(tr):
            return await tb.get_one(tr)

        task = await db.transact(claim)
        assert task is not None
        for _ in range(10):
            await db.set(b"tick", b"t")
            await delay(0.1)

        async def sweep_and_reclaim(tr):
            return await tb.sweep_timeouts(tr)

        n = await db.transact(sweep_and_reclaim)
        assert n == 1
        task2 = await db.transact(claim)
        assert task2 is not None and task2.id == task.id
        c.stop()
        return tid, task.lease_version, task2.lease_version

    assert_all_equal(run_twins(main))


def test_taskbucket_concurrent_agents_execute_each_task_once():
    async def main(pkg):
        rt = pkg.mod("core.runtime")
        all_of = pkg.mod("core.actors").all_of
        c = pkg.local()
        db = c.database()
        tb = _tb(pkg, "tb3")
        done = []

        async def add_all(tr):
            return [tb.add(tr, {b"n": i}) for i in range(12)]

        ids = await db.transact(add_all)

        async def executor(db_, task):
            done.append(task.params[b"n"])
            await rt.delay(0.01)

        agents = [
            rt.spawn(tb.run_agent(db, executor, poll_interval=0.05,
                                  stop_when_empty=True))
            for _ in range(3)
        ]
        await all_of([a.done for a in agents])
        assert sorted(done) == list(range(12)), (
            "each task exactly once across agents")
        c.stop()
        return ids, done

    assert_all_equal(run_twins(main))
