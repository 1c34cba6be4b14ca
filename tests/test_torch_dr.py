"""The port's DR agent (dr.py, DRAgent) against the JAX package's, on the
CPU: the DR cases of tests/test_taskbucket_dr.py run as written there
under each package (tests/_torch_twins.py: the JAX package on its host
backends, the port on the same and on its device backends, device="cpu")
at the same seed (the continuous writers run 0.5 s of simulated time
where the reference case runs 2 s). The destination equals the source after
wait_drained, its applied-version marker is at least the agent's, and
the rows, the applied version and the marker are equal in all three
runs."""

from _torch_twins import assert_all_equal, run_twins


async def _rows(tr):
    return await tr.get_range(b"", b"\xff")


def _local(pkg):
    return pkg.local()


def test_dr_replicates_snapshot_and_tail():
    async def main(pkg):
        dr_mod = pkg.mod("dr")
        src = pkg.sharded(n_storage=3, n_logs=2, replication="double",
                          shard_boundaries=[b"m"])
        dst = _local(pkg)
        src_db, dst_db = src.database(), dst.database()
        for i in range(10):
            await src_db.set(b"pre%02d" % i, b"v%d" % i)
        agent = dr_mod.DRAgent(src, dst_db)
        await agent.start()
        for i in range(10):
            await src_db.set(b"post%02d" % i, b"w%d" % i)
        await src_db.clear(b"pre00")

        async def atomic(tr):
            tr.add(b"counter", (5).to_bytes(8, "little"))

        await src_db.transact(atomic)
        await agent.wait_drained()
        s_rows = await src_db.transact(_rows)
        d_rows = await dst_db.transact(_rows)
        assert s_rows == d_rows and len(s_rows) == 20

        async def read_marker(tr):
            tr.options.set_read_system_keys()
            return await tr.get(dr_mod.DR_VERSION_KEY)

        marker = await dst_db.transact(read_marker)
        assert marker is not None and int(marker) >= agent.applied_version
        agent.stop()
        src.stop()
        dst.stop()
        return d_rows, agent.applied_version, marker

    assert_all_equal(run_twins(main))


def test_dr_keeps_up_under_continuous_writes():
    async def main(pkg):
        rt = pkg.mod("core.runtime")
        all_of = pkg.mod("core.actors").all_of
        src = pkg.sharded(n_storage=3, n_logs=2, replication="double",
                          shard_boundaries=[])
        dst = _local(pkg)
        src_db, dst_db = src.database(), dst.database()
        agent = pkg.mod("dr").DRAgent(src, dst_db)
        await agent.start()
        stop = [False]

        async def writer(i):
            n = 0
            while not stop[0]:
                await src_db.set(b"w%d/%04d" % (i, n % 50), b"%d" % n)
                n += 1

        ws = [rt.spawn(writer(i)) for i in range(3)]
        # 0.5 s of writes (the reference case: 2 s), a few hundred
        # commits: the device run's plain torch ops on the CPU take ~45 ms
        # a commit
        await rt.delay(0.5)
        stop[0] = True
        await all_of([w.done for w in ws])
        await agent.wait_drained()
        rows = await src_db.transact(_rows)
        assert rows == await dst_db.transact(_rows)
        agent.stop()
        src.stop()
        dst.stop()
        return rows, agent.applied_version

    rows, _ = assert_all_equal(run_twins(main))
    assert rows


def test_dr_constants_equal_the_jax_package():
    from foundationdb_tpu import dr as jdr
    from foundationdb_tpu_torch import dr as pdr

    assert (pdr.DR_VERSION_KEY, pdr.DR_TAG_BASE) == (jdr.DR_VERSION_KEY,
                                                     jdr.DR_TAG_BASE)
