"""The port's deployed tier over REAL OS processes on localhost TCP: the
cases of tests/test_multiprocess.py on foundationdb_tpu_torch's role hosts
(log, storage, resolver and txn hosts started by `python -m
foundationdb_tpu_torch.server -r fdbd -c <class> --device cpu`), and a
same-operations differential against a JAX-package cluster. The kill and
relaunch cases are in test_torch_multiprocess_faults.py."""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from _torch_mp import (
    JAX,
    PORT,
    ROOT,
    client_run,
    free_ports,
    launch,
    mod,
    teardown,
)


@pytest.fixture()
def cluster3(tmp_path):
    cf, procs = launch(tmp_path)
    try:
        yield cf, procs
    finally:
        teardown(procs)


def test_end_to_end_over_three_processes(cluster3):
    cf, _procs = cluster3

    async def body(db):
        # Writes spanning both shards (boundary at b"m").
        for i in range(20):
            await db.set(b"a%02d" % i, b"v%d" % i)
            await db.set(b"z%02d" % i, b"w%d" % i)
        for i in range(20):
            assert await db.get(b"a%02d" % i) == b"v%d" % i
            assert await db.get(b"z%02d" % i) == b"w%d" % i
        # A transaction with a read-write cycle + conflict semantics.
        tr = db.create_transaction()
        v = await tr.get(b"a00")
        tr.set(b"rw", v)
        await tr.commit()
        assert await db.get(b"rw") == b"v0"
        return True

    assert client_run(cf, body)


def test_commit_wire_vs_object_parity(cluster3):
    """The columnar CommitBatchRequest path and the direct per-object
    commit path are observationally identical against the same live
    cluster (the client knob flips per run)."""
    cf, _procs = cluster3
    from foundationdb_tpu_torch.core.actors import all_of
    from foundationdb_tpu_torch.core.errors import NotCommitted
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS
    from foundationdb_tpu_torch.core.runtime import spawn

    old = CLIENT_KNOBS.COMMIT_WIRE_BATCH

    def run_ops(prefix: bytes, wire: bool):
        async def body(db):
            CLIENT_KNOBS.COMMIT_WIRE_BATCH = wire

            async def one(i):
                tr = db.create_transaction()
                tr.set(prefix + b"%03d" % i, b"v%d" % i)
                return await tr.commit()

            tasks = [spawn(one(i), name=f"w{i}") for i in range(24)]
            versions = await all_of([t.done for t in tasks])
            tr = db.create_transaction()
            got = await tr.get(prefix + b"000")
            tr.set(prefix + b"rw", got)
            vs_f = tr.get_versionstamp()
            await tr.commit()
            stamp = await vs_f
            t1 = db.create_transaction()
            t2 = db.create_transaction()
            a = await t1.get(prefix + b"000")
            b = await t2.get(prefix + b"000")
            t1.set(prefix + b"000", a + b"!")
            t2.set(prefix + b"000", b + b"?")
            await t1.commit()
            conflicted = False
            try:
                await t2.commit()
            except NotCommitted:
                conflicted = True
            rows = {
                i: await db.get(prefix + b"%03d" % i) for i in range(24)
            }
            return {
                "versions_sorted": versions == sorted(versions),
                "rw": await db.get(prefix + b"rw"),
                "stamp_len": len(stamp),
                "conflicted": conflicted,
                "rows": rows,
            }

        return client_run(cf, body, timeout_s=180)

    try:
        obj = run_ops(b"obj/", wire=False)
        wir = run_ops(b"wire/", wire=True)
    finally:
        CLIENT_KNOBS.COMMIT_WIRE_BATCH = old
    for k in ("versions_sorted", "stamp_len", "conflicted"):
        assert obj[k] == wir[k], (k, obj[k], wir[k])
    assert obj["versions_sorted"] and obj["conflicted"]
    assert obj["rw"] == b"v0" and wir["rw"] == b"v0"
    assert obj["rows"].keys() == wir["rows"].keys()
    for i in range(1, 24):
        assert obj["rows"][i] == wir["rows"][i] == b"v%d" % i


def test_peek_wire_vs_object_parity(tmp_path):
    """TLOG_PEEK_WIRE is a server knob (the log host encodes the columnar
    peek reply): one deployment per format, the same workload, the
    applied keyspace fingerprint equal."""
    import hashlib

    def run_cluster(sub: str, wire: bool) -> str:
        base = tmp_path / sub
        base.mkdir()
        cf, procs = launch(
            base, spec_extra={"knobs": {"server:TLOG_PEEK_WIRE": wire}})
        try:
            async def body(db):
                for i in range(40):
                    await db.set(b"a%03d" % i, b"v%d" % (i * 7))
                    await db.set(b"z%03d" % i, b"w" * (i % 23))
                tr = db.create_transaction()
                tr.clear_range(b"a010", b"a015")
                await tr.commit()
                rows = []
                for i in range(40):
                    rows.append((b"a%03d" % i, await db.get(b"a%03d" % i)))
                    rows.append((b"z%03d" % i, await db.get(b"z%03d" % i)))
                assert [v for _, v in rows[20:30:2]] == [None] * 5
                h = hashlib.sha256()
                for k, v in rows:
                    h.update(k)
                    h.update(b"\x00" if v is None else b"\x01" + v)
                return h.hexdigest()

            return client_run(cf, body, timeout_s=180)
        finally:
            teardown(procs)

    assert run_cluster("obj", wire=False) == run_cluster("wire", wire=True)


def test_cycle_workload_over_processes(cluster3):
    cf, _procs = cluster3

    async def body(db):
        from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

        w = CycleWorkload(db, nodes=12)
        await w.setup()
        await w.start(clients=3, txns_per_client=15)
        assert await w.check(), "cycle invariant broken over the wire"
        return True

    assert client_run(cf, body)


def c_client_roundtrip(addr: str) -> None:
    """The C wire client against a txn host's single-address endpoints:
    GRV, a blind set committed, read back at a fresh snapshot."""
    import ctypes

    from foundationdb_tpu_torch.storage_engine import _native

    lib = _native.load_c_client()
    host, port = addr.rsplit(":", 1)
    h = lib.fdbc_connect(host.encode(), int(port))
    assert h, "C client could not connect to the txn host"
    try:
        rv = lib.fdbc_get_read_version(h)
        assert rv >= 0
        lib.fdbc_tr_set(h, b"ckey", 4, b"cval", 4)
        cv = lib.fdbc_commit(h, rv, None, 0)
        assert cv > 0, cv
        rv2 = lib.fdbc_get_read_version(h)
        out = ctypes.c_void_p()
        ln = ctypes.c_uint32()
        st = lib.fdbc_get(h, b"ckey", 4, rv2, ctypes.byref(out),
                          ctypes.byref(ln))
        assert st == 1
        assert ctypes.string_at(out, ln.value) == b"cval"
    finally:
        lib.fdbc_destroy(h)


def test_c_client_against_txn_host(cluster3):
    """The native C wire client, built by the port's _native.py, commits
    against the port's txn host (GRV/commit + read forwarder)."""
    cf, _procs = cluster3
    from foundationdb_tpu_torch.cluster.multiprocess import read_cluster_file

    c_client_roundtrip(read_cluster_file(cf)["txn"])


def test_resolver_host_and_balancer_over_the_wire(tmp_path):
    """Five processes: 2 log hosts + storage + a RESOLVER host (2
    resolvers over the keyspace) + txn. The proxy's phase-2 fan-out, the
    verdict merge, the balancer's pulls and the hot-boundary move ride the
    real transport; a skewed workload must move a boundary. The balancer
    moves one only after a 0.25 s tick that saw 64 resolved keys
    (ResolutionBalancer.min_load), which a loaded host may take several
    rounds to give, so Cycle rounds on the hot keys go on until the txn
    host traces the move, under a wall deadline of their own; one more
    round then runs under the moved boundary."""
    classes = ("log0", "log1", "storage", "resolver", "txn")
    cf, procs = launch(
        tmp_path, classes,
        spec_extra={"n_log_hosts": 2, "n_logs": 2, "n_resolvers": 2},
    )
    trace_path = tmp_path / "data" / "txn" / "trace.jsonl"

    def moved() -> bool:
        return (trace_path.exists()
                and "ResolutionBoundaryMoved" in trace_path.read_text())

    try:
        async def body(db):
            from foundationdb_tpu_torch.core.errors import NotCommitted
            from foundationdb_tpu_torch.workloads.cycle import CycleWorkload

            await db.set(b"hot", b"0")
            tr1 = db.create_transaction()
            tr2 = db.create_transaction()
            assert await tr1.get(b"hot") == b"0"
            assert await tr2.get(b"hot") == b"0"
            tr1.set(b"hot", b"1")
            await tr1.commit()
            tr2.set(b"hot", b"2")
            with pytest.raises(NotCommitted):
                await tr2.commit()
            w = CycleWorkload(db, nodes=10)
            await w.setup()
            await w.start(clients=3, txns_per_client=20)
            assert await w.check(), "cycle invariant over remote resolvers"
            deadline = time.monotonic() + MOVE_DEADLINE_S
            rounds = 0
            while not moved() and time.monotonic() < deadline:
                w2 = CycleWorkload(db, nodes=10)
                await w2.setup()
                await w2.start(clients=3, txns_per_client=20)
                assert await w2.check()
                rounds += 1
            if moved():
                w3 = CycleWorkload(db, nodes=10)
                await w3.setup()
                await w3.start(clients=2, txns_per_client=10)
                assert await w3.check(), "cycle invariant after the move"
            return rounds

        rounds = client_run(cf, body, timeout_s=240)
    finally:
        teardown(procs)
    trace = trace_path.read_text()
    assert "ResolverHostRecruited" in (
        (tmp_path / "data" / "resolver" / "trace.jsonl").read_text()
    )
    assert "ResolutionBoundaryMoved" in trace, (
        f"hot boundary never moved over the wire ({rounds} more Cycle "
        f"rounds in {MOVE_DEADLINE_S} s)"
    )


# How long the balancer test drives Cycle rounds for a boundary move (wall
# seconds): it moved within the first rounds alone and beside six busy
# test processes.
MOVE_DEADLINE_S = 60.0


# Each package's operator shell attached to the port's role hosts: the JAX
# package's (the reference reads the port's deployment) and the port's
# (attached, it holds no device).
SHELLS = ("foundationdb_tpu", "foundationdb_tpu_torch")


def shell_class(package: str):
    import importlib

    return importlib.import_module(f"{package}.cli").Cli


@pytest.mark.parametrize("shell", SHELLS)
def test_flight_recorder_end_to_end(tmp_path, shell):
    """With sampling forced on in the port's client, commit through a
    4-process port cluster; the operator shell, attached by cluster file,
    stitches the timeline over the wire: GRV, batch attach, resolver
    submit and verdict, tlog durability and quorum ack, reply, from >= 3
    processes, in causal order."""
    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS

    Cli = shell_class(shell)

    classes = ("log", "storage", "resolver", "txn")
    cf, procs = launch(tmp_path, classes, spec_extra={"n_resolvers": 1})
    try:
        CLIENT_KNOBS.COMMIT_SAMPLE_RATE = 1.0

        async def body(db):
            tr = db.create_transaction()
            await tr.get(b"fr/key")
            tr.set(b"fr/key", b"v1")
            await tr.commit()
            return tr.debug_id

        debug_id = client_run(cf, body)
        assert debug_id, "sampled transaction drew no debug ID"
        cli = Cli(cluster_file=cf)
        try:
            timeline = cli.trace_timeline(debug_id)
            rendered = cli.execute(f"trace {debug_id}")
            tailed = cli.execute("events --type TransactionAttach --last 5")
        finally:
            cli.close()
    finally:
        CLIENT_KNOBS.COMMIT_SAMPLE_RATE = 0.0
        teardown(procs)

    assert timeline, "no flight-recorder events returned"
    assert len({p for p, _ in timeline}) >= 3
    micro = [e for _, e in timeline if e["Type"] == "TransactionDebug"]
    locs = {e["Location"] for e in micro}
    hops = ("GRV.Reply", "Commit.BatchFormed", "Resolver.Submit",
            "Resolver.Verdict", "TLog.Durable", "TLog.QuorumAck",
            "Commit.Reply")
    for hop in hops:
        assert hop in locs, f"missing hop {hop} (have {sorted(locs)})"
    assert any(e["Type"] == "TransactionAttach" and e["DebugID"] == debug_id
               for _, e in timeline), "txn->batch attach edge missing"
    times = [e["Time"] for _, e in timeline]
    assert times == sorted(times)
    first = [min(e["Time"] for e in micro if e["Location"] == h)
             for h in hops]
    assert first == sorted(first)
    assert "Resolver.Submit" in rendered and "TLog.QuorumAck" in rendered
    assert any("resolver@" in line for line in rendered.splitlines())
    assert "TransactionAttach" in tailed


@pytest.mark.parametrize("shell", SHELLS)
def test_metrics_plane_end_to_end(tmp_path, shell):
    """Against a 4-process port cluster under load: the shell's
    `top` renders live per-role rates from >= 3 processes, `metrics`
    answers a pattern query over the wire, the port txn host's HTTP
    exposition serves parseable Prometheus text (the port's
    `probe.launches_total` gauge among it), and a hot commit band's
    exemplar resolves through `trace` to a cross-process timeline."""
    import urllib.request

    from foundationdb_tpu_torch.core.knobs import CLIENT_KNOBS
    from test_metrics import _PROM_COMMENT, _PROM_SAMPLE

    Cli = shell_class(shell)

    (mport,) = free_ports(1)
    classes = ("log", "storage", "resolver", "txn")
    cf, procs = launch(
        tmp_path, classes,
        spec_extra={"n_resolvers": 1, "metrics_ports": {"txn": mport}},
    )
    try:
        CLIENT_KNOBS.COMMIT_SAMPLE_RATE = 1.0

        async def load(db):
            from foundationdb_tpu_torch.core.runtime import current_loop

            end = current_loop().now() + 6.0
            i = 0
            while current_loop().now() < end:
                await db.set(b"mp/%04d" % (i % 64), b"v%d" % i)
                i += 1
            return i

        loader = {}

        def run_load():
            loader["commits"] = client_run(cf, load, timeout_s=180)

        t = threading.Thread(target=run_load)
        cli = Cli(cluster_file=cf)
        try:
            t.start()
            time.sleep(1.0)  # let the loader ramp before the top window
            frame = cli.top(iterations=2, interval=1.5)
            t.join(timeout=180)
            one_shot = cli.execute("metrics proxy.txns_*")
            launches = cli.execute("metrics probe.*")
            m_ex = re.search(r"exemplar: (\S+)", frame)
            assert m_ex, f"top surfaced no hot-band exemplar:\n{frame}"
            dbg = m_ex.group(1)
            timeline = cli.trace_timeline(dbg)
            rendered = cli.execute(f"trace {dbg}")
        finally:
            cli.close()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{mport}/metrics", timeout=20
        ).read().decode()
    finally:
        CLIENT_KNOBS.COMMIT_SAMPLE_RATE = 0.0
        teardown(procs)

    assert loader["commits"] > 50, loader
    assert len([ln for ln in frame.splitlines() if "] " in ln]) >= 3, frame
    m = re.search(r"commits/s\s+([0-9.]+)", frame)
    assert m and float(m.group(1)) > 0, frame
    assert "tlog qbytes" in frame and "storage v" in frame
    assert "proxy.txns_committed" in one_shot
    # every role host serves the port's launch gauge (0 on the CPU)
    assert launches.count("probe.launches_total") >= 4, launches
    assert "fdbtpu_proxy_txns_committed" in body
    assert "fdbtpu_process_resident_bytes" in body
    assert "fdbtpu_probe_launches_total 0" in body
    for line in body.strip().splitlines():
        if line.startswith("#"):
            assert _PROM_COMMENT.match(line), line
        else:
            assert _PROM_SAMPLE.match(line), line
    assert timeline, f"exemplar {dbg} produced no trace events"
    assert len({p for p, _ in timeline}) >= 2
    assert "Resolver.Submit" in rendered or "TLog.Durable" in rendered


# ---------------------------------------------------------------------------
# the same operations against a JAX-package cluster and a port cluster
# ---------------------------------------------------------------------------

def differential_ops(seed: int, n_keys: int = 24, nodes: int = 10,
                     swaps: int = 12) -> dict:
    """A fixed operation sequence drawn from a numpy seed: serial sets,
    gets and range reads, a stale-snapshot pair, and Cycle swaps over
    `nodes` nodes."""
    rng = np.random.default_rng(seed)
    keys = [b"d/%03d" % k for k in rng.choice(900, n_keys, replace=False)]
    return {
        "sets": [(k, b"v%d" % rng.integers(1 << 30)) for k in keys],
        "gets": [keys[i] for i in rng.integers(0, n_keys, 16)]
        + [b"d/absent"],
        "ranges": [tuple(sorted((b"d/%03d" % a, b"d/%03d" % b)))
                   for a, b in rng.integers(0, 1000, (6, 2))],
        "nodes": nodes,
        "swaps": [int(r) for r in rng.integers(0, nodes, swaps)],
    }


def differential_body(pkg: str, ops: dict):
    """The client body of the differential on package `pkg`: every reply
    and outcome in order (versions left out: the clock is real)."""
    NotCommitted = mod(pkg, "core.errors").NotCommitted

    def ck(i):
        return b"c/%02d" % i

    async def body(db):
        out = []
        for k, v in ops["sets"]:
            await db.set(k, v)
        for k in ops["gets"]:
            out.append(("get", k, await db.get(k)))
        for b, e in ops["ranges"]:
            tr = db.create_transaction()
            out.append(("range", b, e, list(await tr.get_range(b, e))))
        # a stale snapshot's rewrite conflicts; a blind write does not
        k = ops["sets"][0][0]
        t1, t2, t3 = (db.create_transaction() for _ in range(3))
        for t in (t1, t2):
            out.append(("snap", await t.get(k)))
        t1.set(k, b"first")
        t2.set(k, b"second")
        t3.set(k + b"/blind", b"b")
        for t in (t1, t2, t3):
            try:
                await t.commit()
                out.append(("commit", "committed"))
            except NotCommitted:
                out.append(("commit", "not_committed"))
        # Cycle: node i -> i+1, then swaps r -> a -> b -> c into
        # r -> b -> a -> c, one transaction each, serially
        n = ops["nodes"]
        tr = db.create_transaction()
        for i in range(n):
            tr.set(ck(i), b"%d" % ((i + 1) % n))
        await tr.commit()
        for r in ops["swaps"]:
            tr = db.create_transaction()
            a = int(await tr.get(ck(r)))
            b = int(await tr.get(ck(a)))
            c = int(await tr.get(ck(b)))
            tr.set(ck(r), b"%d" % b)
            tr.set(ck(b), b"%d" % a)
            tr.set(ck(a), b"%d" % c)
            await tr.commit()
            out.append(("swap", r, a, b, c))
        tr = db.create_transaction()
        out.append(("final", list(await tr.get_range(b"", b"\xff"))))
        return out

    return body


@pytest.mark.parametrize("seed", [5, 17])
def test_same_operations_as_a_jax_cluster(tmp_path, seed):
    """The same operations through a JAX-package 3-process cluster and a
    port 3-process cluster: equal read replies, commit outcomes, Cycle
    reads and final range read."""
    ops = differential_ops(seed)
    got = {}
    for pkg in (JAX, PORT):
        base = tmp_path / pkg
        base.mkdir()
        cf, procs = launch(base, pkg=pkg)
        try:
            got[pkg] = client_run(cf, differential_body(pkg, ops),
                                  timeout_s=180, pkg=pkg)
        finally:
            teardown(procs)
    assert got[JAX] == got[PORT]
    outcomes = [o[1] for o in got[PORT] if o[0] == "commit"]
    assert outcomes == ["committed", "not_committed", "committed"]
    final = dict(got[PORT][-1][1])
    assert len([k for k in final if k.startswith(b"c/")]) == ops["nodes"]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_machine_spawns_the_port_server_with_the_same_device(tmp_path):
    """`-m <machine>` starts every class of its machine as this package's
    server with the launcher's --device; the cluster serves."""
    from foundationdb_tpu_torch.cluster.multiprocess import (
        read_cluster_file,
        write_cluster_file,
    )

    cf = str(tmp_path / "cluster.json")
    classes = ("log", "storage", "txn")
    spec = dict(n_storage=2, n_logs=1, replication="single",
                engine="memory", seed=1,
                ports=dict(zip(classes, free_ports(3))),
                machines={"m0": list(classes)})
    write_cluster_file(cf, {"spec": spec})
    p = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r",
         "fdbd", "-m", "m0", "-C", cf, "-d", str(tmp_path / "m0"),
         "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        deadline = time.time() + 90
        while time.time() < deadline:
            info = read_cluster_file(cf) or {}
            if all(c in info for c in classes):
                break
            assert p.poll() is None, p.stderr.read()[-2000:]
            time.sleep(0.1)
        else:
            raise AssertionError("machine did not come up")
        pids = subprocess.run(
            ["ps", "-o", "pid=", "--ppid", str(p.pid)],
            capture_output=True, text=True, timeout=30,
        ).stdout.split()
        children = [
            open(f"/proc/{pid}/cmdline").read().replace("\0", " ")
            for pid in pids
        ]
        assert len(children) == 3, children
        for line in children:
            assert "-m foundationdb_tpu_torch.server" in line, line
            assert "--device cpu" in line, line

        async def body(db):
            await db.set(b"mk", b"mv")
            return await db.get(b"mk")

        assert client_run(cf, body) == b"mv"
        assert os.path.exists(tmp_path / "m0" / "kill.sh")
        # SIGTERM to the launcher alone: it stops its children, exits 0
        p.terminate()
        assert p.wait(timeout=60) == 0
    finally:
        teardown([p])


@pytest.mark.parametrize("cls", ["resolver", "storage", "txn"])
def test_device_classes_need_the_card(tmp_path, cls):
    """Without a card and without --device cpu, the classes that keep
    device state exit nonzero naming CUDA before they publish their
    address."""
    from foundationdb_tpu_torch.cluster.multiprocess import (
        read_cluster_file,
        write_cluster_file,
    )

    cf = str(tmp_path / "cluster.json")
    write_cluster_file(cf, {"spec": {"ports": {cls: free_ports(1)[0]}}})
    p = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r",
         "fdbd", "-c", cls, "-C", cf, "-d", str(tmp_path / cls)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert cls not in read_cluster_file(cf)


def test_log_class_serves_without_the_card(tmp_path):
    """A log host holds no device state: it serves with no card and no
    --device, and stops on SIGTERM."""
    from foundationdb_tpu_torch.cluster.multiprocess import (
        read_cluster_file,
        write_cluster_file,
    )

    cf = str(tmp_path / "cluster.json")
    write_cluster_file(cf, {"spec": {"n_logs": 2, "n_log_hosts": 2,
                                     "ports": {"log0": free_ports(1)[0]}}})
    p = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r",
         "fdbd", "-c", "log0", "-C", cf, "-d", str(tmp_path / "log0")],
        cwd=ROOT, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        deadline = time.time() + 60
        while "log0" not in (read_cluster_file(cf) or {}):
            assert p.poll() is None, p.stderr.read()[-2000:]
            assert time.time() < deadline, "log0 did not come up"
            time.sleep(0.1)
    finally:
        teardown([p])
    assert p.returncode == 0
