"""Launch and drive a multi-process cluster of either package on this
machine: role hosts as OS processes (`python -m <package>.server -r fdbd
-c <class>`), each in its own session so that teardown kills its whole
process group, discovered through a shared cluster file; the calling
process is the client, on a real-clock loop of the same package. The
port's hosts get `--device cpu`.

Every wait is bounded: the startup deadline, the client loop's
`timeout_sim_seconds`, and `wait(timeout=...)` in teardown."""

from __future__ import annotations

import importlib
import os
import signal
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "foundationdb_tpu_torch"
JAX = "foundationdb_tpu"

SPEC = {
    "n_storage": 4,
    "n_logs": 2,
    "replication": "double",
    "shard_boundaries": ["m"],
    "engine": "memory",
    "seed": 1,
}


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def mod(pkg: str, name: str):
    """`<pkg>.<name>`, e.g. mod(PORT, "cluster.multiprocess")."""
    return importlib.import_module(f"{pkg}.{name}")


def host_cmd(pkg: str, cls: str, cf: str, datadir: str, *extra) -> list:
    cmd = [sys.executable, "-m", f"{pkg}.server", "-r", "fdbd", "-c", cls,
           "-C", cf, "-d", datadir, *extra]
    if pkg == PORT:
        cmd += ["--device", "cpu"]
    return cmd


def spawn_host(pkg: str, cls: str, cf: str, datadir: str, env=None):
    # Own process group per host: teardown kills the whole group, so a
    # crashed or hung run cannot leak role processes.
    return subprocess.Popen(
        host_cmd(pkg, cls, cf, datadir), cwd=ROOT, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env=None if env is None else dict(os.environ, **env),
    )


def launch(tmp_path, classes=("log", "storage", "txn"), spec_extra=None,
           pkg: str = PORT, deadline_s: float = 90.0):
    """Write the cluster file and start one host per class; returns (cf,
    procs) once every class has merged its address."""
    cf = str(tmp_path / "cluster.json")
    mp = mod(pkg, "cluster.multiprocess")
    ports = free_ports(len(classes))
    spec = dict(SPEC, **(spec_extra or {}), ports=dict(zip(classes, ports)))
    mp.write_cluster_file(cf, {"spec": spec})
    procs = [spawn_host(pkg, cls, cf, str(tmp_path / "data" / cls))
             for cls in classes]
    deadline = time.time() + deadline_s
    try:
        while time.time() < deadline:
            info = mp.read_cluster_file(cf) or {}
            if all(c in info for c in classes):
                return cf, procs
            for p in procs:
                if p.poll() is not None:
                    raise RuntimeError(
                        f"role host died rc={p.returncode}: "
                        f"{p.stderr.read()[-2000:]}"
                    )
            time.sleep(0.1)
        raise RuntimeError("cluster did not come up")
    except BaseException:
        teardown(procs)
        raise


def teardown(procs):
    def group(p, sig):
        try:
            os.killpg(os.getpgid(p.pid), sig)
        except (ProcessLookupError, PermissionError):
            pass

    for p in procs:
        group(p, signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            group(p, signal.SIGKILL)
            p.wait(timeout=10)
        if p.stderr is not None:
            p.stderr.close()


def client_run(cf, coro_fn, timeout_s=120, pkg: str = PORT):
    """Run an async client body on a real-clock loop with a transport."""
    runtime = mod(pkg, "core.runtime")
    transport_mod = mod(pkg, "net.transport")
    mp = mod(pkg, "cluster.multiprocess")
    loop, transport = transport_mod.real_loop_with_transport()
    with runtime.loop_context(loop):
        db = mp.connect(transport, cf)
        try:
            return loop.run(coro_fn(db), timeout_sim_seconds=timeout_s)
        finally:
            transport.close()
