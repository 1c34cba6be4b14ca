"""The port's operator shell (cli.py, `server.py -r cli`) on the CPU:

- `Cli(device="cpu")` and the JAX package's `Cli()` answer the same
  data-verb session with the same lines;
- the cases of tests/test_cli_management.py and the Cli cases of
  tests/test_metrics.py and tests/test_layers_and_tools.py on the port;
- the backup verbs (`backup`, `backups`, `restore`) on a file://
  container, the snapshot readable by the JAX package;
- `server.py -r cli --device cpu` serves a piped script; without a card
  and without `--device`, the shell refuses (exit 2, naming CUDA) and
  `Cli()` raises. The attached form (`--cluster-file`) is driven in
  tests/test_torch_multiprocess.py against the port's role hosts.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from foundationdb_tpu_torch.cli import Cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_SESSION = [
    "get a", "set a 1", "writemode on", "set a 1", "set b 2",
    "set c\\x00d 3", "get a", "get c\\x00d", "getrange a z",
    "getrange a z 2", "clear b", "get b", "getrange a z", "clearrange a c",
    "getrange \\x00 \\xff", "set e 5", "getrange a z 10", "bogus",
    "writemode off", "set f 6",
]


def _session(cli, lines) -> list:
    out = []
    for line in lines:
        try:
            out.append(cli.execute(line))
        except Exception as e:  # noqa: BLE001 - the refusal is the answer
            out.append(f"{type(e).__name__}: {e}")
    return out


def test_data_verbs_equal_the_jax_package():
    from foundationdb_tpu.cli import Cli as JaxCli

    jcli = JaxCli()
    try:
        want = _session(jcli, DATA_SESSION)
    finally:
        jcli.close()
    cli = Cli(device="cpu")
    try:
        got = _session(cli, DATA_SESSION)
    finally:
        cli.close()
    assert got == want
    assert "`a' is `1'" in got and "`b': not found" in got


def test_cli_management_verbs():
    cli = Cli(device="cpu")
    try:
        assert "writemode on" in cli.execute("set a 1") or "ERROR" in \
            cli.execute("set a 1")
        cli.execute("writemode on")
        assert cli.execute("set a 1") == "Committed"
        assert "a" in cli.execute("get a")
        out = cli.execute("configure storage_engine=memory redundancy=double")
        assert "Configuration changed" in out
        assert "storage_engine = memory" in cli.execute("configuration")
        assert "(none)" in cli.execute("exclude")
        out = cli.execute("exclude 3")
        assert "Excluded 3" in out
        deadline = time.time() + 30
        while time.time() < deadline:
            teams = {tuple(team)
                     for _, _, team in cli.cluster.shard_map.ranges()
                     if team}
            if all(3 not in t for t in teams):
                break
            time.sleep(0.1)
            cli.execute("getrange a b 1")
        else:
            raise AssertionError(f"tag 3 never drained: {teams}")
        assert "Excluded servers: 3" in cli.execute("exclude")
        assert cli.execute("include all") == "Included"
        assert "(none)" in cli.execute("exclude")
        out = cli.execute("throttle 500")
        assert "500" in out
        assert cli.cluster.ratekeeper.manual_limit == 500.0
        assert "cleared" in cli.execute("throttle off")
        assert cli.cluster.ratekeeper.manual_limit is None
        assert "quorum" in cli.execute("coordinators")
        assert "a" in cli.execute("get a")
    finally:
        cli.close()


def test_cli_top_and_metrics_verbs_embedded():
    cli = Cli(sharded=True, device="cpu")
    try:
        cli.write_mode = True
        for i in range(5):
            cli.execute(f"set topk{i} v{i}")
        out = cli.execute("metrics proxy.*")
        assert "proxy.txns_committed" in out
        frame = cli.top(iterations=1, interval=0.2)
        assert "commits/s" in frame and "fdbtpu top" in frame
        assert "grv/s" in frame
    finally:
        cli.close()


def test_cli_top_renders_exemplar_from_scrape():
    from foundationdb_tpu.cli import Cli as JaxCli

    prev = {"txn@h:1": [
        {"name": "proxy.txns_committed", "labels": {}, "kind": "counter",
         "value": 100},
    ]}
    cur = {"txn@h:1": [
        {"name": "proxy.txns_committed", "labels": {}, "kind": "counter",
         "value": 350},
        {"name": "proxy.grvs_served", "labels": {}, "kind": "counter",
         "value": 400},
        {"name": "proxy.commit_ms", "labels": {}, "kind": "bands",
         "value": {"bands_ms": {"1": 0, "10": 340, "inf": 350},
                   "total": 350, "exemplars": {"10": "feedface"}}},
    ]}
    frame = Cli._render_top_frame(Cli.__new__(Cli), prev, cur, 5.0)
    assert "commits/s     50.0" in frame
    assert "feedface" in frame and "trace feedface" in frame
    assert frame == JaxCli._render_top_frame(JaxCli.__new__(JaxCli), prev,
                                             cur, 5.0)


def test_cli_local_cluster_and_topology_shapes():
    """The unsharded and the machine-placed embedded clusters start on
    the device asked for and answer the data verbs."""
    for kw in ({"sharded": False}, {"topology": True}):
        cli = Cli(device="cpu", **kw)
        try:
            cli.execute("writemode on")
            assert cli.execute("set k v") == "Committed"
            assert cli.execute("get k") == "`k' is `v'"
            assert cli.cluster is not None
        finally:
            cli.close()


def test_cli_backup_verbs(tmp_path):
    """backup / backups / restore on a file:// container; the snapshot
    the port's shell wrote reads in the JAX package's container."""
    from foundationdb_tpu.backup_container import open_container

    url = f"file://{tmp_path}/shell"
    cli = Cli(device="cpu")
    try:
        cli.execute("writemode on")
        cli.execute("set k1 a")
        cli.execute("set k2 b")
        out = cli.execute(f"backup {url}")
        assert out.startswith("backup complete at version ")
        v = int(out.rsplit(" ", 1)[1])
        assert cli.execute(f"backups {url}") == str(v)
        cli.execute("clear k1")
        cli.execute("set k3 c")
        assert cli.execute(f"restore {url}") == "restored 2 rows"
        assert cli.execute("get k1") == "`k1' is `a'"
        assert cli.execute("get k3") == "`k3': not found"
        assert cli.execute(f"restore {url} {v}") == "restored 2 rows"
        assert cli.execute("backup") .startswith("usage: backup")
        assert cli.execute("backups") == "usage: backups <container-url>"
    finally:
        cli.close()
    assert open_container(url).list_snapshots() == [v]


def _run(args, script=None, env=None):
    return subprocess.run(
        [sys.executable, "-m", *args], cwd=ROOT, input=script,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_cli_end_to_end():
    """tests/test_layers_and_tools.py's case, `python -m
    foundationdb_tpu_torch.cli --device cpu`."""
    script = "\n".join([
        "writemode on", "set hello world", "set hellp x", "get hello",
        "getrange hell hellz 10", "clear hellp", "getrange hell hellz 10",
        "status", "exit"]) + "\n"
    out = _run(["foundationdb_tpu_torch.cli", "--device", "cpu"], script)
    assert out.returncode == 0, out.stderr
    assert "`hello' is `world'" in out.stdout
    assert "Recovery state: fully_recovered" in out.stdout
    assert out.stdout.count("`hellp' is") == 1


def test_server_cli_serves_a_piped_script(tmp_path):
    url = f"file://{tmp_path}/bk"
    script = "\n".join([
        "writemode on", "set s 1", "get s", "getrange a z", f"backup {url}",
        f"backups {url}", "clear s", "get s", f"restore {url}", "get s",
        "exit"]) + "\n"
    p = _run(["foundationdb_tpu_torch.server", "-r", "cli", "--device",
              "cpu"], script)
    assert p.returncode == 0, p.stderr[-3000:]
    replies = [r.strip() for r in p.stdout.split("fdbtpu> ")[1:]]
    assert replies[:4] == ["writemode on", "Committed", "`s' is `1'",
                           "`s' is `1'"]
    assert replies[4].startswith("backup complete at version ")
    assert replies[5] == replies[4].rsplit(" ", 1)[1]
    assert replies[6:10] == ["Committed", "`s': not found",
                             "restored 1 rows", "`s' is `1'"]
    # one positional verb, then exit (the operator's one-shot form)
    p = _run(["foundationdb_tpu_torch.server", "-r", "cli", "--device",
              "cpu", "status", "json"])
    assert p.returncode == 0, p.stderr[-3000:]
    assert '"recovery_state"' in p.stdout
    p = _run(["foundationdb_tpu_torch.server", "-r", "fdbd", "get", "k"])
    assert p.returncode == 2 and "for -r cli only" in p.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_without_a_card_the_shell_refuses():
    for args in (["foundationdb_tpu_torch.server", "-r", "cli"],
                 ["foundationdb_tpu_torch.cli"]):
        p = _run(args, "writemode on\nset a 1\nexit\n")
        assert p.returncode == 2, (args, p.stdout, p.stderr)
        assert "CUDA is not available" in p.stderr
        assert "fdbtpu>" not in p.stdout
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cli()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Cli(sharded=False)
