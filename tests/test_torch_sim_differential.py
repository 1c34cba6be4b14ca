"""The port's simulator against the JAX package's, same seed, on the CPU.

- The [sim] seeds of chip_smoke.py (SIM_SEEDS) are the first 24 in-memory
  seeds of generate_config that draw no backup workload, less the two
  the JAX package itself fails (5 and 25, ROADMAP Queue 3).
- Each of them (this file: the first half; the second half and the long
  seed 26 in tests/test_torch_sim_differential_more.py) gives the same
  whole run_spec result in both packages with the host backends pinned
  on both sides (CONFLICT_SET_IMPL=oracle, STORAGE_ENGINE_IMPL=memory):
  ok, every workload's check and metrics, the fingerprint, SevErrors and
  coverage. That is the list the smoke runs on the card.
- Seed 5 fails the same way on both packages: the same exception type and
  message.
- The CPU entry point: `python -m foundationdb_tpu_torch.server -r
  simulation -f specs/cycle_churn.json --device cpu` exits 0;
  specs/engine_topology_wdr.json (a durable ssd cluster with
  BackupRestore) gives the JAX package's result, the host backends pinned
  on both sides; `-r fdbd` serves and `-r cli` serves a piped script.
"""

import json
import os
import subprocess
import sys

import pytest

from _torch_sim_cases import (
    REFERENCE_SIDE_FAILURES,
    SIM_SEEDS,
    assert_jax_equals_port,
    draws_backup,
    is_durable,
    jax_run,
    one_torch_thread,  # noqa: F401 - an autouse fixture
    port_run,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = [s for s in SIM_SEEDS[:12] if s != 26]


def test_sim_seeds_are_the_first_runnable_seeds_the_reference_passes():
    """Every seed runs since the backup tier is ported; the [sim] list
    is still taken from the seeds that draw no backup workload."""
    from foundationdb_tpu_torch.sim.config import generate_config

    specs = {s: generate_config(s) for s in range(200)}
    runnable = [s for s in range(200) if not draws_backup(specs[s])
                and not is_durable(specs[s])]
    assert list(SIM_SEEDS) == [
        s for s in runnable if s not in REFERENCE_SIDE_FAILURES][:24]
    # every reference-side failure below the last [sim] seed is named
    assert set(runnable[:runnable.index(SIM_SEEDS[-1])]) - set(
        SIM_SEEDS) == {s for s in REFERENCE_SIDE_FAILURES
                       if not is_durable(specs[s])
                       and not draws_backup(specs[s])}


@pytest.mark.parametrize("seed", FIRST)
def test_jax_package_equals_the_port(seed):
    assert_jax_equals_port(seed)


def test_seed_5_fails_the_same_way_on_both_packages():
    want, got = jax_run(5), port_run(5, "host")
    assert want == {"raised": REFERENCE_SIDE_FAILURES[5]}
    assert got == want
    # and on the device backends too
    assert port_run(5, "device") == want


def run_server(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})),
    )


def test_cpu_entry_point_runs_a_spec():
    p = run_server("-r", "simulation", "-f", "specs/cycle_churn.json",
                   "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout)
    assert res["ok"] and res["sev_errors"] == 0
    assert res["ConsistencyCheck"]["ok"] and res["fingerprint"]


def test_cpu_entry_point_refuses_the_durable_tier(tmp_path):
    """The durable and the backup tiers run: engine_topology_wdr.json (an
    ssd cluster on a datadir with BackupRestore) through `-r simulation
    --device cpu` gives the JAX package's whole result, the host backends
    pinned on both sides; a randomized spec runs seed 2 (a durable
    BackupRestore) and seed 3."""
    from foundationdb_tpu.workloads.tester import run_spec

    pins = {"CONFLICT_SET_IMPL": "oracle", "STORAGE_ENGINE_IMPL": "memory"}
    path = os.path.join(ROOT, "specs", "engine_topology_wdr.json")
    p = run_server("-r", "simulation", "-f", path, "--device", "cpu",
                   *[a for k, v in pins.items()
                     for a in ("--knob", f"{k}={v}")])
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout)
    with open(path) as f:
        spec = json.load(f)
    spec["knobs"].update({f"server:{k}": v for k, v in pins.items()})
    want = json.loads(json.dumps(run_spec(spec), default=str))
    assert want["ok"] and want["BackupRestore"]["ok"], want
    assert set(got) == set(want)
    for key in sorted(want):
        assert got[key] == want[key], key
    # a randomized spec runs every seed
    spec = tmp_path / "randomized.json"
    spec.write_text(json.dumps({"randomized": True, "seeds": [2, 3]}))
    p = run_server("-r", "simulation", "-f", str(spec), "--device", "cpu",
                   "--knob", "CONFLICT_SET_IMPL=oracle")
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == {
        "ok": True, "seeds": [2, 3]}
    assert "not run" not in p.stderr
    assert "[sim seed 2] ok=True" in p.stderr
    assert "[sim seed 3] ok=True" in p.stderr


def _fdbd_serves_until_sigterm() -> None:
    """`-r fdbd --device cpu` (the in-process cluster on a real-clock
    loop) announces that it serves, and ends on SIGTERM."""
    import signal
    import threading

    p = subprocess.Popen(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r", "fdbd",
         "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    serving = threading.Event()

    def watch():
        for line in p.stderr:
            if "cluster serving" in line:
                serving.set()

    threading.Thread(target=watch, daemon=True).start()
    try:
        assert serving.wait(timeout=120), "fdbd never announced serving"
        assert p.poll() is None
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == -signal.SIGTERM
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


@pytest.mark.parametrize("role", ["fdbd", "cli"])
def test_deployed_roles_name_item_8(role):
    """The deployed tier and the operator shell are ported (ROADMAP Queue
    1 items 8 and 9): fdbd serves; `-r cli --device cpu` serves a piped
    script."""
    if role == "fdbd":
        _fdbd_serves_until_sigterm()
        return
    p = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.server", "-r", role,
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        input="writemode on\nset k v\nget k\nexit\n")
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split("fdbtpu> ")[1:4] == [
        "writemode on\n", "Committed\n", "`k' is `v'\n"]


def test_entry_point_validates_the_backend_knob_eagerly():
    p = run_server("-r", "simulation", "-f", "specs/cycle_churn.json",
                   "--device", "cpu", "--knob", "CONFLICT_SET_IMPL=native")
    assert p.returncode != 0
    assert "unknown CONFLICT_SET_IMPL 'native'" in p.stderr
