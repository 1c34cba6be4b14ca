"""The port's simulator against the JAX package's, same seed, on the CPU.

- The [sim] seeds of chip_smoke.py (SIM_SEEDS) are the first 24 seeds of
  generate_config that need no unported tier, less the two the JAX
  package itself fails (5 and 25, ROADMAP Queue 3).
- Each of them (this file: the first half; the second half and the long
  seed 26 in tests/test_torch_sim_differential_more.py) gives the same
  whole run_spec result in both packages with the host backends pinned
  on both sides (CONFLICT_SET_IMPL=oracle, STORAGE_ENGINE_IMPL=memory):
  ok, every workload's check and metrics, the fingerprint, SevErrors and
  coverage. That is the list the smoke runs on the card.
- Seed 5 fails the same way on both packages: the same exception type and
  message.
- The CPU entry point: `python -m foundationdb_tpu_torch.server -r
  simulation -f specs/cycle_churn.json --device cpu` exits 0; a spec that
  needs the backup tier (specs/engine_topology_wdr.json: a durable ssd
  cluster whose BackupRestore is not ported) exits non-zero naming ROADMAP
  Queue 1 item 9; the deployed roles name item 8.
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
    is_durable,
    jax_run,
    one_torch_thread,  # noqa: F401 - an autouse fixture
    port_run,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = [s for s in SIM_SEEDS[:12] if s != 26]


def test_sim_seeds_are_the_first_runnable_seeds_the_reference_passes():
    from foundationdb_tpu_torch.sim.config import (
        generate_config,
        unported_needs,
    )

    specs = {s: generate_config(s) for s in range(200)}
    runnable = [s for s in range(200) if not unported_needs(specs[s])
                and not is_durable(specs[s])]
    assert list(SIM_SEEDS) == [
        s for s in runnable if s not in REFERENCE_SIDE_FAILURES][:24]
    # every reference-side failure below the last [sim] seed is named
    assert set(runnable[:runnable.index(SIM_SEEDS[-1])]) - set(
        SIM_SEEDS) == {s for s in REFERENCE_SIDE_FAILURES
                       if not is_durable(specs[s])}


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
    """The durable tier runs; engine_topology_wdr.json is still refused,
    by its BackupRestore (the backup tier)."""
    p = run_server("-r", "simulation", "-f",
                   "specs/engine_topology_wdr.json", "--device", "cpu")
    assert p.returncode != 0
    assert "NotImplementedError" in p.stdout
    assert "BackupRestore" in p.stdout + p.stderr
    assert "ROADMAP Queue 1 item 9" in p.stdout + p.stderr
    # a randomized spec runs what it can and names what it cannot
    spec = tmp_path / "randomized.json"
    spec.write_text(json.dumps({"randomized": True, "seeds": [2, 3]}))
    p = run_server("-r", "simulation", "-f", str(spec), "--device", "cpu",
                   "--knob", "CONFLICT_SET_IMPL=oracle")
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == {
        "ok": True, "seeds": [2, 3]}
    (line,) = [ln for ln in p.stderr.splitlines()
               if ln.startswith("[sim seed 2] not run: needs")]
    assert "ROADMAP Queue 1 item 9" in line
    assert "[sim seed 3] ok=True" in p.stderr


@pytest.mark.parametrize("role", ["fdbd", "cli"])
def test_deployed_roles_name_item_8(role):
    p = run_server("-r", role)
    assert p.returncode == 2
    assert "ROADMAP Queue 1 item 8" in p.stderr


def test_entry_point_validates_the_backend_knob_eagerly():
    p = run_server("-r", "simulation", "-f", "specs/cycle_churn.json",
                   "--device", "cpu", "--knob", "CONFLICT_SET_IMPL=native")
    assert p.returncode != 0
    assert "unknown CONFLICT_SET_IMPL 'native'" in p.stderr
