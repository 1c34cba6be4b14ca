"""Shared cases of the simulator differentials
(tests/test_torch_sim_differential*.py, tests/test_torch_sim_backends*.py).

A seed of sim/config.generate_config runs through each package's
run_spec on the CPU (a durable seed on a temporary datadir of its own,
removed after the run):

- `jax_run(seed)`: the JAX package, the host backends pinned (its
  CONFLICT_SET_IMPL=oracle, STORAGE_ENGINE_IMPL=memory);
- `port_run(seed, "host")`: the port, the same knobs pinned;
- `port_run(seed, "device")`: the port with its device backends pinned
  (CONFLICT_SET_IMPL=gpu, STORAGE_ENGINE_IMPL=gpu), device="cpu".

The pins override the drawn knobs only; the rest of the spec is the
seed's draw (the port's spec equals the JAX package's with the two device
knobs' names mapped, tests/test_torch_sim_config.py). Runs are cached per
test process: one seed's host run serves both comparisons. A test file
imports `one_torch_thread` to run its cases on one torch thread.
"""

from __future__ import annotations

from functools import lru_cache

import pytest
import torch

from chip_smoke import (  # noqa: F401 - re-exported for the tests
    SIM_BACKUP_SEEDS,
    SIM_DURABLE_SEEDS,
    SIM_SEEDS,
)

HOST = {"server:CONFLICT_SET_IMPL": "oracle",
        "server:STORAGE_ENGINE_IMPL": "memory"}
DEVICE = {"server:CONFLICT_SET_IMPL": "gpu",
          "server:STORAGE_ENGINE_IMPL": "gpu"}
# Seeds that the JAX package itself fails on the CPU with the host
# backends pinned, and how (ROADMAP Queue 3, "To settle"): the exception
# it raises, or "check:<workload>" for a run that ends with that
# workload's check failed. The [sim] seeds are the first 24 in-memory
# seeds without these that draw no backup workload, the [sim-durable]
# seeds the first 16 such durable ones (a storage engine or regions) and
# seed 168; the [sim-backup] seeds draw a backup workload. Of the seeds
# that draw one, 16 and 28 fail as 163 does, 31 and 99 as 60 does, 169
# its Attrition check and 180 its boot's coordination read; 103
# fails as 60 does.
REFERENCE_SIDE_FAILURES = {
    0: "check:Serializability",
    5: "TypeError: a bytes-like object is required, not 'NoneType'",
    25: "RuntimeError: livelock: 10000001 steps without time advancing "
        "(t=0.9423813990189756)",
    60: "OSError: dq_push failed (record too large?)",
    70: "check:ConsistencyCheck",
    93: "OSError: dq_push failed (record too large?)",
    100: "OSError: dq_push failed (record too large?)",
    137: "check:LowLatency",
    149: "OperationFailed: coordination quorum unavailable for write",
    163: "TypeError: a bytes-like object is required, not 'NoneType'",
    16: "TypeError: a bytes-like object is required, not 'NoneType'",
    28: "TypeError: a bytes-like object is required, not 'NoneType'",
    31: "OSError: dq_push failed (record too large?)",
    99: "OSError: dq_push failed (record too large?)",
    103: "OSError: dq_push failed (record too large?)",
    169: "check:Attrition",
    180: "OperationFailed: coordination quorum unavailable for read",
}


def draws_backup(spec: dict) -> bool:
    """A seed that draws BackupRestore or BackupAttrition."""
    return any(w["name"] in ("BackupRestore", "BackupAttrition")
               for w in spec["workloads"])


def is_durable(spec: dict) -> bool:
    """A seed of the durable tier: a storage engine (on a datadir) or
    regions."""
    cluster = spec.get("cluster", {})
    return bool(cluster.get("engine") or cluster.get("regions"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The device backends' plain versions on one CPU thread: their ops
    are tiny, and torch's thread pool only contends with the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pinned(spec: dict, knobs: dict) -> dict:
    return dict(spec, knobs={**spec["knobs"], **knobs})


def _result(run, spec) -> dict:
    try:
        return run(spec)
    except Exception as e:  # noqa: BLE001 - the failure IS the result
        return {"raised": f"{type(e).__name__}: {e}"}


@lru_cache(maxsize=None)
def jax_run(seed: int) -> dict:
    from foundationdb_tpu.sim.config import generate_config
    from foundationdb_tpu.workloads.tester import run_spec

    return _result(run_spec, pinned(generate_config(seed), HOST))


@lru_cache(maxsize=None)
def port_run(seed: int, backends: str) -> dict:
    from foundationdb_tpu_torch.sim.config import generate_config
    from foundationdb_tpu_torch.workloads.tester import run_spec

    knobs = HOST if backends == "host" else DEVICE
    return _result(lambda s: run_spec(s, device="cpu"),
                   pinned(generate_config(seed), knobs))


def assert_jax_equals_port(seed: int) -> None:
    """The whole result dict: ok, every workload's check and metrics,
    the ConsistencyCheck, the fingerprint, the SevError count and events,
    and the coverage (trace event types, recovery states, metric names)."""
    want, got = jax_run(seed), port_run(seed, "host")
    assert "raised" not in want, want
    assert want["ok"] and not want["sev_errors"], want
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key in sorted(want):
        assert got[key] == want[key], (seed, key)


def assert_device_equals_host(seed: int) -> None:
    """The device backends against the host backends, one seed: ok, the
    SevError count, every workload's check result and metrics (commits,
    retries, moves, kills), the ConsistencyCheck and the fingerprint.
    Coverage is not compared: the device backends register metrics of
    their own."""
    from foundationdb_tpu_torch.sim.sweep import mismatches, outcome

    host, device = port_run(seed, "host"), port_run(seed, "device")
    assert "raised" not in device, device
    assert host["ok"] and not host["sev_errors"], host
    assert mismatches(outcome(device), outcome(host)) == [], seed
    assert device["fingerprint"] == host["fingerprint"]


def assert_fails_the_same_way(seed: int) -> None:
    """A reference-side failure: the JAX package's run fails as recorded,
    the port's run with the host backends pinned gives the same whole
    result (the same exception and message, or the same failed check
    with every other entry), and its device backends the same outcome."""
    from foundationdb_tpu_torch.sim.config import generate_config
    from foundationdb_tpu_torch.sim.sweep import mismatches, outcome
    from foundationdb_tpu_torch.workloads.tester import failure_summary

    how = REFERENCE_SIDE_FAILURES[seed]
    want, got = jax_run(seed), port_run(seed, "host")
    device = port_run(seed, "device")
    if how.startswith("check:"):
        assert "raised" not in want, want
        assert not want["ok"]
        assert failure_summary(generate_config(seed), want)["class"] == how
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        for key in sorted(want):
            assert got[key] == want[key], (seed, key)
        assert "raised" not in device, device
        assert mismatches(outcome(device), outcome(got)) == [], seed
    else:
        assert want == {"raised": how}
        assert got == want
        assert device == want
