"""Shared cases of the simulator differentials
(tests/test_torch_sim_differential*.py, tests/test_torch_sim_backends*.py).

A seed of sim/config.generate_config runs through each package's
run_spec on the CPU:

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

from chip_smoke import SIM_SEEDS  # noqa: F401 - re-exported for the tests

HOST = {"server:CONFLICT_SET_IMPL": "oracle",
        "server:STORAGE_ENGINE_IMPL": "memory"}
DEVICE = {"server:CONFLICT_SET_IMPL": "gpu",
          "server:STORAGE_ENGINE_IMPL": "gpu"}
# Seeds the port runs (no unported needs) that the JAX package itself
# fails on the CPU with the host backends pinned, and how (ROADMAP Queue
# 3, "To settle"). The [sim] seeds are the first 24 runnable seeds
# without these.
REFERENCE_SIDE_FAILURES = {
    5: "TypeError: a bytes-like object is required, not 'NoneType'",
    25: "RuntimeError: livelock: 10000001 steps without time advancing "
        "(t=0.9423813990189756)",
}


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
