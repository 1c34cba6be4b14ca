"""The port's device backends against its host backends under the
simulator, same seed, on the CPU: each [sim] seed (chip_smoke.SIM_SEEDS;
this file the first half, tests/test_torch_sim_backends_more.py the
second) with ConflictSetGPU and KeyValueStoreGPU pinned (device="cpu")
gives the host backends' (ConflictSetCPU, VersionedMap) ok, check
results, metrics and fingerprint. The seeds cover the sharded and the
recoverable tier, with and without a machine topology, under Attrition
and MachineAttrition. Seed 26 is left to the card's sweep (chip_smoke.py
[sim] replays it on the host backends in a worker)."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    SIM_SEEDS,
    assert_device_equals_host,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", [s for s in SIM_SEEDS[:12] if s != 26])
def test_device_backends_equal_the_host_backends(seed):
    assert_device_equals_host(seed)
