"""The second half of the [sim] seeds (chip_smoke.SIM_SEEDS): the port's
device backends (device="cpu") give its host backends' ok, check
results, metrics and fingerprint under the simulator (see
tests/test_torch_sim_backends.py)."""

import pytest

from _torch_sim_cases import (  # noqa: F401 - one_torch_thread: autouse
    SIM_SEEDS,
    assert_device_equals_host,
    one_torch_thread,
)


@pytest.mark.parametrize("seed", SIM_SEEDS[12:])
def test_device_backends_equal_the_host_backends(seed):
    assert_device_equals_host(seed)
